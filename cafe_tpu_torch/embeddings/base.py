"""Composite embedding layer (port of cafe_tpu/embeddings/base.py, the
single-device parts on the ported path).

Fields with the same treatment are grouped into a *part* backed by one
concatenated table, so each part is one gather and one scatter however
many fields it serves.

Contract per part (as in the JAX package):
  init(rng)                        -> state dict (tables + optimizer slots)
  init_dense(rng)                  -> differentiable params ({} here)
  gather(state, ids[B,Fp])         -> (raw, aux); raw is what the loss is
                                      differentiated against
  transform(dense_params, raw)     -> feats [B, Fp, D]
  apply_grads(state, ids, g_raw, aux, lr) -> (state, stats)

Tables are initialised with numpy exactly as the JAX package does (same
generator, same draws), so the two packages start from bit-equal tables.
`apply_grads` updates tables IN PLACE (the JAX package donates them).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sparse import SLOT_SUFFIXES, apply_rows, init_slots

# All tables are padded to a multiple of this row count (the JAX package
# shards them over power-of-two meshes; kept for a bit-equal layout).
ROW_ALIGN = 512


def round_up(n: int, align: int = ROW_ALIGN) -> int:
    return ((max(n, 1) + align - 1) // align) * align


def _uniform_init(rng: np.random.Generator, rows_per_field: Sequence[int],
                  scales: Sequence[float], dim: int) -> np.ndarray:
    """Concatenated (row-padded) table with per-field uniform slices."""
    total = int(sum(rows_per_field))
    out = np.zeros((round_up(total), dim), dtype=np.float32)
    lo = 0
    for rows, scale in zip(rows_per_field, scales):
        out[lo:lo + rows] = rng.uniform(-scale, scale,
                                        size=(rows, dim)).astype(np.float32)
        lo += rows
    return out


def _offsets(rows_per_field: Sequence[int]) -> np.ndarray:
    return np.concatenate([[0], np.cumsum(rows_per_field)[:-1]]).astype(
        np.int64)


class Part:
    field_idx: List[int]
    optimizer: str = "sgd"
    # sparse apply route (cfg.sparse_apply_impl; ops/sparse.apply_rows)
    apply_impl: str = "auto"
    device = torch.device("cpu")

    def init(self, rng: np.random.Generator) -> Dict:
        raise NotImplementedError

    def init_dense(self, rng: np.random.Generator) -> Dict:
        return {}

    def gather(self, state, ids):
        raise NotImplementedError

    def transform(self, dense_params, raw):
        return raw

    def apply_grads(self, state, ids, g_raw, aux, lr: float):
        raise NotImplementedError

    def _const(self, name: str) -> torch.Tensor:
        """Per-field int32 constant attribute `name` as a [1, F] tensor on
        the part's device, made once (a host-to-device copy per step
        would wait for the card)."""
        cache = self.__dict__.setdefault("_consts", {})
        if name not in cache:
            cache[name] = torch.as_tensor(
                np.asarray(getattr(self, name)), dtype=torch.int32,
                device=self.device)[None, :]
        return cache[name]

    # --- shared sparse-update helpers ---------------------------------
    def _slots_of(self, state: Dict, key: str) -> Dict:
        return {name: state[key + sfx]
                for name, sfx in SLOT_SUFFIXES[self.optimizer].items()}

    def _put_slots(self, state: Dict, key: str, slots: Dict) -> Dict:
        for name, sfx in SLOT_SUFFIXES[self.optimizer].items():
            state[key + sfx] = slots[name]
        return state

    def _table_update(self, state: Dict, key: str, idx: torch.Tensor,
                      grad: torch.Tensor, lr: float) -> Dict:
        table, slots = apply_rows(state[key], self._slots_of(state, key),
                                  idx, grad, lr, self.optimizer,
                                  self.apply_impl)
        return self._put_slots({**state, key: table}, key, slots)

    def _maybe_acc(self, state: Dict, key: str) -> Dict:
        return self._put_slots(state, key,
                               init_slots(state[key], self.optimizer))


class HashedTablePart(Part):
    """Full and hash-compressed fields: row = offset_f + (id % real_n_f).
    Weighted pooling is not ported yet."""

    def __init__(self, field_idx, counts, real_ns, dim, optimizer="sgd"):
        self.field_idx = list(field_idx)
        self.counts = [int(c) for c in counts]
        self.real_ns = [int(r) for r in real_ns]
        self.dim = dim
        self.optimizer = optimizer
        self.np_offsets = _offsets(self.real_ns)
        self.rows = int(sum(self.real_ns))

    def init(self, rng):
        scales = [np.sqrt(1.0 / max(n, 5)) for n in self.counts]
        state = {"table": torch.from_numpy(
            _uniform_init(rng, self.real_ns, scales, self.dim)).to(
                self.device)}
        return self._maybe_acc(state, "table")

    def gather(self, state, ids):
        flat = (ids % self._const("real_ns")) + self._const("np_offsets")
        return state["table"][flat.long()], flat

    def apply_grads(self, state, ids, g_raw, aux, lr):
        b, f, d = g_raw.shape
        state = self._table_update(state, "table", aux.reshape(b * f),
                                   g_raw.reshape(b * f, d), lr)
        return state, {}


class EmbeddingLayer:
    """Field-partitioned composite of parts on one device (default the
    card; raises without CUDA unless device='cpu')."""

    def __init__(self, parts: List[Part], num_fields: int, dim: int,
                 device="cuda"):
        assert sorted(sum((p.field_idx for p in parts), [])) == \
            list(range(num_fields))
        self.parts = parts
        self.num_fields = num_fields
        self.dim = dim
        self.device = resolve_device(device)
        for p in parts:
            p.device = self.device
        order = np.concatenate([p.field_idx for p in parts]).astype(np.int64)
        self._perm = torch.as_tensor(np.argsort(order), device=self.device)
        self._cols = [torch.as_tensor(p.field_idx, device=self.device)
                      for p in parts]

    def init(self, seed: int) -> Tuple[Dict, Dict]:
        rng = np.random.default_rng(seed)
        state = {f"part{i}": p.init(rng) for i, p in enumerate(self.parts)}
        dense = {f"part{i}": p.init_dense(rng)
                 for i, p in enumerate(self.parts)}
        return state, dense

    def gather(self, state: Dict, ids: torch.Tensor):
        raws, auxs = {}, {}
        for i, p in enumerate(self.parts):
            raws[f"part{i}"], auxs[f"part{i}"] = p.gather(
                state[f"part{i}"], ids[:, self._cols[i]])
        return raws, auxs

    def transform(self, dense: Dict, raws: Dict) -> torch.Tensor:
        feats = [p.transform(dense[f"part{i}"], raws[f"part{i}"])
                 for i, p in enumerate(self.parts)]
        return torch.cat(feats, dim=1)[:, self._perm]

    def apply_grads(self, state: Dict, ids: torch.Tensor, g_raws: Dict,
                    auxs: Dict, lr: float):
        """Per-part updates; stats from several parts combine (counts sum,
        fractions average), as in the JAX package."""
        collected: Dict[str, list] = {}
        new_state = {}
        for i, p in enumerate(self.parts):
            s, st = p.apply_grads(state[f"part{i}"], ids[:, self._cols[i]],
                                  g_raws[f"part{i}"], auxs[f"part{i}"], lr)
            new_state[f"part{i}"] = s
            for k, v in st.items():
                collected.setdefault(k, []).append(v)
        stats = {}
        for k, vs in collected.items():
            if len(vs) == 1:
                stats[k] = vs[0]
            elif k.endswith("_frac"):
                stats[k] = sum(vs) / len(vs)
            else:
                stats[k] = sum(vs)
        return new_state, stats
