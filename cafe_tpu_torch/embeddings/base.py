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

Under a mesh (EmbeddingLayer.set_mesh) a part that opts in (enable_mesh)
holds this rank's row shard and runs the explicit exchange
(parallel/exchange.py) on this rank's batch slice; a part that does not
stays replicated and applies the global batch's update on every rank,
as XLA's partitioner does for the JAX package.
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from ..device import resolve_device
from ..ops.sparse import SLOT_SUFFIXES, apply_rows, init_slots
from ..parallel.exchange import (all_gather, sharded_apply,
                                 sharded_apply_a2a, sharded_fetch,
                                 sharded_fetch_a2a)
from ..utils.timing import tensors_of

# All tables are padded to a multiple of this row count (the JAX package
# shards them over power-of-two meshes; kept for a bit-equal layout).
ROW_ALIGN = 512

# tables smaller than this stay replicated even under the explicit
# exchange — the collective round-trip costs more than it saves
_MIN_SHARD_ROWS = 1024

# --shard_exchange -> the all-to-all impl of the a2a legs
EXCHANGE_IMPLS = {"a2a": "lax", "pallas": "pallas"}


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
    # set by EmbeddingLayer.set_mesh on a part that opted in: gather and
    # apply_grads then run the explicit exchange on this rank's shard
    mesh = None
    unique_frac = 0.0
    # exchange for the row legs (--shard_exchange): 'explicit'
    # (all-gather + owner-compute + reduce-scatter), 'a2a' (request-routed
    # dist.all_to_all_single) or 'pallas' (the same through kernel K5)
    exchange_mode = "explicit"

    def enable_mesh(self, mesh) -> bool:
        """Opt this part into the explicit exchange. Default: stay
        replicated. Must be called before init()."""
        return False

    def _sharded_fetch(self, table, idx2d):
        """The configured row-fetch exchange (see exchange_mode)."""
        if self.exchange_mode != "explicit":
            return sharded_fetch_a2a(self.mesh, table, idx2d,
                                     impl=EXCHANGE_IMPLS[self.exchange_mode])
        return sharded_fetch(self.mesh, table, idx2d, self.unique_frac)

    def _sharded_apply(self, table, slots, idx2d, g3d, lr):
        """The configured row-update exchange (see exchange_mode)."""
        if self.exchange_mode != "explicit":
            return sharded_apply_a2a(
                self.mesh, table, slots, idx2d, g3d, lr, self.optimizer,
                impl=EXCHANGE_IMPLS[self.exchange_mode],
                apply_impl=self.apply_impl)
        return sharded_apply(self.mesh, table, slots, idx2d, g3d, lr,
                             self.optimizer, self.unique_frac,
                             apply_impl=self.apply_impl)

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

    def enable_mesh(self, mesh) -> bool:
        n = mesh.size
        rows_pad = round_up(self.rows)
        if rows_pad % n or rows_pad < max(n, _MIN_SHARD_ROWS):
            return False
        self.mesh = mesh
        return True

    def init(self, rng):
        scales = [np.sqrt(1.0 / max(n, 5)) for n in self.counts]
        state = {"table": torch.from_numpy(
            _uniform_init(rng, self.real_ns, scales, self.dim)).to(
                self.device)}
        return self._maybe_acc(state, "table")

    def gather(self, state, ids):
        flat = (ids % self._const("real_ns")) + self._const("np_offsets")
        if self.mesh is not None:
            return self._sharded_fetch(state["table"], flat), flat
        return state["table"][flat.long()], flat

    def apply_grads(self, state, ids, g_raw, aux, lr):
        if self.mesh is not None:
            table, slots = self._sharded_apply(
                state["table"], self._slots_of(state, "table"), aux, g_raw,
                lr)
            return self._put_slots({**state, "table": table}, "table",
                                   slots), {}
        b, f, d = g_raw.shape
        state = self._table_update(state, "table", aux.reshape(b * f),
                                   g_raw.reshape(b * f, d), lr)
        return state, {}


def _gather_tree(node, mesh):
    """Every tensor of `node` (a tensor or a tuple of them, batch-major)
    all-gathered along dim 0."""
    if isinstance(node, (tuple, list)):
        return type(node)(_gather_tree(x, mesh) for x in node)
    return all_gather(node, mesh)


class EmbeddingLayer:
    """Field-partitioned composite of parts on one device (default the
    card; raises without CUDA unless device='cpu').

    `mesh` (set by set_mesh, or directly for data parallelism alone) makes
    the layer work on this rank's batch slice: parts that run the
    exchange hold row shards; every other part is replicated and applies
    the all-gathered global batch on every rank."""

    mesh = None

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

    def set_mesh(self, mesh, unique_frac: float = 0.0,
                 exchange_mode: str = "explicit") -> List[str]:
        """Turn on the explicit exchange on every part that supports it
        (big hashed tables, CAFE parts with shard-local sketches). Must
        run BEFORE init(); returns the names of the parts that turned it
        on (the rest stay replicated)."""
        if exchange_mode not in ("explicit",) + tuple(EXCHANGE_IMPLS):
            raise NotImplementedError(
                f"shard_exchange {exchange_mode!r} is not ported yet "
                f"(ROADMAP queue Q8); use explicit, a2a or pallas")
        if unique_frac > 0.0:
            raise NotImplementedError(
                "shard_unique_frac > 0: the unique-compact exchange is not "
                "ported yet (ROADMAP queue Q8)")
        self.mesh = mesh
        active = []
        for i, p in enumerate(self.parts):
            if p.enable_mesh(mesh):
                p.unique_frac = float(unique_frac)
                p.exchange_mode = exchange_mode
                active.append(f"part{i}:{type(p).__name__}")
        return active

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
            args = (ids[:, self._cols[i]], g_raws[f"part{i}"],
                    auxs[f"part{i}"])
            replicated = self.mesh is not None and p.mesh is None
            if replicated:
                args = _gather_tree(args, self.mesh)
            s, st = p.apply_grads(state[f"part{i}"], *args, lr)
            if replicated and self.mesh.size > 1:
                # the card sums duplicate rows with atomics in no fixed
                # order, so replicas could drift apart by f32 rounding:
                # every rank takes rank 0's (small) replicated state
                for t in tensors_of(s):
                    dist.broadcast(t, src=0, group=self.mesh.group)
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
