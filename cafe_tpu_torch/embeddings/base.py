"""Composite embedding layer (port of cafe_tpu/embeddings/base.py):
hashed / full tables (weighted pooling too), quotient-remainder (QR),
mixed-dimension (MDE) and offline hot/cold (Off) parts, and the layer.

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
  quantize_for_serving(state, bits) -> {key: QuantizedTable}, made once
                                      (CAFE v1 on one device adds its
                                      frozen sketch view, `sk_packed`)
  gather_quantized(state, qt, ids) -> raw as gather returns it, the rows
                                      dequantized from the codes (routing
                                      state stays full precision)

Tables are initialised with numpy exactly as the JAX package does (same
generator, same draws), so the two packages start from bit-equal tables.
`apply_grads` updates tables IN PLACE (the JAX package donates them);
a step built with donate_state False hands it a clone of the caller's
state (train/step.py), so only the clone changes.

Under a mesh (EmbeddingLayer.set_mesh) a part that opts in (enable_mesh)
holds this rank's row shard and runs the explicit exchange
(parallel/exchange.py) on this rank's batch slice; a part that does not
stays replicated and applies the global batch's update on every rank,
as XLA's partitioner does for the JAX package.

Under --shard_exchange auto every part keeps its single-device semantics
on the global batch, as the JAX package's partitioned step does: its big
row tables (`auto_keys`) are row-sharded, the lookup of this rank's ids
goes through the explicit fetch, the update runs the single-device
apply_grads on every rank over the all-gathered batch, and each table
write lands in its owner's shard only. Every other leaf (sketches, hot
dicts, AdaEmbed's dic and importance, small tables) is whole on every
rank and updated identically there; where a float sum in atomics could
round apart by rank, rank 0's values are broadcast (`Part._agree`).
"""

from __future__ import annotations

from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.quantized import dequantize_rows, quantize_rowwise
from ..ops.sparse import SLOT_SUFFIXES, apply_rows, init_slots
from ..parallel.exchange import (_local_idx, _owner_rows, all_gather,
                                 broadcast, owner_lookup_1d,
                                 owner_rows_with, psum, psum_scatter,
                                 sharded_apply, sharded_apply_a2a,
                                 sharded_fetch, sharded_fetch_a2a)
from ..parallel.sharding import auto_leaf_is_sharded, rows_of
from ..utils.timing import tensors_of

# All tables are padded to a multiple of this row count (the JAX package
# shards them over power-of-two meshes; kept for a bit-equal layout).
ROW_ALIGN = 512

# tables smaller than this stay replicated even under the explicit
# exchange — the collective round-trip costs more than it saves
_MIN_SHARD_ROWS = 1024

# --shard_exchange -> the all-to-all impl of the a2a legs
EXCHANGE_IMPLS = {"a2a": "lax", "pallas": "pallas"}
# every --shard_exchange mode (EmbeddingLayer.set_mesh)
SHARD_EXCHANGES = ("explicit", "auto") + tuple(EXCHANGE_IMPLS)


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
    # sum duplicate rows in a fixed order in every apply arm
    # (ops/sparse.apply_rows' deterministic; the graph recommenders)
    deterministic_sums = False
    device = torch.device("cpu")
    # set by EmbeddingLayer.set_mesh on a part that opted in: gather and
    # apply_grads then run the explicit exchange on this rank's shard
    mesh = None
    unique_frac = 0.0
    # exchange for the row legs (--shard_exchange): 'explicit'
    # (all-gather + owner-compute + reduce-scatter), 'a2a' (request-routed
    # dist.all_to_all_single) or 'pallas' (the same through kernel K5)
    exchange_mode = "explicit"
    # whether the part's routing and insert move ids over the mesh
    # (CAFE), which take hierarchical compact legs on a two-level mesh
    id_legs = False
    # whether the part's step takes a device branch (utils/cond.cond),
    # which a CUDA graph holds as a conditional node
    # (train/step.capture_blockers)
    conds = False
    # steps (counted from 1) that must run eagerly, or None
    # (embeddings/ada.py; train/capture.StepMirror)
    host_step = None
    # --shard_exchange auto (module docstring): the mesh its big tables
    # are row-sharded over, and their keys (set by EmbeddingLayer.init
    # from the global shapes); a part that cannot take it stays whole
    auto_mesh = None
    auto_keys = frozenset()
    auto_shardable = True

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

    # --- quantized serving (ops/quantized.py) -------------------------
    def quantize_for_serving(self, state: Dict, bits: int) -> Dict:
        """This part's float row tables quantized once for serving: a dict
        of QuantizedTables keyed like the state entries."""
        raise NotImplementedError

    def gather_quantized(self, state: Dict, qt: Dict, ids: torch.Tensor):
        """The forward lookup against the quantized tables; routing state
        (sketches, hot dicts, Ada's dic) stays full precision. Returns
        `raw` in gather's shape (transform applies after)."""
        raise NotImplementedError

    def _quantize(self, table: torch.Tensor, bits: int):
        if bits == 4 and table.shape[1] % 2:
            bits = 8   # int4 packs code pairs: an odd width serves at 8
        return quantize_rowwise(table, bits)

    def _dequantize(self, qt, rows: torch.Tensor, replicated: bool = False,
                    key: str = "table") -> torch.Tensor:
        """Dequantized rows [b, F, D] at row ids [b, F] of table `key`: on
        a mesh this rank's lanes through the explicit exchange (all-gather
        the row ids, each owner dequantizes the rows of its shard of the
        codes, a reduce-scatter returns the f32 rows), so only O(batch)
        bytes move and the codes never leave their owner. `replicated`:
        the codes are whole on every rank (QR's remainder table)."""
        b, f = rows.shape
        mesh = None if replicated else self.mesh
        if mesh is None and key in self.auto_keys:
            mesh = self.auto_mesh
        if mesh is None:
            return dequantize_rows(qt, rows.reshape(-1)).reshape(b, f, -1)
        return self._dequantize_owned(
            qt, all_gather(rows.reshape(-1), mesh), mesh).reshape(b, f, -1)

    def _dequantize_owned(self, qt, all_rows: torch.Tensor,
                          mesh=None) -> torch.Tensor:
        """This rank's [m, D] lanes of the mesh's row ids `all_rows`
        [n*m]: the owners dequantize, a reduce-scatter returns them."""
        mesh = mesh or self.mesh
        vals = owner_rows_with(lambda i: dequantize_rows(qt, i),
                               qt.codes.shape[0], all_rows, mesh)
        return psum_scatter(vals, mesh)

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
        """The sparse apply of table `key` at rows idx by grad. Under auto
        the (global) rows of a sharded table land in their owner's shard
        only; a whole table is updated on every rank and agreed."""
        sharded = key in self.auto_keys
        if sharded:
            idx = _local_idx(state[key].shape[0], idx, self.auto_mesh)
        table, slots = apply_rows(state[key], self._slots_of(state, key),
                                  idx, grad, lr, self.optimizer,
                                  self.apply_impl,
                                  deterministic=self.deterministic_sums)
        if not sharded:
            self._agree(table, *slots.values())
        return self._put_slots({**state, key: table}, key, slots)

    # --- --shard_exchange auto ----------------------------------------
    def _agree(self, *tensors) -> None:
        """Under auto on several ranks, every rank takes rank 0's values
        of these whole-on-every-rank tensors (in place): a float sum in
        atomics may round apart by rank, and replicated state must not."""
        mesh = self.auto_mesh
        if mesh is not None and mesh.size > 1:
            for t in tensors:
                broadcast(t, mesh)

    def _lookup(self, state: Dict, key: str, idx: torch.Tensor
                ) -> torch.Tensor:
        """Rows of table `key` at this rank's row ids idx [b, F]: a plain
        gather, or under auto for a sharded table the explicit fetch."""
        if key in self.auto_keys:
            return sharded_fetch(self.auto_mesh, state[key], idx)
        return state[key][idx.long()]

    def _read_rows(self, state: Dict, key: str, idx: torch.Tensor
                   ) -> torch.Tensor:
        """Rows of table `key` at row ids idx that are the same on every
        rank (any shape): under auto for a sharded table the owners answer
        and a sum publishes them (one owner a row, so exactly)."""
        if key not in self.auto_keys:
            return state[key][idx.long()]
        mesh = self.auto_mesh
        rows = _owner_rows(state[key], idx.reshape(-1), mesh)
        return psum(rows, mesh).reshape(*idx.shape, -1)

    def _write_owned(self, table: torch.Tensor, idx: torch.Tensor,
                     vals: torch.Tensor, mask: torch.Tensor) -> None:
        """Under auto, table[idx[i]] = vals[i] where mask[i] for a sharded
        `table`, in place, each owner writing its rows; the masked rows
        must be distinct and the same on every rank. Two accumulating
        puts, -table then +vals (x - x and 0 + v are exact), where lanes
        owned elsewhere add zeros, so the mask is never read back."""
        loc = _local_idx(table.shape[0], idx, self.auto_mesh).long()
        keep = (mask & (loc < table.shape[0]))[:, None]
        loc = loc.clamp_max(table.shape[0] - 1)
        table.index_put_((loc,), torch.where(keep, -table[loc], 0.0),
                         accumulate=True)
        table.index_put_((loc,), torch.where(keep, vals, 0.0),
                         accumulate=True)

    def _owned_rows(self, key: str, mask: torch.Tensor) -> torch.Tensor:
        """A per-row mask of table `key` cut to this rank's shard under
        auto (whole otherwise)."""
        if key in self.auto_keys:
            return mask[rows_of(self.auto_mesh, mask.shape[0])]
        return mask

    def _update_rows(self, state: Dict, key: str, idx: torch.Tensor,
                     grad: torch.Tensor, lr: float) -> Dict:
        """The update of table `key` at rows idx [b, F] by grad [b, F, d]:
        the plain sparse apply on one device, the configured row exchange
        under a mesh."""
        if self.mesh is None:
            return self._table_update(state, key, idx.reshape(-1),
                                      grad.reshape(idx.numel(), -1), lr)
        table, slots = self._sharded_apply(state[key],
                                           self._slots_of(state, key), idx,
                                           grad, lr)
        return self._put_slots({**state, key: table}, key, slots)

    def _replicated_update(self, state: Dict, key: str, idx: torch.Tensor,
                           grad: torch.Tensor, lr: float) -> Dict:
        """_table_update of a table that stays whole on every rank of a
        sharded part (QR's `r`, weighted pooling's `w`): the global
        batch's (row, grad) pairs are all-gathered and applied on every
        rank, which then takes rank 0's table and slots (the layer's rule
        for a replicated part, EmbeddingLayer.apply_grads)."""
        if self.mesh is None:
            return self._table_update(state, key, idx, grad, lr)
        state = self._table_update(state, key, all_gather(idx, self.mesh),
                                   all_gather(grad.contiguous(), self.mesh),
                                   lr)
        if self.mesh.size > 1:
            for k in [key] + [key + sfx for sfx in
                              SLOT_SUFFIXES[self.optimizer].values()]:
                broadcast(state[k], self.mesh)
        return state

    def _maybe_acc(self, state: Dict, key: str) -> Dict:
        return self._put_slots(state, key,
                               init_slots(state[key], self.optimizer))


class HashedTablePart(Part):
    """Full and hash-compressed fields: row = offset_f + (id % real_n_f).

    `weighted` is the legacy v_W_l weighted pooling: a per-RAW-ID scalar
    weight `w` (gathered by the raw id before hashing, init 1) multiplies
    the looked-up row; "learned" trains it with the part's sparse
    optimizer, "fixed" keeps it at 1. Under a mesh the table is
    row-sharded as for any hashed part and `w` stays whole on every rank
    (the JAX package's layout; see Part._replicated_update)."""

    def __init__(self, field_idx, counts, real_ns, dim, optimizer="sgd",
                 weighted: str = ""):
        self.field_idx = list(field_idx)
        self.counts = [int(c) for c in counts]
        self.real_ns = [int(r) for r in real_ns]
        self.dim = dim
        self.optimizer = optimizer
        assert weighted in ("", "fixed", "learned"), weighted
        self.weighted = weighted
        self.np_offsets = _offsets(self.real_ns)
        self.rows = int(sum(self.real_ns))
        # the raw-id keyed weight table spans the full vocabulary
        self.w_offsets = _offsets(self.counts)
        self.w_rows = int(sum(self.counts))

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
        if self.weighted:
            state["w"] = torch.ones((round_up(self.w_rows), 1),
                                    dtype=torch.float32, device=self.device)
            if self.weighted == "learned":
                state = self._maybe_acc(state, "w")
        return self._maybe_acc(state, "table")

    def _w_index(self, ids):
        return ids + self._const("w_offsets")

    def gather(self, state, ids):
        flat = (ids % self._const("real_ns")) + self._const("np_offsets")
        rows = self._lookup(state, "table", flat) if self.mesh is None \
            else self._sharded_fetch(state["table"], flat)
        if not self.weighted:
            return rows, flat
        out = rows * state["w"][self._w_index(ids).long()]
        # "learned" needs the rows before weighting in apply_grads
        return out, ((flat, rows) if self.weighted == "learned" else flat)

    def apply_grads(self, state, ids, g_raw, aux, lr):
        if self.weighted:
            return self._apply_weighted(state, ids, g_raw, aux, lr), {}
        return self._update_rows(state, "table", aux, g_raw, lr), {}

    def _apply_weighted(self, state, ids, g_raw, aux, lr):
        """raw = table[hash(i)] * w[i]: the chain rule through both
        factors, both from the weights before this step's update."""
        b, f, d = g_raw.shape
        flat = aux[0] if self.weighted == "learned" else aux
        widx = self._w_index(ids).reshape(b * f)
        g = g_raw.reshape(b * f, d)
        g_table = g * state["w"][widx.long()]
        if self.weighted == "learned":
            g_w = (g * aux[1].reshape(b * f, d)).sum(-1, keepdim=True)
            state = self._replicated_update(state, "w", widx, g_w, lr)
        return self._update_rows(state, "table", flat,
                                 g_table.reshape(b, f, d), lr)

    def quantize_for_serving(self, state, bits):
        return {"table": self._quantize(state["table"], bits)}

    def gather_quantized(self, state, qt, ids):
        flat = (ids % self._const("real_ns")) + self._const("np_offsets")
        rows = self._dequantize(qt["table"], flat)
        if self.weighted:
            rows = rows * state["w"][self._w_index(ids).long()]
        return rows


class QRPart(Part):
    """Quotient-remainder fields: the feature vector combines
    q[id // coll] and r[id % coll] by `operation`: "add", "mult"
    (elementwise product) or "concat" (the two tables hold the halves of
    the dim, q_dim = (dim + 1) // 2, so the output dim stays `dim`).

    Under a mesh only the quotient table is row-sharded (the exchange);
    the O(collisions) remainder table stays whole on every rank: each
    rank gathers its lanes' r rows locally, and the update all-gathers
    the global batch's (row, grad) pairs, applies them on every rank and
    takes rank 0's result, as the layer does for a replicated part."""

    def __init__(self, field_idx, counts, collisions, dim, optimizer="sgd",
                 operation: str = "add"):
        self.field_idx = list(field_idx)
        self.counts = [int(c) for c in counts]
        self.collisions = int(collisions)
        self.dim = dim
        self.optimizer = optimizer
        assert operation in ("add", "mult", "concat"), operation
        self.operation = operation
        self.q_dim = (dim + 1) // 2 if operation == "concat" else dim
        self.r_dim = dim - self.q_dim if operation == "concat" else dim
        self.q_rows = [int(np.ceil(n / collisions)) + 1 for n in self.counts]
        self.r_rows = [self.collisions] * len(self.counts)
        self.q_off = _offsets(self.q_rows)
        self.r_off = _offsets(self.r_rows)

    def enable_mesh(self, mesh) -> bool:
        n = mesh.size
        q_pad = round_up(int(sum(self.q_rows)))
        if q_pad % n or q_pad < max(n, _MIN_SHARD_ROWS):
            return False
        self.mesh = mesh
        return True

    def init(self, rng):
        scales = [np.sqrt(1.0 / n) for n in self.counts]
        state = {"q": _uniform_init(rng, self.q_rows, scales, self.q_dim),
                 "r": _uniform_init(rng, self.r_rows, scales, self.r_dim)}
        state = {k: torch.from_numpy(v).to(self.device)
                 for k, v in state.items()}
        state = self._maybe_acc(state, "q")
        return self._maybe_acc(state, "r")

    def gather(self, state, ids):
        qi = ids // self.collisions + self._const("q_off")
        ri = ids % self.collisions + self._const("r_off")
        qv = self._lookup(state, "q", qi) if self.mesh is None \
            else self._sharded_fetch(state["q"], qi)
        rv = state["r"][ri.long()]
        if self.operation == "add":
            raw = qv + rv
        elif self.operation == "mult":
            raw = qv * rv
        else:
            raw = torch.cat([qv, rv], dim=-1)
        # mult's backward needs both factors: carried, not re-gathered
        return raw, ((qi, ri, qv, rv) if self.operation == "mult"
                     else (qi, ri))

    def apply_grads(self, state, ids, g_raw, aux, lr):
        b, f, _ = g_raw.shape
        qi, ri = aux[:2]
        if self.operation == "add":
            gq = gr = g_raw
        elif self.operation == "mult":
            gq, gr = g_raw * aux[3], g_raw * aux[2]
        else:
            gq, gr = g_raw[..., :self.q_dim], g_raw[..., self.q_dim:]
        state = self._update_rows(state, "q", qi, gq, lr)
        return self._replicated_update(state, "r", ri.reshape(-1),
                                       gr.reshape(b * f, -1), lr), {}

    def quantize_for_serving(self, state, bits):
        return {"q": self._quantize(state["q"], bits),
                "r": self._quantize(state["r"], bits)}

    def gather_quantized(self, state, qt, ids):
        qv = self._dequantize(qt["q"], ids // self.collisions
                              + self._const("q_off"), key="q")
        rv = self._dequantize(qt["r"], ids % self.collisions
                              + self._const("r_off"), replicated=True)
        if self.operation == "add":
            return qv + rv
        if self.operation == "mult":
            return qv * rv
        return torch.cat([qv, rv], dim=-1)


class MDEGroupPart(Part):
    """Mixed-dimension fields sharing one reduced dim: a low-dim table
    gather and a per-field projection back to the base dim. The
    projections are dense params (init_dense) that train through autograd
    like the tower weights."""

    def __init__(self, field_idx, counts, low_dim, base_dim, optimizer="sgd"):
        self.field_idx = list(field_idx)
        self.counts = [int(c) for c in counts]
        self.low_dim = int(low_dim)
        self.dim = base_dim
        self.optimizer = optimizer
        self.np_offsets = _offsets(self.counts)

    def init(self, rng):
        scales = [np.sqrt(6.0 / (n + self.low_dim)) for n in self.counts]
        state = {"table": torch.from_numpy(_uniform_init(
            rng, self.counts, scales, self.low_dim)).to(self.device)}
        return self._maybe_acc(state, "table")

    def init_dense(self, rng):
        if self.low_dim == self.dim:
            return {}
        bound = np.sqrt(6.0 / (self.low_dim + self.dim))
        proj = rng.uniform(-bound, bound, size=(
            len(self.field_idx), self.low_dim, self.dim)).astype(np.float32)
        return {"proj": torch.from_numpy(proj).to(self.device)}

    def gather(self, state, ids):
        flat = ids + self._const("np_offsets")
        return self._lookup(state, "table", flat), flat

    def transform(self, dense_params, raw):
        if self.low_dim == self.dim:
            return raw
        return torch.einsum("bfd,fde->bfe", raw, dense_params["proj"])

    def apply_grads(self, state, ids, g_raw, aux, lr):
        b, f, d = g_raw.shape
        state = self._table_update(state, "table", aux.reshape(b * f),
                                   g_raw.reshape(b * f, d), lr)
        return state, {}

    def quantize_for_serving(self, state, bits):
        return {"table": self._quantize(state["table"], bits)}

    def gather_quantized(self, state, qt, ids):
        # the low-dim rows; the projection applies in transform, in f32
        return self._dequantize(qt["table"], ids + self._const("np_offsets"))


class OffPart(Part):
    """Offline hot/cold fields: a precomputed frequency-ranked hot
    dictionary (data/datasets.generate_hot_features) routes each id to a
    dedicated hot row or to its field's hashed cold rows. A field left no
    cold budget (num_cold <= 0) serves its non-hot ids from the hot rows
    by modulo.

    Layout: one table, hot rows first and cold rows from `cold_base`, so
    the forward is one routed gather and the backward one scatter.

    Under a mesh the unified table and the int32 hot_dict are both
    row-sharded (the O(vocab) dict is never replicated): the ranks
    all-gather their ids, the dict's owners answer its lanes, every rank
    routes the global batch and the table's owners answer the rows, a
    reduce-scatter returning each rank its lanes (the JAX package's
    owner-compute forward, whatever the exchange mode); the update runs
    the configured row exchange."""

    def __init__(self, field_idx, counts, hot_dicts, num_colds, dim,
                 optimizer="sgd"):
        self.field_idx = list(field_idx)
        self.counts = [int(c) for c in counts]
        self.dim = dim
        self.optimizer = optimizer
        self.num_hots = [int((hd >= 0).sum()) for hd in hot_dicts]
        self.num_colds = [max(int(c), 0) for c in num_colds]
        self.hot_fallback = [int(c <= 0) for c in self.num_colds]
        self.hot_n = [max(h, 1) for h in self.num_hots]
        self.cold_n = [max(c, 1) for c in self.num_colds]
        self.hot_off = _offsets(self.hot_n)
        self.cold_off = _offsets(self.cold_n)
        self.dict_off = _offsets(self.counts)
        self._hot_dict_np = np.concatenate(hot_dicts).astype(np.int32)
        self.hot_rows = int(sum(self.hot_n))
        self.cold_rows = int(sum(self.cold_n))
        self.cold_base = round_up(self.hot_rows)
        self.total_rows = self.cold_base + round_up(self.cold_rows)

    def enable_mesh(self, mesh) -> bool:
        n = mesh.size
        if self.total_rows % n or self.total_rows < max(n, _MIN_SHARD_ROWS):
            return False
        if round_up(len(self._hot_dict_np)) % n:
            return False
        self.mesh = mesh
        return True

    def init(self, rng):
        scales = [np.sqrt(1.0 / max(n, 5)) for n in self.counts]
        hd = self._hot_dict_np
        hd_pad = np.full(round_up(len(hd)), -1, dtype=np.int32)
        hd_pad[: len(hd)] = hd
        table = np.zeros((self.total_rows, self.dim), dtype=np.float32)
        hot = _uniform_init(rng, self.hot_n, scales, self.dim)
        cold = _uniform_init(rng, self.cold_n, scales, self.dim)
        table[: hot.shape[0]] = hot
        table[self.cold_base: self.cold_base + cold.shape[0]] = cold
        state = {"table": torch.from_numpy(table).to(self.device),
                 "hot_dict": torch.from_numpy(hd_pad).to(self.device)}
        return self._maybe_acc(state, "table")

    def _route(self, ids, hd):
        """(ids, dict values) -> (unified row, use_hot), both [B, F]."""
        is_hot = hd >= 0
        # non-hot ids of a fallback field route into the hot rows
        use_hot = is_hot | (self._const("hot_fallback") != 0)
        hrow = torch.where(is_hot, hd.clamp_min(0),
                           ids % self._const("hot_n")) + self._const("hot_off")
        crow = (ids % self._const("cold_n") + self._const("cold_off")
                + self.cold_base)
        return torch.where(use_hot, hrow, crow), use_hot

    def gather(self, state, ids):
        if self.mesh is not None:
            row_all, hot_all = self._route_sharded(state, ids)
            raw = psum_scatter(_owner_rows(state["table"], row_all,
                                           self.mesh), self.mesh)
            me = rows_of(self.mesh, row_all.shape[0])
            return raw.reshape(*ids.shape, -1), (
                row_all[me].reshape(ids.shape),
                hot_all[me].reshape(ids.shape))
        gid = ids + self._const("dict_off")
        row, use_hot = self._route(ids, state["hot_dict"][gid.long()])
        return self._lookup(state, "table", row), (row, use_hot)

    def _route_sharded(self, state, ids):
        """The global batch's (row, use_hot), flat [n*b*F], from this
        rank's ids [b, F]: the dict's owners answer its lanes (one owner a
        lane, so an int32 psum publishes them exactly)."""
        f = ids.shape[1]
        all_ids = all_gather(ids.reshape(-1), self.mesh).reshape(-1, f)
        hd = owner_lookup_1d(state["hot_dict"],
                             (all_ids + self._const("dict_off")).reshape(-1),
                             self.mesh)
        row, use_hot = self._route(all_ids, hd.reshape(-1, f))
        return row.reshape(-1), use_hot.reshape(-1)

    def apply_grads(self, state, ids, g_raw, aux, lr):
        return self._update_rows(state, "table", aux[0], g_raw, lr), {}

    def quantize_for_serving(self, state, bits):
        return {"table": self._quantize(state["table"], bits)}

    def gather_quantized(self, state, qt, ids):
        if self.mesh is not None:
            # the owners answer the dict lanes and dequantize their rows:
            # O(batch) traffic, the dict and the codes never move
            row_all, _ = self._route_sharded(state, ids)
            return self._dequantize_owned(qt["table"], row_all).reshape(
                *ids.shape, -1)
        gid = ids + self._const("dict_off")
        row, _ = self._route(ids, state["hot_dict"][gid.long()])
        return self._dequantize(qt["table"], row)


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

    def memory_rows(self) -> int:
        """Total embedding-table rows across all parts (the JAX package's
        compress-rate audit; MDE / AE rows have reduced dims)."""
        rows = 0
        for p in self.parts:
            if isinstance(p, HashedTablePart):
                rows += p.rows
            elif isinstance(p, QRPart):
                rows += sum(p.q_rows) + sum(p.r_rows)
            elif isinstance(p, OffPart):
                rows += p.hot_rows + p.cold_rows
            elif hasattr(p, "total_rows"):      # CafePart unified table
                rows += p.total_rows
            elif hasattr(p, "hotn"):            # AdaPart global pool
                rows += p.hotn + 1
            elif hasattr(p, "counts"):          # MDE / AE reduced-dim tables
                rows += sum(p.counts)
        return rows

    def set_mesh(self, mesh, unique_frac: float = 0.0,
                 exchange_mode: str = "explicit") -> List[str]:
        """Turn on the explicit exchange on every part that supports it
        (big hashed tables, QR's quotient table, Off, AdaEmbed, CAFE parts
        with shard-local sketches), or under `exchange_mode` 'auto' the
        auto layout on every part (module docstring). Must run BEFORE
        init(); returns the names of the parts that turned it on (the rest
        stay replicated). unique_frac > 0 turns on the unique-compact
        buffers of the explicit exchange (the a2a and pallas modes and
        auto ignore it, as in the JAX package). On a two-level mesh the
        a2a and pallas modes take the explicit exchange's hierarchical
        legs (parallel/exchange.py)."""
        if exchange_mode not in SHARD_EXCHANGES:
            raise ValueError(f"unknown --shard_exchange {exchange_mode!r}: "
                             f"one of {', '.join(SHARD_EXCHANGES)}")
        self.mesh = mesh
        active = []
        for i, p in enumerate(self.parts):
            if exchange_mode == "auto":
                if p.auto_shardable:
                    p.auto_mesh = mesh
                    active.append(f"part{i}:{type(p).__name__}")
            elif p.enable_mesh(mesh):
                p.unique_frac = float(unique_frac)
                p.exchange_mode = exchange_mode
                active.append(f"part{i}:{type(p).__name__}")
        return active

    def init(self, seed: int) -> Tuple[Dict, Dict]:
        """The GLOBAL state (and the differentiable params). Under auto
        each part learns which of its tables shard (`auto_keys`) from
        their global shapes here."""
        rng = np.random.default_rng(seed)
        state = {f"part{i}": p.init(rng) for i, p in enumerate(self.parts)}
        dense = {f"part{i}": p.init_dense(rng)
                 for i, p in enumerate(self.parts)}
        for i, p in enumerate(self.parts):
            if p.auto_mesh is not None:
                p.auto_keys = frozenset(
                    k for k, v in state[f"part{i}"].items()
                    if isinstance(v, torch.Tensor) and auto_leaf_is_sharded(
                        k, tuple(v.shape), p.auto_mesh.size))
        return state, dense

    def auto_layout(self) -> Dict[str, List[str]]:
        """The sharded tables of each part under auto, by part."""
        return {f"part{i}:{type(p).__name__}": sorted(p.auto_keys)
                for i, p in enumerate(self.parts) if p.auto_keys}

    def gather(self, state: Dict, ids: torch.Tensor):
        raws, auxs = {}, {}
        for i, p in enumerate(self.parts):
            raws[f"part{i}"], auxs[f"part{i}"] = p.gather(
                state[f"part{i}"], ids[:, self._cols[i]])
        return raws, auxs

    def quantize_for_serving(self, state: Dict, bits: int) -> Dict:
        """Every part's row tables quantized once for serving."""
        return {f"part{i}": p.quantize_for_serving(state[f"part{i}"], bits)
                for i, p in enumerate(self.parts)}

    def gather_quantized(self, state: Dict, qtables: Dict,
                         ids: torch.Tensor) -> Dict:
        """gather's raws, each part's rows dequantized from `qtables`."""
        return {f"part{i}": p.gather_quantized(
                    state[f"part{i}"], qtables[f"part{i}"],
                    ids[:, self._cols[i]])
                for i, p in enumerate(self.parts)}

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
            if replicated and p.auto_mesh is None and self.mesh.size > 1:
                # the card sums duplicate rows with atomics in no fixed
                # order, so replicas could drift apart by f32 rounding:
                # every rank takes rank 0's (small) replicated state (a
                # part under auto agrees on its own: Part._agree)
                for t in tensors_of(s):
                    broadcast(t, self.mesh)
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
