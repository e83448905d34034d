"""Sparse embedding-row updates (port of cafe_tpu/ops/sparse.py).

Row index convention, as in the JAX package: ids outside [0, rows) are
dropped lanes. Tables and optimizer slots are updated IN PLACE (the JAX
package donates them to the jitted step) and returned.

`apply_rows` dispatches as the JAX package does:

* SGD into tables of >= PALLAS_APPLY_MIN_ROWS rows with dim % 128 == 0
  goes to kernel K2 (kernels/scatter_add.py — the CUDA kernel for CUDA
  tables, its plain version for CPU tables), where the JAX package runs
  its Pallas kernel ops/pallas_apply.py; impl 'pallas' forces it and
  'scatter' forbids it;
* under impl 'dense', SGD that the K2 rule leaves and that passes the JAX
  package's dense row-sum gate (_use_dense_rowsum, the TPU's VMEM caps
  kept word for word so that the same configurations take the same
  route) goes to kernel K3 (kernels/rowsum.py), where the JAX package
  runs ops/pallas_rowsum.py;
* other SGD takes one `index_add_` (a library scatter, where the JAX
  package leaves the update to XLA's scatter);
* Adagrad / rows-Adam coalesce duplicates first (torch semantics), then
  take the full-table pass (ops/sorted_update.apply_rows_pass) when the
  table is small against the batch, else per-row updates of the
  coalesced rows at a fixed shape: ids wrap and drop as JAX's
  mode="drop" scatters do, so nothing waits for the card and a CUDA
  graph holds the update.

`apply_rows(..., deterministic=True)` (the graph recommenders' parts,
Part.deterministic_sums) sums duplicate rows through `segment_rows` in
every arm, so the update repeats bit for bit: SGD takes K3 whatever the
gate, the table pass and the per-row arms coalesce with it. The default
keeps the routes above, whose index_add_ / scatter_add_ sum duplicates
in float atomics on the card.

`segment_rows` is the JAX package's `segment_rows` (jax.ops.segment_sum)
on kernel K3: one launch into a zeroed table, the lanes of a segment
summed in a fixed order, so the sum repeats bit for bit. `gather_rows`
is `table[idx]` whose backward is segment_rows of the incoming gradient
over the same ids (torch's own index backward is the library's).
"""

from __future__ import annotations

import math

import torch

from ..kernels import rowsum as _rowsum
from ..kernels import scatter_add as _scatter_add
from . import sorted_update as _sorted

# optimizer -> {slot name -> state-key suffix} (state keys "table_acc", ...)
SLOT_SUFFIXES = {
    "sgd": {},
    "adagrad": {"acc": "_acc"},
    "adam": {"m": "_m", "v": "_v", "t": "_t"},
}

# SGD into tables with at least this many rows (and dim % 128 == 0) uses
# kernel K2, the same rule as the JAX package's Pallas apply.
PALLAS_APPLY_MIN_ROWS = 1 << 20

# The JAX package's gate for its dense row-sum kernel (pallas_rowsum.py
# MAX_OUT_BYTES / MAX_LANES and ops/sparse._use_dense_rowsum): a [D, N] f32
# VMEM accumulator of at most 6 MiB, at most 262,144 lanes and a [D, B]
# update block of at most 8 MiB. K3 itself has no such cap.
DENSE_ROWSUM_MAX_TABLE_BYTES = 6 << 20
DENSE_ROWSUM_MAX_LANES = 262144
DENSE_ROWSUM_MAX_UPDATE_BYTES = 8 << 20


def init_slots(table: torch.Tensor, optimizer: str) -> dict:
    """Fresh optimizer-slot dict for `table` (keys are slot NAMES):
    {} sgd, {acc} adagrad, {m, v, t} adam."""
    if optimizer == "adagrad":
        return {"acc": torch.zeros_like(table)}
    if optimizer == "adam":
        return {"m": torch.zeros_like(table), "v": torch.zeros_like(table),
                "t": torch.zeros((), dtype=torch.int32,
                                 device=table.device)}
    return {}


def _sorted_groups(idx: torch.Tensor):
    """(order, sorted ids, head mask, int32 group of each sorted lane):
    one stable sort and a scan."""
    order = torch.argsort(idx, stable=True)
    sidx = idx[order]
    head = torch.ones_like(sidx, dtype=torch.bool)
    head[1:] = sidx[1:] != sidx[:-1]
    seg = torch.cumsum(head.to(torch.int32), 0, dtype=torch.int32) - 1
    return order, sidx, head, seg


def coalesce(idx: torch.Tensor, grad: torch.Tensor, drop_sentinel: int):
    """Combine duplicate row indices: (unique_idx, summed_grad), same
    length as idx; duplicate lanes carry `drop_sentinel` as index and a
    zero gradient. One stable sort, one segment sum."""
    order, sidx, head, seg = _sorted_groups(idx)
    seg = seg.long()
    summed = torch.zeros_like(grad).index_add_(0, seg, grad[order])
    out_grad = summed[seg] * head[:, None]
    out_idx = torch.where(head, sidx, drop_sentinel)
    return out_idx, out_grad


def _compact_ids(sidx, head, seg, capacity: int, drop_sentinel: int):
    """The group heads' ids at their group positions in a [capacity]
    buffer (sentinel elsewhere); groups past the capacity are dropped."""
    pos = torch.where(head & (seg < capacity), seg, capacity).long()
    out = torch.full((capacity + 1,), drop_sentinel, dtype=sidx.dtype,
                     device=sidx.device)
    out[pos] = sidx          # in-range positions are distinct
    return out[:capacity]


def unique_compact(idx: torch.Tensor, capacity: int, drop_sentinel: int):
    """The distinct values of idx [M] in sorted order in a fixed
    [capacity] buffer (sentinel in unused lanes); inv [M] int32, each
    lane's position in the buffer (valid only when n_unique <= capacity);
    n_unique, an int32 scalar. The capacity-bounded exchange ships C
    instead of M ids when the batch is skewed."""
    order, sidx, head, seg = _sorted_groups(idx)
    uids = _compact_ids(sidx, head, seg, capacity, drop_sentinel)
    inv = torch.empty_like(seg)
    inv[order] = seg
    return uids, inv, seg[-1] + 1


def coalesce_compact(idx: torch.Tensor, grad: torch.Tensor, capacity: int,
                     drop_sentinel: int):
    """coalesce() into a fixed [capacity] buffer: (cidx [C], cgrad [C, D],
    n_unique). Each group's gradients sum in sorted-lane order; groups
    beyond the capacity are DROPPED, so callers check n_unique <=
    capacity and fall back to the full-size path
    (parallel/exchange.sharded_apply)."""
    order, sidx, head, seg = _sorted_groups(idx)
    cgrad = torch.zeros((capacity + 1,) + tuple(grad.shape[1:]),
                        dtype=grad.dtype, device=grad.device)
    cgrad.index_add_(0, seg.clamp_max(capacity).long(), grad[order])
    return (_compact_ids(sidx, head, seg, capacity, drop_sentinel),
            cgrad[:capacity], seg[-1] + 1)


def _coalesce_rows(idx: torch.Tensor, grad: torch.Tensor, n_rows: int,
                   deterministic: bool = False):
    """coalesce() onto n_rows rows at a fixed shape, as JAX's `.at[uidx]`
    with mode="drop" writes them: a negative id wraps once (numpy's
    rule), what is still outside [0, n_rows) is dropped. Returns (uidx,
    summed grad, rows int64, kept bool, the lanes' ids sorted), a
    dropped lane's row 0 (callers write it nothing). `deterministic`
    sums the groups through segment_rows (K3)."""
    order, sidx, head, seg = _sorted_groups(idx)
    if deterministic:
        summed = segment_rows(grad[order], seg, grad.shape[0])
    else:
        summed = torch.zeros_like(grad).index_add_(0, seg.long(),
                                                   grad[order])
    ugrad = summed[seg.long()] * head[:, None]
    uidx = torch.where(head, sidx, n_rows)
    wrapped = torch.where(uidx < 0, uidx + n_rows, uidx)
    kept = (wrapped >= 0) & (wrapped < n_rows)
    return (uidx, ugrad, torch.where(kept, wrapped, 0).long(), kept,
            sidx)


def _set_rows_(x: torch.Tensor, uidx, rows, kept, sidx, vals) -> None:
    """x[rows] = vals over the kept lanes, as JAX's `.at[uidx].set(...,
    mode="drop")` writes a coalesced update, at a fixed shape.

    Two kept lanes share a row only when a negative id wraps onto an id
    of the batch; XLA applies a scatter in lane order, so the later lane,
    the non-negative id, wins. Every lane that writes nothing (dropped,
    or a wrap that loses) rewrites the first writer's row with the first
    writer's value (with no writer, row 0 with its own), so no row takes
    two values and the write needs no order."""
    target = rows.to(sidx.dtype)
    pos = torch.searchsorted(sidx, target).clamp_max(sidx.shape[0] - 1)
    writes = kept & ~((uidx < 0) & (sidx[pos] == target))
    # index_select, not x[t] with a 0-d tensor t (a host read)
    first = torch.argmax(writes.to(torch.int8)).reshape(1)
    row1 = rows.index_select(0, first)
    fill = torch.where(writes.any(), vals.index_select(0, first),
                       x.index_select(0, row1))
    x[torch.where(writes, rows, row1)] = torch.where(writes[:, None], vals,
                                                     fill)


def sparse_adagrad(table, acc, idx, grad, lr: float, eps: float = 1e-10,
                   deterministic: bool = False):
    """Adagrad with torch semantics (coalesce first; per-element acc):
    acc += g^2, row -= lr * g / (sqrt(acc) + eps). In place, at a fixed
    shape: dropped lanes add zeros to row 0, as sparse_sgd's do, and the
    accumulator is read at clip(id), as the JAX package reads it."""
    n = table.shape[0]
    uidx, ugrad, rows, kept, _ = _coalesce_rows(idx, grad, n, deterministic)
    g = ugrad * kept[:, None]
    acc.index_add_(0, rows, g * g)
    std = torch.sqrt(acc[uidx.clamp(0, n - 1).long()]) + eps
    table.index_add_(0, rows, (-lr * g / std).to(table.dtype))
    return table, acc


def sparse_adam(table, m, v, t, idx, grad, lr: float, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8,
                deterministic: bool = False):
    """Rows-Adam: moments advance only for rows touched this step; bias
    correction uses the table-global step count t. In place, at a fixed
    shape (the moments are read at clip(id), as the JAX package reads
    them; dropped lanes write nothing); returns (table, m, v, t)."""
    n = table.shape[0]
    uidx, ugrad, rows, kept, sidx = _coalesce_rows(idx, grad, n,
                                                   deterministic)
    t = t + 1
    safe = uidx.clamp(0, n - 1).long()
    m_rows = beta1 * m[safe] + (1.0 - beta1) * ugrad
    v_rows = beta2 * v[safe] + (1.0 - beta2) * (ugrad * ugrad)
    _set_rows_(m, uidx, rows, kept, sidx, m_rows)
    _set_rows_(v, uidx, rows, kept, sidx, v_rows)
    tf = t.to(torch.float32)
    upd = lr * (m_rows / (1.0 - beta1 ** tf)) / (
        torch.sqrt(v_rows / (1.0 - beta2 ** tf)) + eps)
    table.index_add_(0, rows, -(upd * kept[:, None]).to(table.dtype))
    return table, m, v, t


def sparse_sgd(table: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
               lr: float) -> torch.Tensor:
    """SGD scatter update in place; duplicate indices sum. Dropped lanes
    add +0.0 to row 0, so no lane needs a host round trip."""
    upd = (-lr * grad).to(table.dtype)
    keep = (idx >= 0) & (idx < table.shape[0])
    table.index_add_(0, torch.where(keep, idx, 0).long(),
                     torch.where(keep[:, None], upd, 0.0))
    return table


def _use_pallas_apply(n_rows: int, dim: int, impl: str = "auto") -> bool:
    """K2 selection (the JAX package's rule without its TPU check: the
    K2 wrapper serves both devices). 'dense' falls through to the auto
    rule, as in the JAX package."""
    if impl == "scatter":
        return False
    if impl == "pallas":
        return True
    if impl not in ("auto", "dense"):
        raise ValueError(f"unknown sparse_apply_impl {impl!r}")
    return n_rows >= PALLAS_APPLY_MIN_ROWS and dim % 128 == 0


def _use_dense_rowsum(n_rows: int, dim: int, lanes: int,
                      impl: str = "auto") -> bool:
    """K3 selection: impl 'dense' and the JAX package's gate."""
    return (impl == "dense" and dim % 8 == 0
            and n_rows * dim * 4 <= DENSE_ROWSUM_MAX_TABLE_BYTES
            and lanes <= DENSE_ROWSUM_MAX_LANES
            and dim * lanes * 4 <= DENSE_ROWSUM_MAX_UPDATE_BYTES)


def apply_rows(table: torch.Tensor, slots: dict, idx: torch.Tensor,
               grad: torch.Tensor, lr: float, optimizer: str,
               impl: str = "auto", table_pass: bool | None = None,
               deterministic: bool = False):
    """Sparse row update, in place, with `slots` as init_slots made them.
    `deterministic` sums duplicate rows through segment_rows (module
    docstring). Returns (table, slots)."""
    if optimizer not in SLOT_SUFFIXES:
        raise ValueError(f"unknown optimizer {optimizer!r}")
    if optimizer == "sgd" and deterministic:
        upd = (-lr * grad).to(table.dtype)
        return _rowsum.sparse_add_dense_(table, idx, upd), {}
    if optimizer == "sgd" and _use_pallas_apply(table.shape[0],
                                                table.shape[1], impl):
        upd = (-lr * grad).to(table.dtype)
        return _scatter_add.scatter_add_(table, idx.to(torch.int32),
                                         upd.contiguous()), {}
    if optimizer == "sgd" and _use_dense_rowsum(*table.shape, idx.shape[0],
                                                impl):
        upd = (-lr * grad).to(table.dtype)
        return _rowsum.sparse_add_dense_(table, idx, upd), {}
    if table_pass is None:
        table_pass = optimizer != "sgd" and _sorted.use_table_pass(
            table.shape[0], idx.shape[0])
    if table_pass:
        return _sorted.apply_rows_pass(
            table, slots, idx, grad, lr, optimizer,
            seg_sum=segment_rows if deterministic else _sorted.seg_sum)
    if optimizer == "adagrad":
        table, acc = sparse_adagrad(table, slots["acc"], idx, grad, lr,
                                    deterministic=deterministic)
        return table, {"acc": acc}
    if optimizer == "adam":
        table, m, v, t = sparse_adam(table, slots["m"], slots["v"],
                                     slots["t"], idx, grad, lr,
                                     deterministic=deterministic)
        return table, {"m": m, "v": v, "t": t}
    return sparse_sgd(table, idx, grad, lr), {}


def _segment_sum(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """segment_rows without autograd: K3 into a zeroed f32 table of
    num_segments rows, the trailing dims flattened to its width."""
    if values.dtype != torch.float32:
        raise TypeError(f"segment_rows: f32 values expected (kernel K3), "
                        f"got {values.dtype}")
    e = values.shape[0]
    flat = values.reshape(e, math.prod(values.shape[1:]))
    out = torch.zeros((num_segments, flat.shape[1]), dtype=values.dtype,
                      device=values.device)
    if e:
        _rowsum.sparse_add_dense_(out, seg_ids.reshape(e), flat)
    return out.reshape((num_segments,) + tuple(values.shape[1:]))


class _SegmentRows(torch.autograd.Function):
    """segment_rows; its backward gathers the incoming gradient at each
    lane's segment (ids in [0, num_segments))."""

    @staticmethod
    def forward(ctx, values, seg_ids, num_segments):
        ctx.save_for_backward(seg_ids)
        return _segment_sum(values, seg_ids, num_segments)

    @staticmethod
    def backward(ctx, grad):
        seg_ids, = ctx.saved_tensors
        return grad[seg_ids], None, None


class _GatherRows(torch.autograd.Function):
    """table[idx]; its backward sums the incoming gradient into the
    table's rows through segment_rows (ids in [0, rows))."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, grad):
        idx, = ctx.saved_tensors
        flat = grad.reshape((idx.numel(),) + tuple(grad.shape[idx.dim():]))
        return _segment_sum(flat, idx.reshape(-1), ctx.rows), None


def segment_rows(values: torch.Tensor, seg_ids: torch.Tensor,
                 num_segments: int) -> torch.Tensor:
    """[num_segments, ...]: row s sums values [E, ...] over the lanes
    with seg_ids == s (int32 or int64 [E]); lanes with an id outside
    [0, num_segments) are dropped, as jax.ops.segment_sum drops them.
    f32 only. One K3 launch on the card (its plain version for CPU
    tensors), summing each segment in a fixed order. Differentiable in
    values for ids in range (the gradient is a gather)."""
    return _SegmentRows.apply(values, seg_ids, num_segments)


def gather_rows(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] (ids in [0, rows), any shape) whose backward is
    segment_rows of the incoming gradient over idx: the gradient of a
    row gathered many times sums in a fixed order on the card."""
    return _GatherRows.apply(table, idx)
