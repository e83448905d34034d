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
  coalesced rows. The per-row arm drops out-of-range lanes with a boolean
  mask, which waits for the card once.
"""

from __future__ import annotations

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


def _kept_rows(table, idx, grad):
    """Coalesced rows in range: (rows int64 [U], grad [U, D])."""
    uidx, ugrad = coalesce(idx, grad, table.shape[0])
    keep = (uidx >= 0) & (uidx < table.shape[0])
    return uidx[keep].long(), ugrad[keep]


def sparse_adagrad(table, acc, idx, grad, lr: float, eps: float = 1e-10):
    """Adagrad with torch semantics (coalesce first; per-element acc):
    acc += g^2, row -= lr * g / (sqrt(acc) + eps). In place."""
    rows, g = _kept_rows(table, idx, grad)
    acc_rows = acc[rows] + g * g
    acc[rows] = acc_rows
    std = torch.sqrt(acc_rows) + eps
    table[rows] = table[rows] + (-lr * g / std).to(table.dtype)
    return table, acc


def sparse_adam(table, m, v, t, idx, grad, lr: float, beta1: float = 0.9,
                beta2: float = 0.999, eps: float = 1e-8):
    """Rows-Adam: moments advance only for rows touched this step; bias
    correction uses the table-global step count t. In place; returns
    (table, m, v, t)."""
    rows, g = _kept_rows(table, idx, grad)
    t = t + 1
    m_rows = beta1 * m[rows] + (1.0 - beta1) * g
    v_rows = beta2 * v[rows] + (1.0 - beta2) * (g * g)
    m[rows] = m_rows
    v[rows] = v_rows
    tf = t.to(torch.float32)
    upd = lr * (m_rows / (1.0 - beta1 ** tf)) / (
        torch.sqrt(v_rows / (1.0 - beta2 ** tf)) + eps)
    table[rows] = table[rows] - upd.to(table.dtype)
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
               impl: str = "auto", table_pass: bool | None = None):
    """Sparse row update, in place, with `slots` as init_slots made them.
    Returns (table, slots)."""
    if optimizer not in SLOT_SUFFIXES:
        raise ValueError(f"unknown optimizer {optimizer!r}")
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
        return _sorted.apply_rows_pass(table, slots, idx, grad, lr,
                                       optimizer)
    if optimizer == "adagrad":
        table, acc = sparse_adagrad(table, slots["acc"], idx, grad, lr)
        return table, {"acc": acc}
    if optimizer == "adam":
        table, m, v, t = sparse_adam(table, slots["m"], slots["v"],
                                     slots["t"], idx, grad, lr)
        return table, {"m": m, "v": v, "t": t}
    return sparse_sgd(table, idx, grad, lr), {}
