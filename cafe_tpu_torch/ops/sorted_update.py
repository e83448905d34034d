"""Sorted-segment updates (port of cafe_tpu/ops/sorted_update.py).

Primitives the sketch insert lands its writes with:

* `seg_sum(vals, sorted_keys, n)` / `seg_max(...)` — segment reductions;
  keys outside [0, n) are dropped (jax.ops.segment_* semantics).
* `land_max(enc, sorted_keys, n, impl)` — the insert's one B-lane landing:
  'auto' / 'pallas' go to kernel K1 (kernels/land.py: the CUDA kernel for
  CUDA tensors, its plain version for CPU tensors), 'segmax' is plain
  torch. All arms return the same [n, C] int32, -1 where no lane writes.
* `compact_mask(mask, k)` — lane positions of the first k True lanes.

plus `apply_rows_pass(...)`: the Adagrad / Adam (and SGD) sparse apply
as one sort, one segment sum and one elementwise pass over the table,
which ops/sparse.apply_rows takes when the table has at most
PASS_ROW_FACTOR rows per update lane.

Every drop is done with one spare output row that the dropped lanes write
and that is sliced off, so no step needs a host round trip.
"""

from __future__ import annotations

from typing import Tuple

import torch

from ..kernels import land as _land


def _lane_index(keys: torch.Tensor, n_rows: int, like: torch.Tensor
                ) -> torch.Tensor:
    """int64 scatter index shaped like `like`: keys in [0, n_rows) keep
    their row, every other key goes to the spare row n_rows."""
    keep = (keys >= 0) & (keys < n_rows)
    idx = torch.where(keep, keys, n_rows).long()
    return idx.view(-1, *([1] * (like.dim() - 1))).expand_as(like)


def seg_sum(vals: torch.Tensor, sorted_keys: torch.Tensor,
            n_rows: int) -> torch.Tensor:
    """Per destination row r in [0, n_rows): sum of vals [B, ...] over
    lanes with key == r."""
    out = torch.zeros((n_rows + 1,) + tuple(vals.shape[1:]),
                      dtype=vals.dtype, device=vals.device)
    out.scatter_add_(0, _lane_index(sorted_keys, n_rows, vals), vals)
    return out[:n_rows]


def seg_max(vals: torch.Tensor, keys: torch.Tensor,
            n_rows: int) -> torch.Tensor:
    """Per destination row, max of vals over its key segment; empty
    segments return the dtype minimum (INT_MIN / -inf), as
    jax.ops.segment_max does."""
    fill = (float("-inf") if vals.dtype.is_floating_point
            else torch.iinfo(vals.dtype).min)
    out = torch.full((n_rows + 1,) + tuple(vals.shape[1:]), fill,
                     dtype=vals.dtype, device=vals.device)
    out.scatter_reduce_(0, _lane_index(keys, n_rows, vals), vals, "amax",
                        include_self=True)
    return out[:n_rows]


def land_max(enc: torch.Tensor, sorted_keys: torch.Tensor, n_rows: int,
             impl: str = "segmax") -> torch.Tensor:
    """Segment-max landing for (-1)-encoded payloads: enc [B, C] int32
    >= -1, sorted_keys [B] (outside [0, n_rows) dropped) -> [n_rows, C]
    with -1 where no lane writes.

    * 'auto' / 'pallas' — kernel K1 (kernels/land.py). The JAX package
      capped its TPU kernel at MAX_ROWS / MAX_LANES (VMEM); the CUDA
      kernel has no cap, so every sketch size lands through it.
    * 'segmax' — plain torch seg_max, empty rows clamped to -1.
    * 'segsum1', 'scan' — not ported yet (NotImplementedError).
    """
    if impl in ("auto", "pallas"):
        return _land.land_max(enc, sorted_keys.to(torch.int32), n_rows)
    if impl == "segmax":
        return seg_max(enc, sorted_keys, n_rows).clamp_min(-1)
    if impl in ("segsum1", "scan"):
        raise NotImplementedError(
            f"land_max impl {impl!r} is not ported yet (use auto/segmax)")
    raise ValueError(f"unknown land_max impl {impl!r}")


def compact_mask(mask: torch.Tensor, k: int
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lane positions of the first k True lanes of `mask` [B], in lane
    order: (pos [k] int32, valid [k] bool), via one stable argsort."""
    pos = torch.argsort((~mask).to(torch.int32), stable=True)[:k]
    return pos.to(torch.int32), mask[pos]


# Table-pass apply when the table has at most this many rows per update
# lane (the JAX package's rule, kept so both packages take the same arm).
PASS_ROW_FACTOR = 8


def use_table_pass(n_rows: int, n_lanes: int) -> bool:
    return n_rows <= PASS_ROW_FACTOR * n_lanes


def apply_rows_pass(table: torch.Tensor, slots: dict, idx: torch.Tensor,
                    grad: torch.Tensor, lr: float, optimizer: str):
    """Sparse optimizer apply as a full-table pass, in place: duplicates
    coalesce by one segment sum into [N, D] (0 for untouched rows, which
    then move by exactly 0), then one sgd / adagrad / adam row step.
    Adam masks its moment decay to touched rows. Returns (table, slots)."""
    n = table.shape[0]
    order = torch.argsort(idx, stable=True)
    sidx = idx[order]
    g = seg_sum(grad[order], sidx, n)
    if optimizer == "adagrad":
        acc = slots["acc"].add_(g * g)
        table.add_((-lr * g / (torch.sqrt(acc) + 1e-10)).to(table.dtype))
        return table, {"acc": acc}
    if optimizer == "adam":
        touched = (seg_max(torch.ones_like(sidx), sidx, n) > 0)[:, None]
        b1, b2, eps = 0.9, 0.999, 1e-8
        m, v, t = slots["m"], slots["v"], slots["t"] + 1
        m_rows = b1 * m + (1.0 - b1) * g
        v_rows = b2 * v + (1.0 - b2) * (g * g)
        m.copy_(torch.where(touched, m_rows, m))
        v.copy_(torch.where(touched, v_rows, v))
        tf = t.to(torch.float32)
        upd = lr * (m_rows / (1.0 - b1 ** tf)) / (
            torch.sqrt(v_rows / (1.0 - b2 ** tf)) + eps)
        table.sub_(torch.where(touched, upd.to(table.dtype), 0.0))
        return table, {"m": m, "v": v, "t": t}
    table.add_((-lr * g).to(table.dtype))
    return table, {}
