"""K3 — SGD sparse apply over sorted row keys (kernel: rowsum.cu).

Replaces cafe_tpu/ops/pallas_rowsum.py `sparse_add_dense` and its Pallas
kernel `pallas_rowsum_t`. Semantics: table[idx[k]] += upd[k] for every
lane with 0 <= idx[k] < N, duplicate rows summed; other lanes, negative
ones included, are dropped. The table is updated IN PLACE and returned.

As in the JAX package, the lanes are first sorted by row (a stable
`torch.sort`) and the updates permuted to match; both are library calls
outside the kernel there too. The TPU's [B, D] -> [D, B] transpose is a
layout for its MXU and has no counterpart here. Each run of equal keys is
summed in lane order starting from 0 and added to its row once.

`sparse_add_dense_` launches the CUDA kernel for a CUDA table and runs
`sparse_add_dense_plain_` for a CPU table; it never falls back from one
to the other. The kernel is deterministic (no atomics; see rowsum.cu).
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

KERNEL = CudaKernel("rowsum.cu", "rowsum_add_launch",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                     ctypes.c_void_p])


def _check(table: torch.Tensor, idx: torch.Tensor,
           upd: torch.Tensor) -> None:
    if table.dim() != 2 or idx.dim() != 1 or upd.dim() != 2 \
            or upd.shape != (idx.shape[0], table.shape[1]):
        raise ValueError(
            f"sparse_add_dense_: table [N, D], idx [B], upd [B, D] expected, "
            f"got {tuple(table.shape)}, {tuple(idx.shape)}, "
            f"{tuple(upd.shape)}")
    if table.dtype != torch.float32 or upd.dtype != torch.float32 \
            or idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"sparse_add_dense_: f32 table/upd and int ids "
                        f"expected, got {table.dtype}, {upd.dtype}, "
                        f"{idx.dtype}")
    if not (table.device == idx.device == upd.device):
        raise ValueError("sparse_add_dense_: tensors on different devices")
    if not table.is_contiguous():
        raise ValueError("sparse_add_dense_: the table must be contiguous "
                         "(it is updated in place)")


def sort_lanes(n_rows: int, idx: torch.Tensor, upd: torch.Tensor):
    """(sorted int32 keys [B], updates [B, D] in their order): lanes
    outside [0, n_rows) get key n_rows and sort last."""
    safe = torch.where((idx >= 0) & (idx < n_rows), idx,
                       n_rows).to(torch.int32)
    keys, order = torch.sort(safe, stable=True)
    return keys, upd[order].contiguous()


def add_sorted_plain_(table: torch.Tensor, keys: torch.Tensor,
                      upd: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version on sorted lanes: per-row sums
    into a zero accumulator with one spare row for dropped keys, then one
    add (the JAX package's table + acc.T)."""
    n = table.shape[0]
    acc = torch.zeros((n + 1, table.shape[1]), dtype=table.dtype,
                      device=table.device)
    acc.index_add_(0, keys.clamp(0, n).long(), upd)
    table += acc[:n]
    return table


def add_sorted_(table: torch.Tensor, keys: torch.Tensor,
                upd: torch.Tensor) -> torch.Tensor:
    """One launch of the CUDA kernel on lanes as sort_lanes returns them
    (keys sorted ascending: a key split into two runs would have two
    owners). CUDA tensors only."""
    _check(table, keys, upd)
    if table.device.type != "cuda":
        raise ValueError(f"add_sorted_: a CUDA table expected, got "
                         f"{table.device}")
    if keys.dtype != torch.int32 or not (keys.is_contiguous()
                                         and upd.is_contiguous()):
        raise ValueError("add_sorted_: contiguous int32 keys and "
                         "contiguous updates expected")
    with torch.cuda.device(table.device):
        KERNEL(table.data_ptr(), keys.data_ptr(), upd.data_ptr(),
               keys.shape[0], table.shape[1], table.shape[0],
               torch.cuda.current_stream().cuda_stream)
    return table


def sparse_add_dense_plain_(table: torch.Tensor, idx: torch.Tensor,
                            upd: torch.Tensor) -> torch.Tensor:
    """The wrapper's plain PyTorch version, in place."""
    _check(table, idx, upd)
    return add_sorted_plain_(table, *sort_lanes(table.shape[0], idx, upd))


def sparse_add_dense_(table: torch.Tensor, idx: torch.Tensor,
                      upd: torch.Tensor) -> torch.Tensor:
    """table[idx] += upd in place: the CUDA kernel on the card, the plain
    version for CPU tensors."""
    _check(table, idx, upd)
    if table.device.type == "cpu":
        return sparse_add_dense_plain_(table, idx, upd)
    if table.device.type != "cuda":
        raise ValueError(f"sparse_add_dense_: unsupported device "
                         f"{table.device}")
    return add_sorted_(table, *sort_lanes(table.shape[0], idx, upd))
