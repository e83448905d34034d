"""K2 — in-place sparse row update (kernel: scatter_add.cu).

Replaces cafe_tpu/ops/pallas_apply.py `pallas_scatter_add` (the Pallas
`_apply_kernel`). Semantics: table[ids[k]] += upd[k] for every lane with
0 <= ids[k] < N, duplicates summing across the whole batch; other lanes
are dropped. The table is updated IN PLACE (the JAX package donates it
through input_output_aliases) and returned.

`scatter_add_` launches the CUDA kernel for a CUDA table and runs
`scatter_add_plain_` for a CPU table; it never falls back from one to the
other. The kernel sums duplicates with f32 atomics in no fixed order, so
it matches the plain version to f32 rounding (see scatter_add.cu).
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

KERNEL = CudaKernel("scatter_add.cu", "scatter_add_launch",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int64, ctypes.c_int32, ctypes.c_int64,
                     ctypes.c_void_p])


def _check(table: torch.Tensor, ids: torch.Tensor,
           upd: torch.Tensor) -> None:
    if table.dim() != 2 or ids.dim() != 1 or upd.dim() != 2 \
            or upd.shape != (ids.shape[0], table.shape[1]):
        raise ValueError(
            f"scatter_add_: table [N, D], ids [B], upd [B, D] expected, got "
            f"{tuple(table.shape)}, {tuple(ids.shape)}, {tuple(upd.shape)}")
    if table.dtype != torch.float32 or upd.dtype != torch.float32 \
            or ids.dtype != torch.int32:
        raise TypeError(f"scatter_add_: f32 table/upd and int32 ids "
                        f"expected, got {table.dtype}, {upd.dtype}, "
                        f"{ids.dtype}")
    if not (table.device == ids.device == upd.device):
        raise ValueError("scatter_add_: tensors on different devices")
    if not table.is_contiguous():
        raise ValueError("scatter_add_: the table must be contiguous (it "
                         "is updated in place)")


def scatter_add_plain_(table: torch.Tensor, ids: torch.Tensor,
                       upd: torch.Tensor) -> torch.Tensor:
    """The kernel's plain PyTorch version, in place: one index_add_, in
    which each dropped lane adds +0.0 to row 0 (no boolean mask, whose
    output shape would depend on the data)."""
    _check(table, ids, upd)
    keep = (ids >= 0) & (ids < table.shape[0])
    table.index_add_(0, torch.where(keep, ids, 0).long(),
                     torch.where(keep[:, None], upd, 0.0))
    return table


def scatter_add_(table: torch.Tensor, ids: torch.Tensor,
                 upd: torch.Tensor) -> torch.Tensor:
    """table[ids] += upd in place: the CUDA kernel on the card, the plain
    version for CPU tensors."""
    _check(table, ids, upd)
    if table.device.type == "cpu":
        return scatter_add_plain_(table, ids, upd)
    if table.device.type != "cuda":
        raise ValueError(f"scatter_add_: unsupported device {table.device}")
    ids = ids.contiguous()
    upd = upd.contiguous()
    with torch.cuda.device(table.device):
        KERNEL(table.data_ptr(), ids.data_ptr(), upd.data_ptr(),
               ids.shape[0], table.shape[1], table.shape[0],
               torch.cuda.current_stream().cuda_stream)
    return table
