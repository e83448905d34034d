"""K4 — row gather (kernel: gather.cu).

Replaces cafe_tpu/ops/pallas_gather.py `pallas_gather` (the Pallas
`_gather_kernel`). Semantics: table [N, D] of any dtype, ids [B] int32
-> [B, D] with out[i] = table[ids[i]], `tile` rows per block; B must be a
multiple of `tile` (the TPU kernel asserts it; here both versions raise
ValueError). Ids must lie in [0, N): the TPU kernel DMAs whatever row it
is given, so nothing defines the other case. The plain version raises
IndexError (it does not wrap negative ids as `table[ids]` would); the
kernel trips a device-side assert.

`gather` launches the CUDA kernel for a CUDA table and runs
`gather_plain` for a CPU table; it never falls back from one to the
other. A table whose rows are strided (a view) is gathered in place; one
whose columns are strided is made contiguous first.
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

KERNEL = CudaKernel("gather.cu", "gather_launch",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                     ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                     ctypes.c_void_p])

TILE = 256


def _check(table: torch.Tensor, ids: torch.Tensor, tile: int) -> None:
    if table.dim() != 2 or ids.dim() != 1:
        raise ValueError(f"gather: table [N, D] and ids [B] expected, got "
                         f"{tuple(table.shape)} and {tuple(ids.shape)}")
    if ids.dtype != torch.int32:
        raise TypeError(f"gather: int32 ids expected, got {ids.dtype}")
    if table.device != ids.device:
        raise ValueError("gather: table and ids on different devices")
    if tile <= 0 or ids.shape[0] % tile:
        raise ValueError(f"gather: B = {ids.shape[0]} must be a multiple "
                         f"of tile = {tile}")


def vector_bytes(*values: int) -> int:
    """The widest copy unit (16, 4 or 1 bytes) dividing every value: the
    row bytes, the row stride in bytes and both base addresses."""
    for v in (16, 4):
        if all(x % v == 0 for x in values):
            return v
    return 1


def gather_plain(table: torch.Tensor, ids: torch.Tensor,
                 tile: int = TILE) -> torch.Tensor:
    """The kernel's plain PyTorch version: an index_select after a range
    check (which reads the ids on the host)."""
    _check(table, ids, tile)
    n = table.shape[0]
    if ids.numel() and (int(ids.min()) < 0 or int(ids.max()) >= n):
        raise IndexError(f"gather: ids outside [0, {n})")
    return table.index_select(0, ids.long())


def gather(table: torch.Tensor, ids: torch.Tensor,
           tile: int = TILE) -> torch.Tensor:
    """[B, D] rows table[ids]: the CUDA kernel on the card, the plain
    version for CPU tensors."""
    _check(table, ids, tile)
    if table.device.type == "cpu":
        return gather_plain(table, ids, tile)
    if table.device.type != "cuda":
        raise ValueError(f"gather: unsupported device {table.device}")
    if table.shape[1] > 1 and table.stride(1) != 1:
        table = table.contiguous()
    ids = ids.contiguous()
    b, (n, d) = ids.shape[0], table.shape
    out = torch.empty((b, d), dtype=table.dtype, device=table.device)
    if b == 0 or d == 0:
        return out
    itemsize = table.element_size()
    row_bytes, row_stride = d * itemsize, table.stride(0) * itemsize
    vec = vector_bytes(row_bytes, row_stride, table.data_ptr(),
                       out.data_ptr())
    with torch.cuda.device(table.device):
        KERNEL(table.data_ptr(), ids.data_ptr(), out.data_ptr(), b, n,
               row_stride, row_bytes, tile, vec,
               torch.cuda.current_stream().cuda_stream)
    return out
