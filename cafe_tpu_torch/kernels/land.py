"""K1 — segmented max landing (kernel: land.cu).

Replaces cafe_tpu/ops/pallas_land.py `pallas_land_max_t` (the Pallas
`_land_kernel`). Semantics are land_max's: enc [B, C] int32 >= -1 and keys
[B] int32 (keys outside [0, n_rows) are dropped; the sketch insert hands
them sorted, the kernel does not need it) -> [n_rows, C] int32, the
per-row per-channel max with -1 where no lane writes. Exact for many
writers per (row, channel).

`land_max` launches the CUDA kernel for a CUDA tensor and runs
`land_max_plain` for a CPU tensor; it never falls back from one to the
other. On the H100 the kernel is memory-bound (see land.cu).
"""

from __future__ import annotations

import ctypes

import torch

from .build import CudaKernel

KERNEL = CudaKernel("land.cu", "land_max_launch",
                    [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                     ctypes.c_int64, ctypes.c_int32, ctypes.c_int32,
                     ctypes.c_void_p])


def _check(enc: torch.Tensor, keys: torch.Tensor, n_rows: int) -> None:
    if enc.dim() != 2 or keys.dim() != 1 or keys.shape[0] != enc.shape[0]:
        raise ValueError(f"land_max: enc [B, C] and keys [B] expected, got "
                         f"{tuple(enc.shape)} and {tuple(keys.shape)}")
    if enc.dtype != torch.int32 or keys.dtype != torch.int32:
        raise TypeError(f"land_max: int32 enc and keys expected, got "
                        f"{enc.dtype} and {keys.dtype}")
    if enc.device != keys.device:
        raise ValueError("land_max: enc and keys on different devices")
    if not 0 <= n_rows < 2**31:
        raise ValueError(f"land_max: n_rows {n_rows} out of int32 range")


def land_max_plain(enc: torch.Tensor, keys: torch.Tensor,
                   n_rows: int) -> torch.Tensor:
    """The kernel's plain PyTorch version: scatter_reduce amax into a
    -1-filled tensor with one spare row that takes the dropped lanes."""
    _check(enc, keys, n_rows)
    c = enc.shape[1]
    out = torch.full((n_rows + 1, c), -1, dtype=torch.int32,
                     device=enc.device)
    keep = (keys >= 0) & (keys < n_rows)
    idx = torch.where(keep, keys, n_rows).long()[:, None].expand(-1, c)
    out.scatter_reduce_(0, idx, enc, "amax", include_self=True)
    return out[:n_rows]


def land_max(enc: torch.Tensor, keys: torch.Tensor,
             n_rows: int) -> torch.Tensor:
    """[n_rows, C] landing of enc by keys: the CUDA kernel on the card,
    the plain version for CPU tensors."""
    _check(enc, keys, n_rows)
    if enc.device.type == "cpu":
        return land_max_plain(enc, keys, n_rows)
    if enc.device.type != "cuda":
        raise ValueError(f"land_max: unsupported device {enc.device}")
    enc = enc.contiguous()
    keys = keys.contiguous()
    out = torch.empty((n_rows, enc.shape[1]), dtype=torch.int32,
                      device=enc.device)
    with torch.cuda.device(enc.device):
        KERNEL(enc.data_ptr(), keys.data_ptr(), out.data_ptr(),
               enc.shape[0], enc.shape[1], n_rows,
               torch.cuda.current_stream().cuda_stream)
    return out
