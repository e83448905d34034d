"""Row-wise quantized embedding tables for serving (port of
cafe_tpu/ops/quantized.py).

Each row keeps uint codes plus an f32 (scale, zero) pair; rows are
dequantized where they are gathered. The row layout is the JAX
package's, byte for byte: one uint8 row per table row,

    [cw code bytes][4 bytes f32 scale][4 bytes f32 zero]

(cw = D for int8, D/2 for int4), so a lookup is one row gather and the
scale and zero come back by a bitcast (little-endian f32). int4 packs two
codes a byte PLANE-MAJOR: byte j holds dim j in its low nibble and dim
j + D/2 in its high nibble, so the unpack is a channel concat.

The arithmetic is the JAX package's on the CPU: the scale divides by
`levels` (a true division, as the package's eager op computes it), the
codes round half to even (torch.round and jnp.round both do) and clip to
[0, levels]. `levels` divides as a 0-d tensor on the table's device:
torch's CUDA division by a Python number multiplies by its f32
reciprocal, which put the last bit of some scales apart from the CPU's.
`bits` stays a Python int.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuantizedTable(NamedTuple):
    codes: torch.Tensor   # uint8 [N, cw + 8]: code bytes, f32 scale bytes,
    #                       f32 zero bytes
    scale: torch.Tensor   # f32 [N, 1]
    zero: torch.Tensor    # f32 [N, 1]
    bits: int


def _f32_bytes(x: torch.Tensor) -> torch.Tensor:
    """f32 [N, 1] -> its little-endian bytes, uint8 [N, 4]."""
    return x.to(torch.float32).contiguous().view(torch.uint8).reshape(-1, 4)


def quantize_rowwise(table: torch.Tensor, bits: int = 8) -> QuantizedTable:
    """Quantize every row of an f32 [N, D] table to `bits` (4 or 8)."""
    assert bits in (4, 8)
    levels = (1 << bits) - 1
    lo = table.amin(dim=1, keepdim=True)
    hi = table.amax(dim=1, keepdim=True)
    scale = (hi - lo).clamp_min(1e-12) / torch.full(
        (), float(levels), dtype=torch.float32, device=table.device)
    q = torch.round((table - lo) / scale).clamp(0, levels).to(torch.uint8)
    if bits == 4:
        assert table.shape[1] % 2 == 0
        half = table.shape[1] // 2
        q = q[:, :half] | (q[:, half:] << 4)
    codes = torch.cat([q, _f32_bytes(scale), _f32_bytes(lo)], dim=1)
    return QuantizedTable(codes=codes, scale=scale, zero=lo, bits=bits)


def _rows(codes: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """codes[idx], one row gather; a row of whole 4-byte words moves as
    int32 words (the same bytes, a quarter of the elements: 2.6-2.9x
    faster than the uint8 gather at 425,984 rows of 72 and 136 B on an
    H100, chip_smoke.py's row_gather)."""
    idx = idx.long()
    if codes.shape[1] % 4 == 0:
        return codes.view(torch.int32)[idx].view(torch.uint8)
    return codes[idx]


def dequantize_rows(qt: QuantizedTable, idx: torch.Tensor) -> torch.Tensor:
    """Gather and dequantize the rows at `idx` [M] -> f32 [M, D]."""
    rows = _rows(qt.codes, idx)
    cw = rows.shape[1] - 8
    codes = rows[:, :cw]
    scale = rows[:, cw:cw + 4].contiguous().view(torch.float32)
    zero = rows[:, cw + 4:].contiguous().view(torch.float32)
    if qt.bits == 4:
        codes = torch.cat([codes & 0x0F, (codes >> 4) & 0x0F], dim=1)
    return codes.to(torch.float32) * scale + zero


def quantization_error(table: torch.Tensor, bits: int) -> float:
    """Largest |dequantized - table| over the whole table."""
    qt = quantize_rowwise(table, bits)
    idx = torch.arange(table.shape[0], device=table.device)
    return float((dequantize_rows(qt, idx) - table).abs().max())
