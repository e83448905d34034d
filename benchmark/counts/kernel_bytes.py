"""Bytes the port's kernels must move at least, from their shapes (frozen
copies of chip_smoke.py's bound arithmetic). Each input byte is counted
read once and each output byte written once."""

from __future__ import annotations


def land_bytes(lanes: int, channels: int, rows: int) -> int:
    """K1 (kernels/land.cu): enc [lanes, channels] and keys [lanes] int32
    read, the [rows, channels] int32 landing written."""
    return (lanes * channels + lanes + rows * channels) * 4

