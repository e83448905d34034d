"""A TorchDispatchMode that raises on what a CUDA graph cannot hold, for
the CPU tests of the port's graphed steps (tests/test_torch_capture.py,
tests/test_torch_graphrec_capture.py).

`NoCaptureBreaks` raises `CaptureBreak` on every value read back to the
host (`aten._local_scalar_dense`: `.item()`, `int()`, `float()`,
`bool()` of a tensor) other than a branch predicate's
(utils/cond.host_pred, which a graph takes on the card), and on every op
whose output shape depends on the data (nonzero, masked_select, unique,
boolean indexing, repeat_interleave without an output size).
"""

import sys

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from cafe_tpu_torch.utils.cond import host_pred

aten = torch.ops.aten


class CaptureBreak(AssertionError):
    """An op that a CUDA graph cannot hold."""


# reads of a value to the host: .item(), int(), float() and bool() all
# reach _local_scalar_dense
_HOST_READS = {aten._local_scalar_dense.default}
# output shapes that depend on the data
_DATA_SHAPED = {aten.nonzero, aten.masked_select, aten._unique,
                aten._unique2, aten.unique_dim, aten.unique_consecutive,
                aten.argwhere, aten.bincount, aten.masked_scatter}
_INDEXING = {aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_}


def _in_host_pred() -> bool:
    """Whether the read comes from a branch predicate (utils/cond's
    host_pred): an eager step's one allowed read, a conditional node in
    a graph."""
    frame = sys._getframe()
    while frame is not None:
        if frame.f_code is host_pred.__code__:
            return True
        frame = frame.f_back
    return False


class NoCaptureBreaks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if func in _HOST_READS and not _in_host_pred():
            raise CaptureBreak(f"host read: {func}")
        if packet in _DATA_SHAPED or (
                packet is aten.repeat_interleave
                and "output_size" not in (kwargs or {})):
            raise CaptureBreak(f"data-dependent shape: {func}")
        if packet in _INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise CaptureBreak(f"boolean indexing: {func}")
        return func(*args, **(kwargs or {}))
