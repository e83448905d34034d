"""Device fencing and timed windows (port of cafe_tpu/utils/timing.py).

The JAX package fenced a timed window with a value fetch because its
remote TPU runtime could not be trusted to block. On CUDA the fence is
`torch.cuda.synchronize()`, as the reference's harness brackets every
ms/it window (ArtifactEvaluation/main.py:385-391); CPU tensors need none.
"""

from __future__ import annotations

import time

import torch


def tensors_of(tree):
    """Every tensor in a tree of dicts, lists and tuples."""
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from tensors_of(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from tensors_of(v)


def fence(*trees) -> None:
    """Wait for the card to finish all queued work when any tensor in
    `trees` lives on it; a no-op for CPU tensors."""
    devices = {t.device for t in tensors_of(trees) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)


def queue_bound() -> int:
    """Most asynchronous calls a timed loop leaves queued on the card
    between fences. Eager PyTorch returns before the card runs a call, so
    an unfenced loop of 1000+ eval calls would grow the launch queue and
    the caching allocator without bound; a fence every 256 calls keeps
    both small. The fence sits INSIDE the timed window, so it can only
    understate throughput, never inflate it."""
    return 256


def timed_window(run_once, steps: int) -> float:
    """Time `steps` calls of `run_once` (which must return the call's
    output tree), fencing on the LAST output. Returns seconds."""
    t0 = time.time()
    out = None
    for _ in range(steps):
        out = run_once()
    fence(out)
    return time.time() - t0
