"""Input pipeline: host batches staged on the card ahead of the step
(port of cafe_tpu/data/loader.py).

Batches are memmap slices (one memcpy each). On the card each batch is
copied into pinned host memory and sent with a non-blocking copy on a
side stream, `depth` batches ahead, so the copies run behind the steps.
The consumer's stream waits on each batch's copy event before the batch
is handed out (else a step could read a half-copied batch), and every
device tensor is marked with `record_stream` for the consumer's stream
(else the caching allocator could hand its memory to a new copy while a
step still reads it).
"""

from __future__ import annotations

import collections
import itertools
from typing import Iterator

import numpy as np
import torch

from ..device import resolve_device

_SENTINEL = object()


def _host(x):
    """A numpy batch array as a CPU tensor (a copy when the array is a
    read-only memmap view)."""
    return None if x is None else torch.from_numpy(
        np.require(x, requirements=["C", "W"]))


def device_prefetch(batches: Iterator, device="cuda",
                    depth: int = 4) -> Iterator:
    """Wrap a (dense, sparse, label, valid) iterator; yield the same
    tuples as tensors on `device` (default the card; raises without CUDA
    unless device='cpu', where the arrays are only converted)."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        for dense, sparse, label, valid in batches:
            yield _host(dense), _host(sparse), _host(label), valid
        return

    copy_stream = torch.cuda.Stream(dev)

    def stage(b):
        *arrays, valid = b
        pinned = [None if x is None else _host(x).pin_memory()
                  for x in arrays]
        with torch.cuda.stream(copy_stream):
            on_dev = [None if p is None else p.to(dev, non_blocking=True)
                      for p in pinned]
            done = torch.cuda.Event()
            done.record(copy_stream)
        return on_dev, valid, done

    queue = collections.deque()
    it = iter(batches)
    for b in itertools.islice(it, depth):
        queue.append(stage(b))
    while queue:
        on_dev, valid, done = queue.popleft()
        consumer = torch.cuda.current_stream(dev)
        consumer.wait_event(done)
        for t in on_dev:
            if t is not None:
                t.record_stream(consumer)
        nxt = next(it, _SENTINEL)
        if nxt is not _SENTINEL:
            queue.append(stage(nxt))
        yield (*on_dev, valid)
