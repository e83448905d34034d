"""Device fencing (port of cafe_tpu/utils/timing.fence).

The JAX package fenced a timed window with a value fetch because its
remote TPU runtime could not be trusted to block. On CUDA the fence is
`torch.cuda.synchronize()`, as the reference's harness brackets every
ms/it window (ArtifactEvaluation/main.py:385-391); CPU tensors need none.
"""

from __future__ import annotations

import torch


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)


def fence(*trees) -> None:
    """Wait for the card to finish all queued work when any tensor in
    `trees` lives on it; a no-op for CPU tensors."""
    devices = {t.device for t in _tensors(trees) if t.is_cuda}
    for dev in devices:
        torch.cuda.synchronize(dev)
