"""`compiled_call(fn, device)`: a no-argument chain of torch ops as the
root measurement tools time it (cafe_tpu_torch; no jax). Where a JAX tool
jits a whole chain, its port replays one CUDA graph of it.

On the card the chain is a train.capture.GraphedStep of one call on a
token tensor: the construction makes its WARMUP_CALLS eager calls and the
capture (which replays once), and each later call replays the graph and
returns the captured call's output, which the next replay overwrites.
Kernel launches count as GraphedStep counts them. On the CPU the chain
runs eagerly. `.graphed` says which.
"""

from __future__ import annotations

import torch

from cafe_tpu_torch.train.capture import WARMUP_CALLS, GraphedStep


class compiled_call:
    """`fn()` replayed as one CUDA graph on the card, eager on the CPU."""

    def __init__(self, fn, device):
        dev = torch.device(device)
        self.graphed = dev.type == "cuda"
        if not self.graphed:
            self._call = fn
            return
        step = GraphedStep(lambda _token: fn(), carry=False)
        token = torch.zeros((), device=dev)
        self._call = lambda: step(token)
        for _ in range(WARMUP_CALLS + 1):
            self._call()
        if not step._graphs:
            raise RuntimeError("compiled_call: the chain was not captured")

    def __call__(self):
        return self._call()
