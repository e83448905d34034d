"""step_bubble_pct: the share, in %, of the port's `step` spans' device
intervals (each sub-step of a dispatch, from its begin mark's start to
its end mark's end) in which no device op runs: the gaps between the
replayed graph's kernels inside a step, which the window's idle share
mixes with the host's. The marks' own time is left out of the
intervals (benchmark/spans.py). None on the CPU or where the trace
holds no mark."""

from __future__ import annotations

from benchmark.spans import bubble_pct


def read(ctx):
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    return bubble_pct(ctx["trace"], "step")
