"""towers_ms: device ms a training step inside the port's span `towers`
(the feature transform, the DLRM towers and interaction, the loss and
autograd.grad: the towers' backward and the gathered rows' gradients),
read from the marks the port captures into its graph
(benchmark/spans.py); the marks' own time left out. None on the CPU or
where the trace holds no mark."""

from __future__ import annotations

from benchmark.spans import span_ms_a_step


def read(ctx):
    return span_ms_a_step(ctx, "towers")
