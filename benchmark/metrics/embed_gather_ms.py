"""embed_gather_ms: device ms a training step inside the port's span
`embed_gather` (the embedding layer's gather: CAFE's sketch query and
routed row gather, the other parts' lookups), read from the marks the
port captures into its graph (benchmark/spans.py); the marks' own time
left out. None on the CPU or where the trace holds no mark."""

from __future__ import annotations

from benchmark.spans import span_ms_a_step


def read(ctx):
    return span_ms_a_step(ctx, "embed_gather")
