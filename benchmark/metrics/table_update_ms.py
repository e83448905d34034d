"""table_update_ms: device ms a training step inside the port's span
`cafe_update` (CAFE's sparse SGD apply to the rows that served the
batch), read from the marks the port captures into its graph
(benchmark/spans.py); the marks' own time left out. None on the CPU or
where the trace holds no mark."""

from __future__ import annotations

from benchmark.spans import span_ms_a_step


def read(ctx):
    return span_ms_a_step(ctx, "cafe_update")
