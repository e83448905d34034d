"""migrate_ms: device ms a training step inside the port's span
`cafe_migrate` (CAFE's migration: each promoted id's hash row copied
into its hot row, on every lane of the fixed-size promotion lanes), read
from the marks the port captures into its graph (benchmark/spans.py);
the marks' own time left out. None on the CPU or where the trace holds
no mark."""

from __future__ import annotations

from benchmark.spans import span_ms_a_step


def read(ctx):
    return span_ms_a_step(ctx, "cafe_migrate")
