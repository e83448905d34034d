"""sketch_insert_ms: device ms a training step inside the port's span
`cafe_insert` (CAFE's importance scores, the HotSketch insert with K1's
landing, the promotion cap and compaction; at an insert interval > 1 the
conditional node that holds them, which runs its body on one step in
that many), read from the marks the port captures into its graph
(benchmark/spans.py); the marks' own time left out. None on the CPU or
where the trace holds no mark."""

from __future__ import annotations

from benchmark.spans import span_ms_a_step


def read(ctx):
    return span_ms_a_step(ctx, "cafe_insert")
