"""dispatch_idle_pct: the share, in %, of the traced window's idle
device time in gaps that open while the host is inside the port's
`cafe_dispatch` range (a GraphedStep's call: the batch copies into the
graph's buffers and the replay's launch), against the gaps that open
between calls (benchmark/spans.py). None on the CPU or where the trace
holds no such range."""

from __future__ import annotations

from benchmark.spans import dispatch_idle_pct


def read(ctx):
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    return dispatch_idle_pct(ctx["trace"])
