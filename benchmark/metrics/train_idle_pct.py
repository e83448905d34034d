"""train_idle_pct: the share of the traced training window, in %, in
which no operation runs on the card (the union of the profiler's
device ops against the window's wall time)."""

from __future__ import annotations

from benchmark import trace


def read(ctx):
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    tr = ctx["trace"]
    return 100.0 * (1.0 - trace.device_busy_s(tr) / trace.window_s(tr))
