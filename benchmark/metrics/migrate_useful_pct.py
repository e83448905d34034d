"""migrate_useful_pct: the share, in %, of CAFE's migration lanes that
move a promoted row: 100 x the port's `promotions` over its
`migration_lanes`, counted where the work happens over the traced
window (cafe_tpu_torch/utils/spans.counters(), zeroed when the profiler
turns on). The port is imported here, at the read, so that a port
without the counters reads None; so do the CPU and a window with no
lane."""

from __future__ import annotations


def read(ctx):
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    try:
        from cafe_tpu_torch.utils.spans import counters
    except ImportError:
        return None
    got = counters()
    if not got["migration_lanes"]:
        return None
    return 100.0 * got["promotions"] / got["migration_lanes"]
