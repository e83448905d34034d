"""land_roofline_pct: kernel K1 (kernels/land.cu, the sketch insert's
landing) against its roofline, in %: the least time its bytes at the
cell's shape take at the card's HBM bandwidth (counts/kernel_bytes.py:
B x F lanes of the packed or unpacked channels, the sketch's S rows),
over K1's mean device time a launch in the traced window. None where K1
did not run."""

from __future__ import annotations

from benchmark import trace
from benchmark.counts.kernel_bytes import land_bytes
from benchmark.counts.peaks import peak

KERNEL = "land_max_kernel"


def read(ctx):
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    durs = [d for name, _, d in trace.in_window(ctx["trace"])
            if KERNEL in name]
    if not durs:
        return None
    c = ctx["layout"]["cafe"]
    nbytes = land_bytes(ctx["batch"] * c["lanes_per_row"],
                        c["land_channels"], c["hotn"])
    t_min = nbytes / peak(ctx["card"], "hbm_bytes_per_s")
    return 100.0 * t_min / (sum(durs) / len(durs) / 1e9)
