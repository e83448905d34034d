"""train_mfu: the whole train step's share of the card's dense bf16 peak,
in %: the frozen tower FLOPs a training example (counts/flops.py) times
the measured window's examples/s, over the peak of the card
torch.cuda.get_device_name() names (counts/peaks.py; an unknown card
raises). Nothing on the CPU."""

from __future__ import annotations

from benchmark.counts.peaks import peak


def read(ctx):
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    return 100.0 * ctx["examples_per_s"] * ctx["train_flops_per_example"] \
        / peak(ctx["card"], "bf16_flops")
