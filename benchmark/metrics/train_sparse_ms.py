"""train_sparse_ms: device ms a training step spends in every device
operation that is not a matmul: the sketch query, the gathers, the
insert and migration, the apply, the elementwise ops and the copies of
the batch into the graph's buffers. Splitting it takes spans inside the
program."""

from __future__ import annotations

from benchmark import trace
from benchmark.metrics.train_gemm_ms import GEMM


def read(ctx):
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    ops = trace.in_window(ctx["trace"])
    ms = sum(d for name, _, d in ops if not GEMM.search(name)) / 1e6
    return ms / ctx["traced_steps"]
