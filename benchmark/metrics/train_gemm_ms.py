"""train_gemm_ms: device ms a training step spends in matmul kernels
(the dense towers and the interaction), matched by name, from the
traced window."""

from __future__ import annotations

import re

from benchmark import trace

# cuBLAS / cuBLASLt / CUTLASS matmul kernels and their split-K reductions
GEMM = re.compile(r"gemm|gemv|xmma|cutlass|splitKreduce", re.IGNORECASE)


def read(ctx):
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    ops = trace.in_window(ctx["trace"])
    ms = sum(d for name, _, d in ops if GEMM.search(name)) / 1e6
    return ms / ctx["traced_steps"]
