#!/usr/bin/env python3
"""A known-FLOPs probe of the timing clock, for the PyTorch / CUDA port
(cafe_tpu_torch; no jax). Port of tools/clock_probe.py: the same matmul
chain (K = 50 dependent 4096^3 bf16 matmuls, 2 * 4096^3 FLOPs each) in
its two patterns, each timed two ways:

  patterns  scan   ONE CUDA graph of the K dependent matmuls (the JAX
                   tool's lax.scan in one dispatch)
            chain  K separate launches, data-chained in Python (bench.py's
                   pattern: N steps, one synchronize at the end)
  clocks    host_sync    the host clock around the run, ended by
                         torch.cuda.synchronize() (PERF.md section 2's
                         clock)
            cuda_events  CUDA events recorded before and after the run

Achieved TFLOP/s never exceeds the card's bf16 peak (989 TFLOP/s for an
H100 SXM at 700 W, NVIDIA's data sheet) on an honest clock; the card's
name and power limit (nvidia-smi) are printed beside the rates.

    python3 tools/clock_probe_torch.py [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.device import device_name, resolve_device  # noqa
from tools.compiled_call_torch import compiled_call  # noqa: E402

BF16_PEAK_TFLOPS = 989.0       # H100 SXM, dense bf16, 700 W


def card() -> str:
    """`nvidia-smi --query-gpu=name,power.limit --format=csv,noheader`'s
    first line, or '' where there is no nvidia-smi."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout
    except (OSError, subprocess.CalledProcessError):
        return ""
    return out.strip().splitlines()[0] if out.strip() else ""


def run(n=4096, k=50, repeats=3, device="cuda") -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    flops = k * 2 * n ** 3
    dtype = torch.bfloat16
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(n, n))
                         * 0.01).to(dev, dtype)

    def one(y):
        return y @ y * 0.001

    def chain():
        y = x
        for _ in range(k):
            y = one(y)
        return y

    patterns = {"scan": compiled_call(chain, dev), "chain": chain}
    for fn in patterns.values():                 # warm-up
        fn()
    if cuda:
        torch.cuda.synchronize()
    name = device_name(dev)
    smi = card() if cuda else ""
    print(f"device: {name}  nvidia-smi: {smi}", file=sys.stderr)
    rates = {}
    for pattern, fn in patterns.items():
        clocks = {"host_sync": []}
        if cuda:
            clocks["cuda_events"] = []
        for _ in range(repeats):
            if cuda:
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                start.record()
                fn()
                end.record()
                torch.cuda.synchronize()
                clocks["host_sync"].append(
                    flops / (time.perf_counter() - t0) / 1e12)
                clocks["cuda_events"].append(
                    flops / (start.elapsed_time(end) / 1e3) / 1e12)
            else:
                t0 = time.perf_counter()
                fn()
                clocks["host_sync"].append(
                    flops / (time.perf_counter() - t0) / 1e12)
        for clock, rs in clocks.items():
            print(f"{pattern:5s} {clock:17s}: "
                  f"{min(rs):8.1f} - {max(rs):8.1f} TFLOP/s")
            rates[f"{pattern}_{clock}"] = rs
    return {"tflops": rates, "n": n, "k": k, "dtype": "bf16",
            "bf16_peak_tflops": BF16_PEAK_TFLOPS,
            "max_share_of_peak": max(max(v) for v in rates.values())
            / BF16_PEAK_TFLOPS,
            "graphed": patterns["scan"].graphed,
            "device": name, "nvidia_smi": smi}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(device=args.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
