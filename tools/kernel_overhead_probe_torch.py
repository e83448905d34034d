#!/usr/bin/env python3
"""The fixed cost of a kernel on this card, for the PyTorch / CUDA port
(cafe_tpu_torch; no jax). Port of tools/kernel_overhead_probe.py: the
same shapes, chain lengths and JSON lines.

k unfusable element-wise kernels (x <- 1e-7 + 1.000001 * x, one
torch.addcmul each) over a [4, 53248] f32 array and the JAX tool's other
shapes; us a kernel is the slope between k = 16 and k = 128, which
leaves out the constant of a call and its synchronize. Each chain is
measured in two modes: launched eagerly, one kernel launch at a time
(the host's launch cost), and replayed as one CUDA graph (the device's
cost a kernel), the per-launch cost behind a CAFE+ step's 1,317 kernels.
bandwidth_us_expected is the kernel's read and write at the H100's 3.35
TB/s.

    python3 tools/kernel_overhead_probe_torch.py [--device cuda]
        [--windows 5]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys
import time

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.device import device_name, resolve_device  # noqa
from cafe_tpu_torch.utils.timing import fence  # noqa: E402
from tools.compiled_call_torch import compiled_call  # noqa: E402

SHAPES = [(4, 53248), (8, 53248), (53248,), (256, 256), (33792, 8)]
KS = (16, 128)
HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet


def chain(k, x, eps, scale):
    def f():
        y = x
        for _ in range(k):
            y = torch.addcmul(eps, y, scale)
        return y.sum()
    return f


def run(windows=5, calls=10, device="cuda", shapes=SHAPES) -> list:
    dev = resolve_device(device)
    name = device_name(dev)
    eps = torch.tensor(1e-7, device=dev)
    scale = torch.tensor(1.000001, device=dev)
    modes = ["eager"] + (["graph"] if dev.type == "cuda" else [])
    lines = []
    for shape in shapes:
        x = torch.ones(shape, device=dev)
        for mode in modes:
            times = {}
            for k in KS:
                f = chain(k, x, eps, scale)
                run_one = compiled_call(f, dev) if mode == "graph" else f
                fence(run_one())
                meds = []
                for _ in range(windows):
                    t0 = time.perf_counter()
                    for _ in range(calls):
                        r = run_one()
                    fence(r)
                    meds.append((time.perf_counter() - t0) / calls * 1e6)
                times[k] = float(np.median(meds))
            per_kernel = (times[KS[1]] - times[KS[0]]) / (KS[1] - KS[0])
            mb = float(np.prod(shape)) * 4 / 1e6
            rec = {"shape": str(shape), "mode": mode,
                   "us_k16": round(times[16], 1),
                   "us_k128": round(times[128], 1),
                   "us_per_kernel": round(per_kernel, 2),
                   "bandwidth_us_expected": round(
                       mb * 1e6 * 2 / HBM_BYTES_PER_S * 1e6, 3),
                   "device": name}
            print(json.dumps(rec), flush=True)
            lines.append(rec)
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.windows, device=args.device)


if __name__ == "__main__":
    main()
