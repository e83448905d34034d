#!/usr/bin/env python3
"""Benchmark: the port's fused DLRM + CAFE train-step throughput on one
NVIDIA card. The jax-free twin of bench.py: the same configurations,
constants, data and JSON line, through cafe_tpu_torch.

    python3 bench_torch.py        # needs a CUDA card; raises without one

The headline is bench.py's (bench.py:198-206): DLRM with CAFE and the v1
HotSketch, Criteo-Kaggle's 26 vocabularies (sum 33.76 M), 13 dense
features, dim 16, cr 1e-3, SGD, bf16 towers, batch 2048, a sketch insert
after every backward. K = DISPATCH_K steps run per call through
build_multi_step, one CUDA graph a call (train/capture.GraphedStep). The
extras in the same line: the insert every 8 steps (its skipped inserts
are conditional nodes in that graph, utils/cond.cond), cr 1e-4, and the
CriteoTB towers at dim 128 and cr 0.1 on the Kaggle vocabularies ("dim-128
shapes on Kaggle vocab") at K = 1 over 100 steps.

Clock: every timed window ends in torch.cuda.synchronize() through the
port's fence (utils/timing.fence), as the reference brackets its ms/it
(ArtifactEvaluation/main.py:385-391). The rates are the median of the
windows. As a guard the step's analytic matmul FLOPs times the rate must
stay under the card's dense bf16 peak, looked up by
torch.cuda.get_device_name(); a card this table does not know raises
rather than take a default.

Prints ONE JSON line with bench.py's keys plus "device" (the card's name
and power limit, as nvidia-smi reports them) and "graphed" (whether each
configuration's step replayed a CUDA graph). An extra that fails prints
as null and the script then exits 1.
"""

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

from cafe_tpu_torch.config import Config  # noqa: E402
from cafe_tpu_torch.data.criteo import (CRITEO_COUNTS,  # noqa: E402,F401
                                        make_criteo_batches)
from cafe_tpu_torch.device import resolve_device  # noqa: E402
from cafe_tpu_torch.train import build_all, build_multi_step  # noqa: E402
from cafe_tpu_torch.train.loop import model_arch  # noqa: E402
from cafe_tpu_torch.utils.timing import fence  # noqa: E402

BASELINE_EXAMPLES_PER_S = 145_000.0

# dense bf16 tensor-core peak by torch.cuda.get_device_name() (NVIDIA's
# data sheets, SXM parts at 700 W)
PEAK_FLOPS = {
    "NVIDIA H100 80GB HBM3": 989e12,
    "NVIDIA H200": 989e12,
}

BATCH = 2048
WARMUP = 30
STEPS = 200
WINDOWS = 5
# K train steps per call (the --steps_per_dispatch mode, bit-equal to
# sequential steps), one CUDA graph a call on the card
DISPATCH_K = 8
EXTRA_WINDOWS = 3


def step_flops_per_example(cfg, num_dense: int, num_sparse: int) -> float:
    """Analytic matmul FLOPs per example of the DLRM train step (forward
    2 FLOPs a MAC, backward about twice the forward), bench.py's lower
    bound over the port's model_arch: gathers, scatters and the sketch
    are memory ops and not counted."""
    ln_bot, ln_top = model_arch(cfg, num_dense, num_sparse)
    macs = sum(a * b for a, b in zip(ln_bot, ln_bot[1:]))
    macs += sum(a * b for a, b in zip(ln_top, ln_top[1:]))
    num_fea = num_sparse + 1
    macs += num_fea * num_fea * cfg.embedding_dim  # dot interaction bmm
    return 3.0 * 2.0 * macs


def peak_flops(name: str) -> float:
    """The dense bf16 peak of the card named `name`; raises for a card
    the table does not know."""
    if name not in PEAK_FLOPS:
        raise ValueError(f"bench_torch: no bf16 peak known for {name!r}; "
                         f"add it to PEAK_FLOPS (the MFU guard takes no "
                         f"default)")
    return PEAK_FLOPS[name]


def device_info(device) -> dict:
    """The card's name and power limit as nvidia-smi gives them (the CPU:
    its name only)."""
    if device.type != "cuda":
        return {"name": "cpu", "nvidia_smi": None}
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()
    return {"name": torch.cuda.get_device_name(device),
            "nvidia_smi": smi[device.index or 0]}


def headline_config(batch: int = BATCH) -> Config:
    """bench.py's headline (bench.py:198-206)."""
    return Config(
        dataset="criteo", model="dlrm", embedding_dim=16,
        compress_method="cafe", compress_rate=0.001,
        cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
        mini_batch_size=batch, learning_rate=0.1, optimizer="sgd",
        bf16=True, cafe_insert_interval=1)


def extra_configs(cfg: Config) -> dict:
    """{name: (config, measure keywords)} of bench.py's three extras
    (bench.py:241-258)."""
    cfg128 = dataclasses.replace(
        cfg, dataset="criteotb", embedding_dim=128, compress_rate=0.1,
        learning_rate=1.0)
    return {
        "interval8": (dataclasses.replace(cfg, cafe_insert_interval=8), {}),
        "cr1e4": (dataclasses.replace(cfg, compress_rate=0.0001), {}),
        "dim128": (cfg128, {"steps": 100, "dispatch_k": 1}),
    }


def _fused(batches, k: int, batch: int):
    """Groups of k batches as one [k * batch] batch, valid = k * batch."""
    return [tuple(torch.cat([g[j] for g in batches[i:i + k]])
                  for j in range(3)) + (k * batch,)
            for i in range(0, len(batches) - k + 1, k)]


def measure(cfg, train_data, batches, windows=WINDOWS, steps=STEPS,
            dispatch_k=DISPATCH_K, batch=BATCH, warmup=WARMUP,
            device="cuda"):
    """(median examples/s, each window's rate, graphed) of `windows`
    windows of `steps` calls each, after `warmup` calls."""
    dev = resolve_device(device)
    _, _, state, train_step, _ = build_all(cfg, train_data, device=dev)
    if dispatch_k > 1:
        train_step = build_multi_step(train_step, dispatch_k,
                                      donate=cfg.donate_state)
        batches = _fused(batches, dispatch_k, batch)
    graphed = bool(getattr(train_step, "graphed", False))
    metrics = None
    for i in range(warmup):
        d, s, l, v = batches[i % len(batches)]
        state, metrics = train_step(state, d, s, l, v)
    fence(state, metrics)
    rates = []
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(steps):
            d, s, l, v = batches[i % len(batches)]
            state, metrics = train_step(state, d, s, l, v)
        fence(state, metrics)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        rates.append(batch * dispatch_k * steps /
                     (time.perf_counter() - t0))
    del state, metrics, train_step
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    return float(np.median(rates)), rates, graphed


def main(device="cuda", data=None, batch=BATCH, windows=WINDOWS,
         extra_windows=EXTRA_WINDOWS, steps=STEPS, warmup=WARMUP) -> int:
    """Measure the headline and the extras and print the JSON line.
    `data` (train_data, batches) replaces the Criteo-Kaggle batches
    (tests pass small ones on the CPU). Returns 1 when an extra failed."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    info = device_info(dev)
    train_data, batches = data or make_criteo_batches(
        batch=batch, n_batches=16, device=dev)
    cfg = headline_config(batch)
    kw = dict(batch=batch, warmup=warmup, device=dev)
    examples_per_s, rates, graphed = measure(
        cfg, train_data, batches, windows=windows, steps=steps, **kw)

    num_sparse = train_data.sparse.shape[1]
    flops_ex = step_flops_per_example(cfg, train_data.dense.shape[1],
                                      num_sparse)
    mfu = None
    if dev.type == "cuda":
        peak = peak_flops(info["name"])
        mfu = examples_per_s * flops_ex / peak
        if mfu > 1.0:
            raise SystemExit(
                f"REFUSING to report: {examples_per_s:.3e} ex/s x "
                f"{flops_ex:.3e} FLOP/ex = "
                f"{examples_per_s * flops_ex / 1e12:.0f} TFLOP/s exceeds "
                f"the card's {peak / 1e12:.0f} TFLOP/s bf16 peak (implied "
                f"MFU {mfu:.2f} > 1): the clock is broken "
                f"(tools/clock_probe_torch.py)")

    extras, graphed_by = {}, {"headline": graphed}
    for name, (cfg_x, kw_x) in extra_configs(cfg).items():
        try:
            v, _, graphed_by[name] = measure(
                cfg_x, train_data, batches, windows=extra_windows,
                **dict(dict(kw, steps=steps), **kw_x))
            extras[f"{name}_examples_per_s"] = round(v, 1)
        except Exception as e:
            print(f"extra '{name}' failed: {e!r}", file=sys.stderr)
            extras[f"{name}_examples_per_s"] = None
            graphed_by[name] = None

    print(json.dumps({
        "metric": "dlrm_cafe_train_examples_per_s",
        "value": round(examples_per_s, 1),
        "unit": "examples/s/chip",
        "vs_baseline": round(examples_per_s / BASELINE_EXAMPLES_PER_S, 3),
        "window_min": round(min(rates), 1),
        "window_max": round(max(rates), 1),
        "windows": windows,
        "steps_per_dispatch": DISPATCH_K,
        "mfu": None if mfu is None else round(mfu, 4),
        "flops_per_example": flops_ex,
        "cafe_insert_interval": 1,
        **extras,
        "sync": "torch.cuda.synchronize() fence (utils/timing.py)",
        "device": info,
        "graphed": graphed_by,
    }), flush=True)
    return 1 if any(v is None for v in extras.values()) else 0


if __name__ == "__main__":
    sys.exit(main())
