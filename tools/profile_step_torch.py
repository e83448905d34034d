#!/usr/bin/env python3
"""Profile the bench-protocol train step and print where the time goes,
for the PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/profile_step.py: the same workload, summary and flags.

Runs `--steps` fused K = 8 dispatches of the bench.py workload (DLRM +
CAFE, dim 16, cr 1e-3, bf16 towers, SGD, batch 2048 over Criteo-Kaggle's
26 vocabularies; build_multi_step(step, 8, donate=True), which on the
card replays one CUDA graph a dispatch) under torch.profiler with the
CPU and CUDA activities, exports the Chrome trace (the reference wraps
its loop in torch.autograd.profiler the same way,
dlrm_s_pytorch.py:1576-1578), then aggregates its complete ('X') events
per thread: total and count per (lane, name), device lanes (the CUDA
streams) first.

If the trace shows no kernel inside the graph replays (CUPTI may not
report them), the tool profiles the eager step instead and says so.

    python3 tools/profile_step_torch.py [--steps 30] [--top 25]
        [--out DIR] [--parse_only DIR] [--device cuda]

The trace stays in DIR/plugins/profile/<run>/<host>.trace.json.gz (DIR
defaults to build/profile_step), the JAX tool's layout, so either
tool's --parse_only reads it.
"""

from __future__ import annotations

import argparse
import glob
import gzip
import json
import os
import os.path as osp
import socket
import sys
import time
from collections import defaultdict

import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

BATCH = 2048      # bench.py:78
DISPATCH_K = 8    # bench.py:86
OUT_DIR = osp.join(osp.dirname(osp.dirname(osp.abspath(__file__))), "build",
                   "profile_step")
DEVICE_LANES = ("tpu", "xla op", "device", "step", "stream", "gpu", "cuda")


def newest_trace(trace_dir):
    paths = glob.glob(osp.join(trace_dir, "plugins", "profile", "*",
                               "*.trace.json.gz"))
    if not paths:
        raise FileNotFoundError(f"no trace.json.gz under {trace_dir}")
    return max(paths, key=os.path.getmtime)


def is_device(thread: str) -> bool:
    """A device lane: the JAX tool's TPU names, and the CUDA streams of a
    torch.profiler trace ("stream 7")."""
    t = thread.lower()
    return any(s in t for s in DEVICE_LANES)


def load_events(trace_path):
    """The traceEvents of a Chrome trace, gzipped or not."""
    with open(trace_path, "rb") as f:
        head = f.read(2)
    opener = gzip.open if head == b"\x1f\x8b" else open
    with opener(trace_path, "rt") as f:
        return json.load(f).get("traceEvents", [])


def summarize(trace_path, top):
    """Print each lane's total and its `top` (name, total, count) rows,
    device lanes first; returns {lane: (total_us, [(us, count, name)])}."""
    events = load_events(trace_path)
    tname = {}
    for e in events:
        if e.get("ph") == "M" and e.get("name") == "thread_name":
            tname[(e.get("pid"), e.get("tid"))] = \
                e.get("args", {}).get("name", "")
    agg = defaultdict(lambda: [0.0, 0])
    tot = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or not e.get("dur"):
            continue
        key = (e.get("pid"), e.get("tid"))
        thread = tname.get(key, f"{key}")
        agg[(thread, e["name"])][0] += e["dur"]
        agg[(thread, e["name"])][1] += 1
        tot[thread] += e["dur"]
    threads = sorted(tot, key=lambda t: (not is_device(t), -tot[t]))
    table = {}
    for t in threads:
        rows = sorted(((v[0], v[1], n) for (th, n), v in agg.items()
                       if th == t), reverse=True)[:top]
        if not rows:
            continue
        table[t] = (tot[t], rows)
        print(f"\n== thread: {t or '(unnamed)'}  total {tot[t]/1e3:.2f} ms")
        for dur, cnt, name in rows:
            print(f"  {dur/1e3:9.3f} ms  x{cnt:<5d} {name[:90]}")
    return table


def device_kernels(trace_path) -> dict:
    """{kernel name: count} of the device kernels in a trace."""
    out = defaultdict(int)
    for e in load_events(trace_path):
        if e.get("ph") == "X" and e.get("cat") == "kernel":
            out[e["name"]] += 1
    return dict(out)


def trace_path_for(out_dir) -> str:
    run = time.strftime("%Y_%m_%d_%H_%M_%S")
    d = osp.join(out_dir, "plugins", "profile", run)
    os.makedirs(d, exist_ok=True)
    return osp.join(d, f"{socket.gethostname()}.trace.json.gz")


def profile_dispatches(run_one, steps, out_dir, device) -> str:
    """Trace `steps` calls of run_one(i) (CPU and, on the card, CUDA
    activities); returns the gzipped Chrome trace's path."""
    from torch.profiler import ProfilerActivity, profile

    from cafe_tpu_torch.utils.timing import fence
    acts = [ProfilerActivity.CPU]
    if device.type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts) as prof:
        out = None
        for i in range(steps):
            out = run_one(i)
        fence(out)
    path = trace_path_for(out_dir)
    prof.export_chrome_trace(path)
    return path


def run(steps=30, top=25, out=OUT_DIR, device="cuda", data=None, **cfg_kw
        ) -> dict:
    """Profile the fused dispatches of the headline step on `data`
    ((train_data, 16 batches); default the bench protocol's), its Config
    taking `cfg_kw` besides; returns {"trace", "graphed",
    "fell_back_to_eager", "kernels": {name: count}, "device", ...}."""
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.data.criteo import make_criteo_batches
    from cafe_tpu_torch.device import device_name, resolve_device
    from cafe_tpu_torch.train import build_all, build_multi_step
    from cafe_tpu_torch.utils.timing import fence

    dev = resolve_device(device)
    cfg = Config(dataset="criteo", model="dlrm", embedding_dim=16,
                 compress_method="cafe", compress_rate=0.001,
                 cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                 mini_batch_size=BATCH, learning_rate=0.1,
                 optimizer="sgd", bf16=True, **cfg_kw)
    train_data, batches = data or make_criteo_batches(
        batch=BATCH, n_batches=16, device=dev)
    fused = []
    for i in range(0, len(batches) - DISPATCH_K + 1, DISPATCH_K):
        grp = batches[i:i + DISPATCH_K]
        fused.append(tuple(torch.cat([g[j] for g in grp]) for j in range(3))
                     + (DISPATCH_K * BATCH,))

    def build(capture):
        _, _, state, step, _ = build_all(cfg, train_data, device=dev,
                                         capture=capture)
        multi = build_multi_step(step, DISPATCH_K, donate=True)
        held = [state]

        def run_one(i):
            held[0], m = multi(held[0], *fused[i % len(fused)])
            return held[0], m
        for i in range(10):
            run_one(i)
        fence(held[0])
        return multi, run_one

    multi, run_one = build(True)
    graphed = bool(getattr(multi, "graphed", False))
    path = profile_dispatches(run_one, steps, out, dev)
    kernels = device_kernels(path)
    fell_back = dev.type == "cuda" and not kernels
    if fell_back:
        print("no kernel reported inside the graph replays: profiling the "
              "eager step instead", flush=True)
        del multi, run_one
        multi, run_one = build(False)
        graphed = False
        path = profile_dispatches(run_one, steps, out, dev)
        kernels = device_kernels(path)
    print(f"trace written to {path}")
    table = summarize(path, top)
    return {"trace": path, "graphed": graphed,
            "fell_back_to_eager": fell_back, "steps": steps,
            "dispatch_k": DISPATCH_K, "kernels": kernels,
            "lanes": {t: tot for t, (tot, _) in table.items()},
            "device": device_name(dev)}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=30,
                    help="fused K=8 dispatches to profile (after warmup)")
    ap.add_argument("--top", type=int, default=25)
    ap.add_argument("--out", default=OUT_DIR)
    ap.add_argument("--parse_only", default="",
                    help="skip running; parse this trace dir")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    if args.parse_only:
        return summarize(newest_trace(args.parse_only), args.top)
    return run(args.steps, args.top, args.out, args.device)


if __name__ == "__main__":
    main()
