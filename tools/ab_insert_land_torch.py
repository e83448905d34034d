#!/usr/bin/env python3
"""Interleaved A/B of the sketch insert's landing implementations, for
the PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/ab_insert_land.py.

The insert's one B-lane landing (ops/sorted_update.land_max) lands every
round-1 write of the sketch insert. Arms: 'segmax' (scatter_reduce amax),
'segsum1' (the single-writer sum), 'scan' (segmented cummax + end-lane
gather) and 'pallas' (kernel K1, kernels/land.py, the port of
ops/pallas_land.py; the arm keeps the name of the kernel it replaces).
Three parts:

  1. the isolated sketch_insert at bench shapes (53,248 lanes, 33,792
     buckets), interleaved windows;
  2. equal_state: every arm inserts the same 4 batches into a fresh
     4,096-bucket sketch; every arm must give the first arm's state bit
     for bit, or the run fails (the JAX tool only prints);
  3. the headline train step (DLRM + CAFE, dim 16, cr 1e-3, bf16 towers,
     SGD, batch 2048, an insert every step) per arm (--skip_level2 skips
     it).

Protocol: all arms built and warmed (6 runs) first, then timed in
interleaved windows within one process, each ended by the port's fence.

    python3 tools/ab_insert_land_torch.py [--windows 5] [--steps 60]
        [--device cuda]

Prints one JSON line per level (and per compared arm); exits non-zero if
an arm's state differs.
"""

from __future__ import annotations

import argparse
import faulthandler
import json
import os.path as osp
import signal
import sys
import time

import numpy as np

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

IMPLS = ["segmax", "segsum1", "scan", "pallas"]
FIELDS = ("val", "cnt", "dic", "free", "free_top", "tot")


def interleave(arms, windows, steps, fence):
    carries = {k: c for k, (_, c) in arms.items()}
    for name, (run, _) in arms.items():
        print(f"build+warm arm {name}...", flush=True)
        t0 = time.time()
        for _ in range(6):
            carries[name] = run(carries[name])
        fence(carries[name])
        print(f"  {name} ready in {time.time() - t0:.1f}s", flush=True)
    out = {k: [] for k in arms}
    for _ in range(windows):
        for name, (run, _) in arms.items():
            c = carries[name]
            t0 = time.perf_counter()
            for _ in range(steps):
                c = run(c)
            fence(c)
            out[name].append((time.perf_counter() - t0) / steps * 1e6)
            carries[name] = c
    return out


def _level(name, res):
    med = {k: round(float(np.median(v)), 1) for k, v in res.items()}
    line = {"level": name, **med,
            "windows": {k: [round(x, 1) for x in v] for k, v in res.items()}}
    print(json.dumps(line), flush=True)
    return line


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--steps", type=int, default=60)
    ap.add_argument("--lanes", type=int, default=53248)
    ap.add_argument("--buckets", type=int, default=33792)
    ap.add_argument("--impls", nargs="+", default=IMPLS)
    ap.add_argument("--skip_level2", action="store_true")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def run(args) -> list:
    """The three parts; returns the printed records. Raises if an arm's
    state differs from the first arm's."""
    import torch
    from cafe_tpu_torch.device import resolve_device
    from cafe_tpu_torch.sketch.hotsketch import (HotSketchConfig,
                                                 init_sketch, sketch_insert)
    from cafe_tpu_torch.utils.timing import fence

    dev = resolve_device(args.device)
    rng = np.random.default_rng(0)
    b = args.lanes
    n_batches = 8
    ids = [torch.from_numpy(((rng.random(b) ** 4) * 33762577)
                            .astype(np.int32)).to(dev)
           for _ in range(n_batches)]
    sc = [torch.from_numpy(rng.random(b, dtype=np.float32) * 2.0).to(dev)
          for _ in range(n_batches)]
    records = []

    # ---- level 1: isolated insert ---------------------------------
    arms = {}
    for impl in args.impls:
        cfg = HotSketchConfig(buckets=args.buckets, threshold=500.0,
                              land_impl=impl)

        def step(carry, cfg=cfg):
            st, i = carry
            st, _ = sketch_insert(cfg, st, ids[i % n_batches],
                                  sc[i % n_batches])
            return st, i + 1

        arms[impl] = (step, (init_sketch(cfg, device=dev), 0))
    records.append(_level("insert_us", interleave(
        arms, args.windows, args.steps, lambda c: fence(c[0]))))

    # ---- correctness cross-check: all impls produce identical state
    cfgs = {i: HotSketchConfig(buckets=4096, threshold=50.0, land_impl=i)
            for i in args.impls}
    sts = {i: init_sketch(cfgs[i], device=dev) for i in args.impls}
    for k in range(4):
        for i in args.impls:
            sts[i], _ = sketch_insert(cfgs[i], sts[i], ids[k][:8192],
                                      sc[k][:8192])
    ref = sts[args.impls[0]]
    differ = []
    for i in args.impls[1:]:
        same = all(torch.equal(sts[i][f], ref[f]) for f in FIELDS)
        line = {"level": "equal_state", "impl": i, "equal": same}
        print(json.dumps(line), flush=True)
        records.append(line)
        if not same:
            differ.append(i)
    if differ:
        raise AssertionError(f"landing arms {differ} give another sketch "
                             f"state than {args.impls[0]!r}")

    # ---- level 2: the headline train step per impl -----------------
    if args.skip_level2:
        return records
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.data import make_criteo_batches
    from cafe_tpu_torch.train import build_all

    train_data, batches = make_criteo_batches(n_batches=8, device=dev)
    arms2 = {}
    for impl in args.impls:
        cfg = Config(dataset="criteo", model="dlrm", embedding_dim=16,
                     compress_method="cafe", compress_rate=0.001,
                     cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                     mini_batch_size=2048, learning_rate=0.1,
                     optimizer="sgd", bf16=True, cafe_insert_interval=1,
                     cafe_land_impl=impl)
        _, _, state, train_step, _ = build_all(cfg, train_data, device=dev)

        def step(carry, train_step=train_step):
            st, i = carry
            st, _ = train_step(st, *batches[i % len(batches)])
            return st, i + 1

        arms2[impl] = (step, (state, 0))
    records.append(_level("cafe_step_us", interleave(
        arms2, args.windows, args.steps, lambda c: fence(c[0]))))
    return records


def main(argv=None) -> int:
    args = parse_args(argv)
    # a hang leaves a stack: kill -USR1 <pid> prints all threads
    faulthandler.register(signal.SIGUSR1)
    faulthandler.dump_traceback_later(1200, exit=True)
    try:
        run(args)
    except AssertionError as e:
        print(json.dumps({"error": str(e)}), flush=True)
        return 1
    finally:
        faulthandler.cancel_dump_traceback_later()
    return 0


if __name__ == "__main__":
    sys.exit(main())
