#!/usr/bin/env python3
"""Device cost of the CAFE+ adaptive-threshold reset, for the PyTorch /
CUDA port (cafe_tpu_torch; no jax). Port of tools/reset_cost.py: the same
sizes (lim 1,000,000, 53,248 lanes), stream, arms and JSON record.

The reset (`_reset`, a global rank of every candidate cell) runs under
the port's `cond` (utils/cond.py), as the JAX package runs it under
lax.cond: in the CUDA graph each branch is a conditional node, so the
reset runs only on the inserts where real_n > 1.2 lim. The arms, as the
JAX tool's:

  steady_us        the insert with real_n pinned below the trip point
                   (the branch not taken)
  forced_reset_us  the insert with real_n pinned above it, re-pinned
                   every call, so every call takes the reset

per_fire_us is their difference, and the amortisation the JAX tool
prints (at least ceil(0.2 lim / batch) steps between two fires) follows.
One arm more prices what the untaken branch still costs every step:
no_reset_us, the insert with adjust_threshold off (no node at all), and
every_step_overhead = steady_us / no_reset_us - 1. Each arm's insert is
captured in a CUDA graph on the card and timed over `--windows` windows
of 10 replays, each ended by a device synchronize. The fires are
counted, as the JAX tool counts them, over `--stream_steps` inserts of a
fresh Zipf(1.1) stream.

    python3 tools/reset_cost_torch.py [--lim 1000000] [--batch 53248]
        [--vocab 33762577] [--stream_steps 200] [--out FILE] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import math
import os.path as osp
import sys
import time

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.device import device_name, resolve_device  # noqa
from cafe_tpu_torch.sketch.hotsketch_plus import (  # noqa: E402
    CafePlusConfig, init_sketch_plus, sketch_insert_plus)
from cafe_tpu_torch.utils.timing import fence  # noqa: E402
from tools.compiled_call_torch import compiled_call  # noqa: E402

NOTE = ("the port takes the CAFE+ reset under its cond, a conditional "
        "node in the CUDA graph, as the JAX package takes it under "
        "lax.cond: per_fire_us is paid only on the inserts where it fires; "
        "every_step_overhead is what the untaken branch costs a step")


def timed_windows(fn, windows=5, reps=10):
    """Median, min and max us a call over `windows` windows of `reps`
    calls, each window ended by a device synchronize."""
    out = []
    for _ in range(windows):
        t0 = time.perf_counter()
        r = None
        for _ in range(reps):
            r = fn()
        fence(r)
        out.append((time.perf_counter() - t0) / reps * 1e6)
    return float(np.median(out)), float(min(out)), float(max(out))


def count_fires(cfg, st, stream, scores, device):
    """Inserts of each id array of `stream`; a fire is an insert that
    starts above the trip point (real_n > int(1.2 lim)), as the JAX tool
    counts them. Returns (fires, final state)."""
    trip = int(cfg.lim * 1.2)
    fires = 0
    for z in stream:
        before = int(st["real_n"])
        st, _ = sketch_insert_plus(
            cfg, st, torch.from_numpy(z.astype(np.int32)).to(device),
            scores)
        if before > trip:
            fires += 1
    return fires, st


def run(lim=1_000_000, batch=53248, vocab=33_762_577, stream_steps=200,
        windows=5, device="cuda") -> dict:
    dev = resolve_device(device)
    cfg = CafePlusConfig(lim=lim, threshold=50.0)
    st0 = init_sketch_plus(cfg, device=dev)
    cells = cfg.cells * (st0["val1"].shape[0] + st0["val2"].shape[0])
    name = device_name(dev)
    print(f"device: {name}  lim={lim} ({cells/1e6:.1f}M candidate cells)  "
          f"batch={batch}")

    rng = np.random.default_rng(0)
    zipf = np.minimum(rng.zipf(1.1, size=(batch,)), vocab)
    ids = torch.from_numpy(zipf.astype(np.int32)).to(dev)
    scores = torch.from_numpy(rng.random(batch, dtype=np.float32)
                              * 4.0).to(dev)

    # warm the sketch so steady-state isn't an all-empty fast path
    st = st0
    for i in range(8):
        st, _ = sketch_insert_plus(cfg, st, ids + i, scores)
    fence(st)
    # real_n pinned below the trip point: the branch is never taken
    st_cold = {**st, "real_n": torch.zeros_like(st["real_n"])}
    # pinned above it, anew every call: every call takes the reset (a
    # real fire would rebase real_n)
    st_hot = {**st, "real_n": torch.full_like(st["real_n"],
                                              int(cfg.lim * 1.2) + 1)}
    cfg_off = cfg._replace(adjust_threshold=False)
    arms = {
        "steady": compiled_call(
            lambda: sketch_insert_plus(cfg, st_cold, ids, scores)[0], dev),
        "forced": compiled_call(
            lambda: sketch_insert_plus(cfg, st_hot, ids, scores)[0], dev),
        "no_reset": compiled_call(
            lambda: sketch_insert_plus(cfg_off, st_cold, ids, scores)[0],
            dev)}
    steady_us, smin, smax = timed_windows(arms["steady"], windows)
    forced_us, fmin, fmax = timed_windows(arms["forced"], windows)
    no_reset_us, _, _ = timed_windows(arms["no_reset"], windows)
    per_fire_us = forced_us - steady_us

    # worst-case amortization: every lane crosses every step
    min_gap = math.ceil(0.2 * cfg.lim / batch)
    worst_overhead = per_fire_us / (min_gap * steady_us)

    # empirical fire count on a fresh Zipf stream
    stream = [np.minimum(rng.zipf(1.1, size=(batch,)), vocab)
              for _ in range(stream_steps)]
    fires, st = count_fires(cfg, st0, stream, scores, dev)
    fence(st)

    return {
        "lim": lim, "batch": batch,
        "candidate_cells": int(cells),
        "steady_us": round(steady_us, 1),
        "steady_minmax": [round(smin, 1), round(smax, 1)],
        "forced_reset_us": round(forced_us, 1),
        "forced_minmax": [round(fmin, 1), round(fmax, 1)],
        "per_fire_us": round(per_fire_us, 1),
        "worst_case_min_steps_between_fires": min_gap,
        "worst_case_amortized_overhead": round(worst_overhead, 4),
        "zipf_stream_steps": stream_steps,
        "zipf_stream_fires": fires,
        "reset_paid_every_step": False,
        "no_reset_us": round(no_reset_us, 1),
        "every_step_overhead": steady_us / no_reset_us - 1.0,
        "graphed": all(a.graphed for a in arms.values()),
        "device": name, "note": NOTE,
    }


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--lim", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=53248)  # 2048 x 26
    ap.add_argument("--vocab", type=int, default=33_762_577)
    ap.add_argument("--stream_steps", type=int, default=200)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--out", default="")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.lim, args.batch, args.vocab, args.stream_steps,
              args.windows, args.device)
    line = json.dumps(res)
    print(line)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")
    return res


if __name__ == "__main__":
    main()
