#!/usr/bin/env python3
"""Interleaved A/B of the hot path's four design decisions, for the
PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/ab_decisions.py: the same decisions, protocol and JSON lines.

  1. donate_state: off vs on — build_multi_step(step, 8, donate=...) at
     the headline config (DLRM + CAFE, dim 16, cr 1e-3, bf16 towers, SGD,
     batch 2048 over Criteo-Kaggle's 26 vocabularies);
  2. migration-lane cap: cafe_mig_lanes 256 vs 1 << 26 at the CriteoTB
     towers, dim 128, cr 0.1 (the migration's gather and scatter scale
     with the lanes; a 3.2M-row table, so K2 applies the SGD update);
  3. the sortless sketch insert vs a sorted pre-combine (one stable
     argsort and seg_sum over the m lanes) feeding the same insert:
     65,536 buckets x 4 cells, 53,248 u^4-skewed ids;
  4. row gather: torch_gather (table[ids]) vs pallas_gather, kernel K4
     (kernels/gather.py, the port of ops/pallas_gather.py; the arm keeps
     the name of the kernel it replaces), 53,248 random rows of a
     4,194,304 x 128 f32 table.

Protocol: every arm of a decision is built and warmed (10 runs) first,
then timed in INTERLEAVED windows (A, B, A, B, ...) within one process,
so every arm samples the same host load; each window ends with the
port's fence (a device synchronize). The arms build eager steps
(build_all(..., capture=False)), not the CUDA graphs the port replays
by default, so decision 1 compares donation alone. Eager steps are
mostly launch cost: compare arms only by their medians within one run.

    python3 tools/ab_decisions_torch.py [--decisions 1 2 3 4] [--windows 5]
        [--steps 120] [--device cuda]

Prints one JSON line per decision, or {"decision", "error"} for one that
failed; exits non-zero if any failed.
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

WINDOWS = 5
STEPS = 120
BATCH = 2048      # bench.py:78
DISPATCH_K = 8    # bench.py:86
WARMUP = 10


def interleave(arms, windows, steps, fence):
    """arms: {name: (run_one_step, initial_carry)}; run_one_step(carry) ->
    carry, fenced at each window end. Returns {name: [window_us_per_step,
    ...]} measured A, B, A, B, ... after WARMUP runs of every arm."""
    carries = {k: c for k, (_, c) in arms.items()}
    for name, (run, _) in arms.items():
        for _ in range(WARMUP):
            carries[name] = run(carries[name])
        fence(carries[name])
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


def report(decision, arms_us, note=""):
    meds = {k: float(np.median(v)) for k, v in arms_us.items()}
    spread = {k: [round(min(v), 1), round(max(v), 1)]
              for k, v in arms_us.items()}
    ks = list(meds)
    line = {
        "decision": decision,
        "median_us_per_step": {k: round(v, 1) for k, v in meds.items()},
        "window_spread_us": spread,
        "ratio": round(meds[ks[1]] / meds[ks[0]], 3) if len(ks) == 2 else None,
        "note": note,
    }
    print(json.dumps(line), flush=True)
    return line


def headline_config(**kw):
    from cafe_tpu_torch.config import Config
    base = dict(dataset="criteo", model="dlrm", embedding_dim=16,
                compress_method="cafe", compress_rate=0.001,
                cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                mini_batch_size=BATCH, learning_rate=0.1, optimizer="sgd",
                bf16=True)
    base.update(kw)
    return Config(**base)


def decision_donate(windows, steps=STEPS, device="cuda", batch=BATCH,
                    n_batches=16, k=DISPATCH_K):
    """1. donate_state off vs on through build_multi_step (k steps a
    dispatch); off clones the incoming state once a dispatch."""
    from cafe_tpu_torch.data import make_criteo_batches
    from cafe_tpu_torch.train import build_all, build_multi_step
    from cafe_tpu_torch.utils.timing import fence

    train_data, batches = make_criteo_batches(batch=batch,
                                              n_batches=n_batches,
                                              device=device)
    fused = []
    for i in range(0, len(batches) - k + 1, k):
        grp = batches[i:i + k]
        fused.append(tuple(torch.cat([g[j] for g in grp]) for j in range(3))
                     + (k * batch,))
    arms = {}
    for name, donate in (("donate_off", False), ("donate_on", True)):
        cfg = headline_config(mini_batch_size=batch, donate_state=donate)
        _, _, state, step, _ = build_all(cfg, train_data, device=device,
                                         capture=False)
        multi = build_multi_step(step, k, donate=donate)

        def run(carry, multi=multi):
            st, i = carry
            st, _ = multi(st, *fused[i % len(fused)])
            return (st, i + 1)

        arms[name] = (run, (state, 0))
    us = interleave(arms, windows, max(steps // k, 1), fence)
    return report("donate_state", us, f"us per {k}-step dispatch, batch "
                                      f"{batch}")


def decision_migration_cap(windows, steps=STEPS, device="cuda", batch=BATCH,
                           n_batches=8, dataset="criteotb", dim=128,
                           compress_rate=0.1):
    """2. cafe_mig_lanes 256 (capped, lossless revert) vs uncapped at the
    CriteoTB towers, dim 128, cr 0.1."""
    from cafe_tpu_torch.data import make_criteo_batches
    from cafe_tpu_torch.train import build_all
    from cafe_tpu_torch.utils.timing import fence

    train_data, batches = make_criteo_batches(batch=batch,
                                              n_batches=n_batches,
                                              device=device)
    arms = {}
    for name, lanes in (("cap_256", 256), ("uncapped", 1 << 26)):
        cfg = headline_config(dataset=dataset, embedding_dim=dim,
                              compress_rate=compress_rate,
                              mini_batch_size=batch, cafe_mig_lanes=lanes)
        _, _, state, step, _ = build_all(cfg, train_data, device=device,
                                         capture=False)

        def run(carry, step=step):
            st, i = carry
            st, _ = step(st, *batches[i % len(batches)])
            return (st, i + 1)

        arms[name] = (run, (state, 0))
    us = interleave(arms, windows, steps, fence)
    return report("migration_lane_cap", us,
                  f"full train step, dim {dim} cr={compress_rate}, batch "
                  f"{batch}")


def decision_sortless_insert(windows, steps=STEPS, device="cuda",
                             buckets=1 << 16, lanes=2048 * 26, n_batches=8):
    """3. the sortless insert vs one stable argsort + seg_sum pre-combine
    of duplicate ids feeding the same insert."""
    from cafe_tpu_torch.device import resolve_device
    from cafe_tpu_torch.ops.sorted_update import seg_sum
    from cafe_tpu_torch.sketch.hotsketch import (INVALID_ID, HotSketchConfig,
                                                 init_sketch, sketch_insert)
    from cafe_tpu_torch.utils.timing import fence

    dev = resolve_device(device)
    cfg = HotSketchConfig(buckets=buckets, cells=4, threshold=500.0)
    state0 = init_sketch(cfg, device=dev)
    rng = np.random.default_rng(0)
    m = lanes
    idb = [torch.from_numpy(((rng.random(m) ** 4.0) * 33_762_577)
                            .astype(np.int32)).to(dev)
           for _ in range(n_batches)]
    scb = [torch.from_numpy(rng.random(m).astype(np.float32)).to(dev)
           for _ in range(n_batches)]

    def sortless(st, ids, sc):
        return sketch_insert(cfg, st, ids, sc)[0]

    def sorted_precombine(st, ids, sc):
        order = torch.argsort(ids, stable=True)
        sid, ssc = ids[order], sc[order]
        first = torch.ones_like(sid, dtype=torch.bool)
        first[1:] = sid[1:] != sid[:-1]
        seg = torch.cumsum(first.long(), 0) - 1
        tot = seg_sum(ssc, seg, m)
        uids = torch.where(first, sid, int(INVALID_ID))
        usc = torch.where(first, tot[seg], 0.0)
        return sketch_insert(cfg, st, uids, usc)[0]

    arms = {}
    for name, fn in (("sortless", sortless), ("sorted", sorted_precombine)):
        def run(carry, fn=fn):
            st, i = carry
            return (fn(st, idb[i % n_batches], scb[i % n_batches]), i + 1)
        arms[name] = (run, (state0, 0))
    us = interleave(arms, windows, steps, fence)
    return report("sortless_insert", us,
                  f"insert of {m} zipf ids, {buckets // 1024}K buckets x 4 "
                  f"cells")


def decision_pallas_gather(windows, steps=STEPS, device="cuda", rows=1 << 22,
                           dim=128, lanes=53_248, tile=256):
    """4. table[ids] vs kernel K4 on random rows of an f32 table. The
    table is drawn on the device from a seeded torch.Generator: numpy's
    normal of 2^29 values costs seconds of host time, and a gather's time
    does not depend on the values."""
    from cafe_tpu_torch.device import resolve_device
    from cafe_tpu_torch.kernels.gather import gather
    from cafe_tpu_torch.utils.timing import fence

    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(1)
    table = torch.randn((rows, dim), generator=gen, device=dev)
    rng = np.random.default_rng(1)
    idb = [torch.from_numpy(rng.integers(0, rows, lanes).astype(np.int32))
           .to(dev) for _ in range(8)]

    def torch_step(acc, ids):
        return acc + table[ids].sum()

    def kernel_step(acc, ids):
        return acc + gather(table, ids, tile).sum()

    arms = {}
    for name, fn in (("torch_gather", torch_step),
                     ("pallas_gather", kernel_step)):
        def run(carry, fn=fn):
            acc, i = carry
            return (fn(acc, idb[i % len(idb)]), i + 1)
        arms[name] = (run, (torch.zeros((), device=dev), 0))
    us = interleave(arms, windows, steps, fence)
    return report("pallas_gather", us,
                  f"{lanes} random rows of a {rows}x{dim} f32 table")


DECISIONS = {1: decision_donate, 2: decision_migration_cap,
             3: decision_sortless_insert, 4: decision_pallas_gather}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--decisions", nargs="*", type=int,
                    default=[1, 2, 3, 4])
    ap.add_argument("--windows", type=int, default=WINDOWS)
    ap.add_argument("--steps", type=int, default=STEPS,
                    help="steps per window (shrink for smoke tests)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    failed = []
    for d in args.decisions:
        try:
            DECISIONS[d](args.windows, steps=args.steps, device=args.device)
        except Exception as e:  # report it, run the other decisions
            failed.append(d)
            print(json.dumps({"decision": d, "error": repr(e)}), flush=True)
        torch.cuda.empty_cache()      # a no-op where CUDA never started
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
