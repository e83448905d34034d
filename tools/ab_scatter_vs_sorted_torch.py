#!/usr/bin/env python3
"""Interleaved A/B: scatter writes against the sorted full-table pass, for
the PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/ab_scatter_vs_sorted.py: the same shapes, arms B and C, and
printout.

  null               the chain harness alone (nothing per rep)
  B1/B2              apply_rows (sgd and adagrad) at the CAFE table shape
                     (27,136 x 16, 53,248 lanes): ops/sorted_update's
                     full-table pass (apply27k_pass_*) against
                     ops/sparse.apply_rows(table_pass=False), the
                     dedup-first scatter (apply27k_scat_*)
  C1/C2              the big-table scatter (2,000,000 x 16; sgd) against
                     the null arm

Arms A1/A2 (the sketch insert, round 4 against the round-3 design
checked out of the JAX package's git history) have no counterpart: the
port has no round-3 design. tools/ab_insert_land_torch.py's landing
arms are the port's insert A/B; the tool prints that.

`--sparse_apply_impl` sets apply_rows' route as main.py's flag does
(auto: the JAX tool's module default; dense: SGD into a table of at most
6 MiB takes kernel K3, kernels/rowsum.py). Every arm runs eager, each
window `--reps` chained calls ended by a device synchronize: the
adagrad scatter keeps its rows through a boolean mask (a shape that
depends on the data), so it cannot be captured, and all arms are timed
in one mode.

    python3 tools/ab_scatter_vs_sorted_torch.py [--reps 30] [--windows 5]
        [--sparse_apply_impl auto|dense] [--device cuda]
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
from cafe_tpu_torch.ops import sorted_update, sparse  # noqa: E402
from cafe_tpu_torch.utils.timing import fence  # noqa: E402

B = 53248          # 2048 batch x 26 fields
NTAB = 27136       # bench-protocol cafe table rows
NBIG = 2_000_000   # stand-in for the full-table shape (lane-bound anyway)
D = 16
NO_COUNTERPART = {
    "insert_r4_scatterfree / insert_r3_scatter":
        "the JAX tool checks the round-3 sketch insert out of git; the port "
        "has no round-3 design: tools/ab_insert_land_torch.py's landing "
        "arms are its insert A/B"}


def inputs(dev, b=B, ntab=NTAB, nbig=NBIG, d=D, seed=0):
    """The JAX tool's arrays (its draws in its order; the sketch ids and
    scores it draws first are not used here)."""
    rng = np.random.default_rng(seed)
    rng.random(b)                                   # the insert's ids
    rng.random(b)                                   # and scores
    ridx = rng.integers(0, ntab, b).astype(np.int32)
    bigidx = rng.integers(0, nbig, b).astype(np.int32)
    grad = (rng.standard_normal((b, d)).astype(np.float32) * .01)
    tab = rng.standard_normal((ntab, d)).astype(np.float32)
    return {k: torch.from_numpy(v).to(dev) for k, v in
            (("ridx", ridx), ("bigidx", bigidx), ("grad", grad),
             ("tab", tab))}


def b_arms(x, impl="auto", lr=0.05):
    """{name: fn(table, slots) -> (table, slots)} for arms B1 / B2."""
    out = {}
    for opt in ("sgd", "adagrad"):
        out[f"apply27k_pass_{opt}"] = (
            lambda t, sl, o=opt: sorted_update.apply_rows_pass(
                t, sl, x["ridx"], x["grad"], lr, o))
        out[f"apply27k_scat_{opt}"] = (
            lambda t, sl, o=opt: sparse.apply_rows(
                t, sl, x["ridx"], x["grad"], lr, o, impl=impl,
                table_pass=False))
    return out


def run(reps=30, windows=5, device="cuda", impl="auto", nbig=NBIG
        ) -> dict:
    dev = resolve_device(device)
    for arms, why in NO_COUNTERPART.items():
        print(json.dumps({"arms": arms, "no_counterpart": why}), flush=True)
    x = inputs(dev, nbig=nbig)
    big = torch.zeros((nbig, D), device=dev)

    variants = {"null": (lambda c: c, (x["tab"],))}
    for name, fn in b_arms(x, impl).items():
        opt = name.rsplit("_", 1)[1]
        tab = x["tab"].clone()
        variants[name] = (lambda c, fn=fn: fn(*c),
                          (tab, sparse.init_slots(tab, opt)))
    variants["applyBIG_scat_sgd"] = (
        lambda c: (sparse.apply_rows(c[0], {}, x["bigidx"], x["grad"], 0.05,
                                     "sgd", impl=impl, table_pass=False)[0],),
        (big,))

    def chain(step, carry):
        for _ in range(reps):
            carry = step(carry)
        return carry

    print("compiling...", flush=True)
    carries = {}
    for name, (step, carry) in variants.items():
        carries[name] = chain(step, carry)
        fence(carries[name])
    print("running...", flush=True)
    results = {k: [] for k in variants}
    for _ in range(windows):
        for name, (step, _) in variants.items():
            t0 = time.perf_counter()
            carries[name] = chain(step, carries[name])
            fence(carries[name])
            results[name].append((time.perf_counter() - t0) / reps * 1e6)
    print(f"\nus per op (median of {windows} interleaved windows, "
          f"{reps} reps each):")
    for name, times in results.items():
        med = float(np.median(times))
        print(f"  {name:28s} {med:9.1f} us   "
              f"(min {min(times):.1f} max {max(times):.1f})")
    return {"median_us": {k: float(np.median(v)) for k, v in results.items()},
            "windows_us": results, "reps": reps, "sparse_apply_impl": impl,
            "graphed": False,
            "device": device_name(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--sparse_apply_impl", default="auto",
                    choices=["auto", "dense"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.reps, args.windows, args.device, args.sparse_apply_impl)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
