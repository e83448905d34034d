#!/usr/bin/env python3
"""Per-stage timing of the train step, for the PyTorch / CUDA port
(cafe_tpu_torch; no jax). Port of tools/step_breakdown.py: the same
grids, arms and printout.

Times the CAFE step against ablations (hash: no sketch or migration;
full: uncompressed tables; `_fwd`: the eval step, no backward or
update) at the bench.py protocol's shapes (batch 2048 over
Criteo-Kaggle's 26 vocabularies) to show where the step goes:

  --shapes criteo    cafe, cafe_iv8 (cafe_insert_interval 8), hash at
                     dim 16, cr 1e-3, and full
  --shapes criteotb  cafe and hash at dim 128, cr 0.1, CriteoTB towers

Modes. Every arm runs eager (build_all(..., capture=False)); on the card
every arm whose step train/step.capture_blockers lets graph runs again
replaying its CUDA graph (all of them: cafe_iv8's skipped inserts are
conditional nodes, utils/cond.cond). `inserts` counts each arm's sketch
inserts that ran under the insert interval's branch (eager, replayed,
and the warm-up's spare run on a clone), which K1 launches once each. Differences are taken within one mode only, so
"sketch+migration overhead" never compares an eager step with a graphed
one. The port's step updates its state in place: the timed train arm
gets a copy (the JAX tool's jax.tree.map(jnp.copy, state)), so the
forward arm reads the built state.

    python3 tools/step_breakdown_torch.py [--shapes criteo|criteotb]
        [--steps 300] [--warmup 20] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import json
import os.path as osp
import sys
import time

import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.config import Config  # noqa: E402
from cafe_tpu_torch.data.criteo import make_criteo_batches  # noqa: E402
from cafe_tpu_torch.device import device_name, resolve_device  # noqa
from cafe_tpu_torch.kernels import KERNELS  # noqa: E402
from cafe_tpu_torch.train import (build_all, build_eval_step,  # noqa: E402
                                  build_train_step)
from cafe_tpu_torch.train.capture import (WARMUP_CALLS,  # noqa: E402
                                          branch_runs)
from cafe_tpu_torch.train.step import clone_state  # noqa: E402
from cafe_tpu_torch.utils.timing import fence  # noqa: E402

BATCH = 2048      # bench.py:78


def grid(shapes: str):
    """(entries, dim, dataset): entries (name, method, cr), the JAX
    tool's grids (tools/step_breakdown.py:61-70)."""
    if shapes == "criteotb":
        return [("cafe", "cafe", 0.1), ("hash", "hash", 0.1)], 128, \
            "criteotb"
    return [("cafe", "cafe", 0.001), ("cafe_iv8", "cafe", 0.001),
            ("hash", "hash", 0.001), ("full", None, 1.0)], 16, "criteo"


def arm_config(name, method, cr, dim, dataset, batch=BATCH, **kw) -> Config:
    return Config(dataset=dataset, model="dlrm", embedding_dim=dim,
                  compress_method=method, compress_rate=cr,
                  cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                  mini_batch_size=batch, learning_rate=0.1,
                  optimizer="sgd", bf16=True,
                  cafe_insert_interval=8 if name.endswith("iv8") else 1,
                  **kw)


def timed(fn, state, batches, steps=300, warmup=20):
    """us a step of fn(state, d, s, l, v) over `steps` steps after
    `warmup`, each run ended by a device synchronize (the port's fence
    over every tensor of the last output)."""
    out = None
    for i in range(warmup):
        out = fn(state, *batches[i % len(batches)])
        state = out[0] if isinstance(out, tuple) else state
    fence(out)
    t0 = time.perf_counter()
    st = state
    for i in range(steps):
        out = fn(st, *batches[i % len(batches)])
        if isinstance(out, tuple):
            st = out[0]
    fence(out)
    return (time.perf_counter() - t0) / steps * 1e6


def print_mode(mode, res, batch=BATCH) -> None:
    """The JAX tool's printout for one mode's results."""
    print(f"== {mode}")
    for k, v in res.items():
        print(f"{k:12s} {v:8.1f} us/step  "
              f"({batch / v * 1e6 / 1e6:.1f}M ex/s)")
    if "cafe" in res and "hash" in res:
        ov = res["cafe"] - res["hash"]
        print(f"sketch+migration overhead: {ov:.1f} us "
              f"({ov / res['cafe'] * 100:.0f}% of cafe step)")
    if "cafe_iv8" in res and "hash" in res:
        ov = res["cafe_iv8"] - res["hash"]
        print(f"  at the bench protocol (insert_interval=8): {ov:.1f} us "
              f"({ov / res['cafe_iv8'] * 100:.0f}% of cafe step)")


def run(shapes="criteo", steps=300, warmup=20, device="cuda", data=None,
        **cfg_kw) -> dict:
    """Every arm of the grid in each mode, on `data` ((train_data,
    batches); default the bench protocol's batches), each arm's Config
    taking `cfg_kw` besides. Returns {"eager": {arm: us}, "graphed": {arm:
    us}, "not_graphed": {name: blockers}, "launches": {name: {kernel:
    n}}, "steps", "warmup", "device"}."""
    dev = resolve_device(device)
    entries, dim, dataset = grid(shapes)
    train_data, batches = data or make_criteo_batches(batch=BATCH,
                                                      device=dev)
    modes = ["eager"] + (["graphed"] if dev.type == "cuda" else [])
    if dev.type == "cuda" and warmup <= WARMUP_CALLS:
        raise ValueError(f"--warmup {warmup}: a graphed arm needs more "
                         f"than {WARMUP_CALLS} calls to capture")
    out = {m: {} for m in modes}
    out.update(not_graphed={}, launches={}, inserts={}, steps=steps,
               warmup=warmup,
               shapes=shapes,
               device=device_name(dev))
    for name, method, cr in entries:
        cfg = arm_config(name, method, cr, dim, dataset, **cfg_kw)
        model, embed, state, train_step, eval_step = build_all(
            cfg, train_data, device=dev, capture=False)
        for k in KERNELS.values():
            k.launches = 0
        runs0 = branch_runs()
        for mode in modes:
            if mode == "graphed":
                train_step = build_train_step(model, embed, cfg)
                eval_step = build_eval_step(model, embed)
                if not train_step.graphed:
                    out["not_graphed"][name] = list(
                        train_step.capture_blockers)
                    continue
            # the step updates its state in place: time it on a copy
            out[mode][name] = timed(train_step, clone_state(state),
                                    batches, steps, warmup)

            def fwd_only(st, d, s, lab, v, eval_step=eval_step):
                return (st, eval_step(st, d, s))
            out[mode][name + "_fwd"] = timed(fwd_only, state, batches,
                                             steps, warmup)
        out["launches"][name] = {n: k.launches for n, k in KERNELS.items()}
        runs = branch_runs()
        out["inserts"][name] = sum(
            runs[k].get("cafe_insert", [0, 0])[1]
            - runs0[k].get("cafe_insert", [0, 0])[1] for k in runs)
        del model, embed, state, train_step, eval_step
        gc.collect()
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return out


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--shapes", choices=["criteo", "criteotb"],
                    default="criteo",
                    help="criteo: dim 16 bench protocol; criteotb: dim 128"
                         " + the big towers at cr=0.1")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--warmup", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    res = run(args.shapes, args.steps, args.warmup, args.device)
    report(res)
    return res


def report(res) -> None:
    """The JAX tool's printout of each mode, then the record."""
    print(f"device: {res['device']}")
    for mode in ("eager", "graphed"):
        if mode in res:
            print_mode(mode, res[mode])
    for name, why in res["not_graphed"].items():
        print(f"{name}: not graphed ({'; '.join(why)})")
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
