"""Serving-path time of the PyTorch port: f32 against int8 and int4 tables
at the test protocol (the twin of tools/serving_bench.py: its
configuration and JSON line, plus the int4 arm and "device").

    python tools/serving_bench_torch.py [--windows 5] [--steps 40] \\
        [--device cpu] [--test_batch 16384] [--dim 128] ...

The configuration is the JAX tool's: DLRM with CriteoTB towers over
Criteo-Kaggle's 26 vocabularies, CAFE at cr 0.1, threshold 500, hash
rate 0.5, dim 128, bf16 towers, four train steps of 2048 from
make_criteo_batches (so the sketch routes some ids hot), then eval
batches of 16,384 rows (425,984 lookups over 26 fields). The f32 eval
step and the quantized ones (train/step.build_quantized_eval_step) run
in alternating windows of `--steps` calls, each window ended by a
synchronize; on the card every eval step replays a CUDA graph. Besides
the times the line holds each arm's table bytes (the f32 table against
the codes) and the mean |p_f32 - p_q| on one batch; on the card also
each arm's device time a call under torch.profiler and its largest
kernels. The int8 and int4 steps route CAFE's ids through the packed
sketch view frozen at quantize time (CafePart.quantize_for_serving,
"view_bytes"); the `int8_plain` arm is the int8 step with that view
taken out, routing through the sketch as the f32 step does (the same
scores, checked), the A/B of the two routes.

`--max_ind_range N` takes every id modulo N (a CPU-sized run); the
other flags set the configuration. jax-free; defaults to the card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

from cafe_tpu_torch.config import Config  # noqa: E402
from cafe_tpu_torch.data import CTRArrays, make_criteo_batches  # noqa
from cafe_tpu_torch.device import resolve_device  # noqa: E402
from cafe_tpu_torch.ops.quantized import QuantizedTable  # noqa: E402
from cafe_tpu_torch.train import (build_all,  # noqa: E402
                                  build_quantized_eval_step)
from cafe_tpu_torch.utils.timing import fence  # noqa: E402

TEST_BATCH = 16384
ARMS = ("fp32", "int8", "int4", "int8_plain")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--dim", type=int, default=128)
    ap.add_argument("--compress_rate", type=float, default=0.1)
    ap.add_argument("--learning_rate", type=float, default=1.0)
    ap.add_argument("--dataset", default="criteotb",
                    help="criteotb: the CriteoTB towers; criteo: Kaggle's")
    ap.add_argument("--test_batch", type=int, default=TEST_BATCH)
    ap.add_argument("--max_ind_range", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="")
    return ap.parse_args(argv)


def _tables(qtables) -> list:
    """(part key, table key, QuantizedTable) of a quantized step's
    tables; a CAFE part's frozen sketch view (sk_packed) is routing
    state, not a table."""
    return [(pk, key, qt) for pk, part in qtables.items()
            for key, qt in part.items() if isinstance(qt, QuantizedTable)]


def profile_calls(run, arm, calls=5, top=6) -> dict:
    """Device busy ms a call of `calls` calls of `arm` under
    torch.profiler, and its `top` kernels by device time (ms a call)."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for i in range(calls):
            run(arm, i)
        torch.cuda.synchronize()
    dev = sorted(((a.key, getattr(a, "self_device_time_total", 0) / 1e3
                   / calls) for a in prof.key_averages()
                  if a.device_type == torch.autograd.DeviceType.CUDA),
                 key=lambda x: -x[1])
    return {"busy_ms_per_call": sum(ms for _, ms in dev),
            "kernels_per_call": sum(
                a.count for a in prof.key_averages()
                if a.device_type == torch.autograd.DeviceType.CUDA) / calls,
            "top": [[k[:80], ms] for k, ms in dev[:top]]}


def main(argv=None) -> dict:
    args = parse_args(argv)
    dev = resolve_device(args.device)
    cfg = Config(dataset=args.dataset, model="dlrm",
                 embedding_dim=args.dim, compress_method="cafe",
                 compress_rate=args.compress_rate,
                 cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                 mini_batch_size=2048, learning_rate=args.learning_rate,
                 optimizer="sgd", bf16=True,
                 max_ind_range=args.max_ind_range)
    train_data, batches = make_criteo_batches(batch=2048, n_batches=4,
                                              device=dev)
    if args.max_ind_range > 0:
        mir = args.max_ind_range
        train_data = CTRArrays(train_data.sparse % mir, train_data.dense,
                               train_data.label, train_data.counts)
        batches = [(d, s % mir, lab, v) for d, s, lab, v in batches]
    model, embed, state, train_step, eval_step = build_all(cfg, train_data,
                                                           device=dev)
    # a few train steps so the sketch routes some ids hot
    for d, s, lab, v in batches:
        state, m = train_step(state, d, s, lab, v)
    fence(state, m)

    rng = np.random.default_rng(1)
    tb = []
    for _ in range(2):
        idx = rng.integers(0, len(train_data.sparse), args.test_batch)
        tb.append((torch.from_numpy(train_data.dense[idx]).to(dev),
                   torch.from_numpy(train_data.sparse[idx]).to(dev)))

    steps = {"fp32": eval_step}
    table_bytes = {}
    for arm, bits in (("int8", 8), ("int4", 4), ("int8_plain", 8)):
        steps[arm] = build_quantized_eval_step(model, embed, state, bits)
        table_bytes[arm] = sum(int(qt.codes.numel())
                               for _, _, qt in _tables(steps[arm].qtables))
    view_bytes = sum(part.pop("sk_packed").numel() * 4
                     for part in steps["int8_plain"].qtables.values()
                     if "sk_packed" in part)
    # the f32 tables that the quantized steps serve from codes
    table_bytes["fp32"] = sum(state.embed[pk][key].numel() * 4
                              for pk, key, _ in _tables(
                                  steps["int8"].qtables))

    def run(arm, i):
        return steps[arm](state, *tb[i % 2])

    # warm-up: on the card 2 eager calls, the capture, then replays
    for arm in ARMS:
        for i in range(4):
            p = run(arm, i)
        fence(p)
    p_f32 = run("fp32", 0).clone()
    mean_abs_diff = {arm: float((run(arm, 0) - p_f32).abs().mean())
                     for arm in ARMS[1:3]}
    routes_equal = all(torch.equal(run("int8", i).clone(),
                                   run("int8_plain", i)) for i in range(2))
    if not routes_equal:
        raise AssertionError("serving_bench: the int8 scores through the "
                             "frozen view differ from the plain route's")

    out = {arm: [] for arm in ARMS}
    for _ in range(args.windows):
        for arm in ARMS:
            t0 = time.perf_counter()
            for i in range(args.steps):
                p = run(arm, i)
            fence(p)
            out[arm].append((time.perf_counter() - t0) / args.steps * 1e3)
    rec = {
        "metric": "serving_test_ms_per_it", "dim": args.dim,
        "test_batch": args.test_batch, "bits": [8, 4],
        **{f"{arm}_ms": float(np.median(out[arm])) for arm in ARMS},
        "windows": out,
        "table_bytes": table_bytes, "view_bytes": view_bytes,
        "routes_equal": routes_equal,
        "mean_abs_diff": mean_abs_diff,
        "graphed": {arm: bool(getattr(steps[arm], "graphed", False))
                    for arm in ARMS},
        "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                   else "cpu"),
    }
    if dev.type == "cuda":
        rec["profile"] = {arm: profile_calls(run, arm) for arm in ARMS}
    print(json.dumps(rec), flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    return rec


if __name__ == "__main__":
    main()
