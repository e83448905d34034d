#!/usr/bin/env python3
"""The reference's latency protocol at CriteoTB shapes, for the PyTorch /
CUDA port (cafe_tpu_torch; no jax). Port of tools/latency_grid.py: the
same configuration, protocol and JSON record.

Reference: tasks/latency.json + main.py:420-447 — train ms/it at batch
2048 and test ms/it at batch 16,384, CriteoTB towers (dim 128), cr 0.1,
methods hash, qr, mde, ada, cafe (full does not fit the reference's GPU
and is left out there too). CriteoTB's raw data is not in the repo: the
stream is Criteo-Kaggle's 26 vocabularies (sum 33.76 M) under the
CriteoTB towers, so the shapes that set memory and time (table rows x
dim 128, 26 fields x 2048 lanes) are the protocol's.

Timing: windows of `--steps` train steps, then max(steps // 8, 8) eval
calls, each ended by a device synchronize; the record holds the median
of the windows. Before them the train step is warmed with WARMUP steps
and the eval step with WARMUP_CALLS + 1 calls, so on the card both have
been captured before the first window. The steps replay CUDA graphs where
train/step.capture_blockers allows (every method on one card; AdaEmbed's
check steps run eagerly on its graph's state). Besides the JAX record's keys each record
holds "device", "graphed", the steps it trained, each kernel's launches
in them (K1-K5, train/capture counting a replay's) and the method's own
peak allocated bytes. `--boards DIR` also writes DIR/<method>/latency.json
for cafe_tpu_torch.tools.visualization.plot_latency.

    python3 tools/latency_grid_torch.py [--out FILE] [--methods ...]
        [--steps 200] [--windows 5] [--boards DIR] [--device cuda]
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import os.path as osp
import sys
import time

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.config import Config  # noqa: E402
from cafe_tpu_torch.data.criteo import make_criteo_batches  # noqa: E402
from cafe_tpu_torch.device import device_name, resolve_device  # noqa
from cafe_tpu_torch.kernels import KERNELS  # noqa: E402
from cafe_tpu_torch.train import build_all  # noqa: E402
from cafe_tpu_torch.train.capture import WARMUP_CALLS  # noqa: E402
from cafe_tpu_torch.utils.timing import fence  # noqa: E402

TRAIN_BATCH = 2048
TEST_BATCH = 16384
METHODS = ["hash", "qr", "mde", "ada", "cafe"]
WARMUP = 10


def grid_config(method: str, batch: int = TRAIN_BATCH, **kw) -> Config:
    """tools/latency_grid.py:56-62's configuration."""
    return Config(dataset="criteotb", model="dlrm", embedding_dim=128,
                  compress_method=method, compress_rate=0.1,
                  cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                  mini_batch_size=batch, learning_rate=1.0,
                  optimizer="sgd", bf16=True, **kw)


def eval_batches(train_data, device, n: int = 2, batch: int = TEST_BATCH):
    """`n` eval batches of `batch` rows drawn from the train rows (seed 1),
    as the JAX tool draws them."""
    rng = np.random.default_rng(1)
    out = []
    for _ in range(n):
        idx = rng.integers(0, len(train_data.sparse), batch)
        out.append((torch.from_numpy(train_data.dense[idx]).to(device),
                    torch.from_numpy(train_data.sparse[idx]).to(device)))
    return out


def run_method(method, train_data, batches, tb, steps, windows, device,
               cfg=None):
    """One method through the protocol. Returns (record, embed, state):
    the caller may check the launches against the layer's apply routes
    before it drops them."""
    dev = resolve_device(device)
    cfg = cfg or grid_config(method)
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(dev)
        before = torch.cuda.memory_allocated(dev)
    for k in KERNELS.values():
        k.launches = 0
    t0 = time.time()
    _, embed, state, train_step, eval_step = build_all(cfg, train_data,
                                                       device=dev)
    # warm-up: on the card each step makes its WARMUP_CALLS eager calls
    # and its capture here, so every timed call replays a graph
    for i in range(WARMUP):
        state, m = train_step(state, *batches[i % len(batches)])
    fence(state, m)
    for i in range(WARMUP_CALLS + 1):
        p = eval_step(state, *tb[i % len(tb)])
    fence(p)
    for step in (train_step, eval_step):
        if getattr(step, "graphed", False) and not step.replays:
            raise AssertionError(f"latency_grid {method}: a graphed step "
                                 f"was not captured in its warm-up")
    build_s = time.time() - t0

    n_eval = max(steps // 8, 8)
    tr_ms, te_ms = [], []
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(steps):
            state, m = train_step(state, *batches[i % len(batches)])
        fence(state, m)
        tr_ms.append((time.perf_counter() - t0) / steps * 1e3)
        t0 = time.perf_counter()
        for i in range(n_eval):
            p = eval_step(state, *tb[i % len(tb)])
        fence(p)
        te_ms.append((time.perf_counter() - t0) / n_eval * 1e3)
    loss = float(m["loss"])
    tr, te = float(np.median(tr_ms)), float(np.median(te_ms))
    rec = {
        "method": method, "dim": cfg.embedding_dim, "cr": cfg.compress_rate,
        "train_ms_per_it": round(tr, 3), "test_ms_per_it": round(te, 3),
        "train_batch": cfg.mini_batch_size, "test_batch": tb[0][1].shape[0],
        "examples_per_s": round(cfg.mini_batch_size / tr * 1e3),
        "windows": windows, "build_s": round(build_s, 1),
        "table_rows": embed.memory_rows(),
        "device": device_name(dev),
        "graphed": bool(getattr(train_step, "graphed", False)),
        "eval_graphed": bool(getattr(eval_step, "graphed", False)),
        "capture_blockers": list(getattr(train_step, "capture_blockers",
                                         [])),
        "train_ms_windows": tr_ms, "test_ms_windows": te_ms,
        "train_steps": WARMUP + windows * steps,
        "eval_calls": WARMUP_CALLS + 1 + windows * n_eval,
        "launches": {name: k.launches for name, k in KERNELS.items()},
        "loss": loss,
        "peak_allocated_bytes": (
            torch.cuda.max_memory_allocated(dev) - before
            if dev.type == "cuda" else None),
    }
    return rec, embed, state


def latency_board(rec) -> dict:
    """The dict visualization.plot_latency reads: {"train": ms, "test": ms}."""
    return {"train": rec["train_ms_per_it"], "test": rec["test_ms_per_it"]}


def write_record(rec, out="", boards="") -> None:
    """Print `rec`; append it to `out` and write its latency.json under
    `boards` where they are given."""
    print(json.dumps(rec), flush=True)
    if out:
        with open(out, "a") as f:
            f.write(json.dumps(rec) + "\n")
    if boards:
        bdir = osp.join(boards, rec["method"])
        os.makedirs(bdir, exist_ok=True)
        with open(osp.join(bdir, "latency.json"), "w") as f:
            json.dump(latency_board(rec), f)


def run_grid(methods, train_data, batches, tb, steps, windows, device,
             out="", boards="", on_method=None, config=grid_config) -> list:
    """Each method through the protocol on the given data; returns the
    records. `config(method)` gives its Config. `on_method(rec, embed,
    state)` sees each method's layer and state before they are dropped."""
    if out:
        os.makedirs(osp.dirname(out) or ".", exist_ok=True)
    records = []
    for method in methods:
        rec, embed, state = run_method(method, train_data, batches, tb,
                                       steps, windows, device,
                                       config(method))
        if on_method is not None:
            on_method(rec, embed, state)
        del embed, state
        write_record(rec, out, boards)
        records.append(rec)
    return records


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="",
                    help="append one JSON line a method to this file")
    ap.add_argument("--methods", nargs="+", default=METHODS)
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--boards", default="",
                    help="also write <boards>/<method>/latency.json for "
                         "visualization.plot_latency")
    ap.add_argument("--device", default="cuda")
    return ap.parse_args(argv)


def main(argv=None, on_method=None) -> list:
    """Run the grid at the protocol's shapes; returns the records."""
    args = parse_args(argv)
    dev = resolve_device(args.device)
    train_data, batches = make_criteo_batches(batch=TRAIN_BATCH,
                                              n_batches=8, device=dev)
    tb = eval_batches(train_data, dev)
    return run_grid(args.methods, train_data, batches, tb, args.steps,
                    args.windows, dev, args.out, args.boards, on_method)


if __name__ == "__main__":
    main()
