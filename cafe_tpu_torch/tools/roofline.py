"""Roofline accounting for the embedding hot path (port of
cafe_tpu/tools/roofline.py: the same flags, stages and JSON keys, plus
--device and the "device" key naming where the numbers were taken).

    python -m cafe_tpu_torch.tools.roofline [--device cpu] [--rows N] ...

Measures achieved GB/s for each stage at CriteoTB shapes (dim 128, batch
2048, 26 fields, a 2M-row table) and prints the fraction of the card's
peak memory bandwidth:

  lookup             read B*F rows of dim*4 bytes (table[ids])
  optimizer_apply    ops/sparse.apply_rows, SGD: kernel K2 at these shapes
                     (>= 2^20 rows, dim % 128 == 0); the table is carried
                     from iteration to iteration and updated in place
  optimizer_scatter  ops/sparse.sparse_sgd (index_add_), for comparison;
                     both count the rows read and written once
  sketch_query       B*F bucket lines (3 arrays x cells x 4 bytes)
  sketch_insert      time only (the insert sorts; no byte model)

Clock: each stage runs `iters` eager iterations over per-iteration
distinct ids once to warm up, then again between two CUDA events; the
window's time over `iters` is the stage's time. Launch gaps the host
leaves inside the window count (the "sync" field says so). On the CPU
(--device cpu) the window is timed on the host clock: no device number.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sparse import apply_rows, sparse_sgd
from ..sketch import (HotSketchConfig, init_sketch, sketch_insert,
                      sketch_query)

# H100 SXM data-sheet HBM bandwidth; override with --peak_gbs for other
# cards.
DEFAULT_PEAK_GBS = 3350.0

SYNC_CUDA = "cuda events around a warm window of eager iterations"
SYNC_CPU = "host clock around a warm window on the cpu (not a device time)"


def measure(body, iters: int, dev: torch.device) -> float:
    """Seconds per iteration of `body(i) -> tensor` over a window of
    `iters` iterations, after one warm window (module docstring)."""
    def window():
        acc = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(iters):
            acc = acc + body(i)
        return acc

    if dev.type == "cpu":
        window()
        t0 = time.perf_counter()
        window()
        return (time.perf_counter() - t0) / iters
    window()
    torch.cuda.synchronize(dev)
    start, end = (torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True))
    start.record()
    window()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3 / iters


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--fields", type=int, default=26)
    p.add_argument("--dim", type=int, default=128)
    p.add_argument("--rows", type=int, default=2_000_000)
    p.add_argument("--iters", type=int, default=100)
    p.add_argument("--peak_gbs", type=float, default=DEFAULT_PEAK_GBS)
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)

    dev = resolve_device(args.device)
    b, f, d, rows = args.batch, args.fields, args.dim, args.rows
    iters = args.iters
    n_ids = b * f
    rng = np.random.default_rng(0)
    # values do not change a gather's or a scatter's time: draw the table
    # on the device
    gen = torch.Generator(device=dev).manual_seed(0)
    table = torch.randn((rows, d), generator=gen, device=dev) * 0.1
    # per-iteration-distinct ids, as in the JAX tool
    ids_stack = torch.from_numpy(
        rng.integers(0, rows, (iters, n_ids)).astype(np.int32)).to(dev)
    grads = torch.from_numpy(
        rng.normal(0, 0.1, (n_ids, d)).astype(np.float32)).to(dev)

    results = {}

    # 1. pure gather
    dt = measure(lambda i: table[ids_stack[i]].sum(), iters, dev)
    bytes_moved = n_ids * d * 4
    results["lookup"] = {"ms": round(dt * 1e3, 4),
                         "gbs": round(bytes_moved / dt / 1e9, 1)}

    # 2. optimizer apply (read-modify-write) on a carried table
    bytes_moved = n_ids * d * 4 * 2
    for name, fn in (
            ("optimizer_apply",
             lambda t, i, g: apply_rows(t, {}, i, g, 0.1, "sgd")[0]),
            ("optimizer_scatter",
             lambda t, i, g: sparse_sgd(t, i, g, 0.1))):
        work = table.clone()
        dt = measure(lambda i, fn=fn, work=work:
                     fn(work, ids_stack[i], grads)[0, 0], iters, dev)
        del work
        results[name] = {"ms": round(dt * 1e3, 4),
                         "gbs": round(bytes_moved / dt / 1e9, 1)}

    # 3. sketch query + insert at CAFE cr=0.001 sizing
    cfg = HotSketchConfig(buckets=max(rows // 1000, 1024), threshold=500.0)
    st = init_sketch(cfg, device=dev)
    dt = measure(lambda i: sketch_query(cfg, st, ids_stack[i]).sum()
                 .to(torch.float32), iters, dev)
    bytes_moved = n_ids * cfg.cells * 4 * 3
    results["sketch_query"] = {"ms": round(dt * 1e3, 4),
                               "gbs": round(bytes_moved / dt / 1e9, 1)}

    scores = torch.ones(n_ids, dtype=torch.float32, device=dev)
    dt = measure(lambda i: sketch_insert(cfg, st, ids_stack[i], scores)[0]
                 ["cnt"][0, 0], iters, dev)
    results["sketch_insert"] = {"ms": round(dt * 1e3, 4)}

    for v in results.values():
        if "gbs" in v:
            v["frac_of_peak"] = round(v["gbs"] / args.peak_gbs, 3)
    out = {"shapes": {"batch": b, "fields": f, "dim": d, "table_rows": rows},
           "peak_gbs": args.peak_gbs,
           "sync": SYNC_CUDA if dev.type == "cuda" else SYNC_CPU,
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu"),
           **results}
    print(json.dumps(out, indent=2), flush=True)
    return out


if __name__ == "__main__":
    main()
