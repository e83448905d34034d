#!/usr/bin/env python3
"""Interleaved A/B of sparse-apply implementations at CriteoTB shapes, for
the PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/ab_apply128.py: the same shapes, protocol and JSON lines.

The dim-128 protocol's apply adds 53,248 update rows into a 3.4 M-row x
128 f32 table. Arms (each keeps the name of the JAX tool's arm it
stands for):

  scatter          table.index_add(0, ids, upd): a fresh output table
                   each call, as the JAX scatter writes a new buffer
  scatter_donated  table.index_add_(0, ids, upd): in place, as the
                   donated JAX scatter aliases its input
  pallas           K2, kernels/scatter_add.scatter_add_ (the port of
                   ops/pallas_apply.pallas_scatter_add), in place

K2 takes no launch setting (its grid follows the lanes), so the JAX
tool's `pallas512` arm (the Pallas kernel at tile 512) has no
counterpart; the tool prints that. Numerics are checked first on a small
case with a heavy duplicate group, against numpy's np.add.at. Then each
level times every arm in interleaved windows (the median of the windows, us a
call), at the CriteoTB shape and again at the dim-16 bench shape. Where
the JAX tool dispatches a jitted call, a window here replays one CUDA
graph of `--steps` chained calls on the card (tools/compiled_call_torch;
each arm's eager calls before it warm it), ended by a device
synchronize, so no arm pays a host launch a call; on the CPU the chain
runs eagerly.

    python3 tools/ab_apply128_torch.py [--windows 5] [--steps 30]
        [--lanes 53248] [--device cuda]
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
from cafe_tpu_torch.kernels import scatter_add  # noqa: E402
from cafe_tpu_torch.utils.timing import fence  # noqa: E402
from tools.compiled_call_torch import compiled_call  # noqa: E402

ARMS = ("scatter", "scatter_donated", "pallas")
NO_COUNTERPART = {"pallas512": "K2 takes no tile: its grid follows the "
                               "lanes, so the Pallas kernel's tile-512 "
                               "variant has no counterpart"}
LEVELS = (("us_criteotb", 3376453, 128), ("us_dim16", 33792, 16))
NUMERICS_TOL = 1e-3


def arm_fns():
    return {
        "scatter": lambda t, i, u: t.index_add(0, i, u),
        "scatter_donated": lambda t, i, u: t.index_add_(0, i, u),
        "pallas": lambda t, i, u: scatter_add.scatter_add_(t, i, u),
    }


def numerics(dev, rng=None) -> dict:
    """K2 on a small case with a heavy duplicate group against np.add.at."""
    rng = rng or np.random.default_rng(0)
    n, d, b = 4096, 128, 8192
    tbl = rng.normal(0, 1, (n, d)).astype(np.float32)
    ids = rng.integers(0, n, b).astype(np.int32)
    ids[: b // 4] = ids[0]
    upd = rng.normal(0, 0.01, (b, d)).astype(np.float32)
    want = tbl.copy()
    np.add.at(want, ids, upd)
    got = scatter_add.scatter_add_(
        torch.from_numpy(tbl).to(dev), torch.from_numpy(ids).to(dev),
        torch.from_numpy(upd).to(dev)).cpu().numpy()
    err = float(np.abs(got - want).max())
    return {"level": "numerics", "max_abs_err": err,
            "pass": bool(err < NUMERICS_TOL)}


def level_inputs(n_rows, dim, lanes, dev, rng):
    """(table, 4 id arrays, 4 update arrays) of one level, as the JAX tool
    draws them (ids skewed toward the table's first rows)."""
    gen = torch.Generator(device=dev).manual_seed(0)
    tbl0 = torch.randn((n_rows, dim), generator=gen, device=dev)
    idss = [torch.from_numpy(((rng.random(lanes) ** 2) * n_rows)
                             .astype(np.int32)).to(dev) for _ in range(4)]
    upds = [torch.from_numpy(rng.normal(0, 1e-4, (lanes, dim))
                             .astype(np.float32)).to(dev) for _ in range(4)]
    return tbl0, idss, upds


def bench_case(label, n_rows, dim, lanes, windows, steps, dev, rng):
    """One level: every arm's chain of `steps` calls on its own copy of
    the table (compiled_call), timed in `windows` interleaved windows."""
    tbl0, idss, upds = level_inputs(n_rows, dim, lanes, dev, rng)
    fns = arm_fns()
    chains = {}
    for name in ARMS:
        held = [tbl0.clone()]

        def chain(fn=fns[name], held=held):
            t = held[0]
            for k in range(steps):
                t = fn(t, idss[k % 4], upds[k % 4])
            return t
        chains[name] = compiled_call(chain, dev)
        fence(chains[name]())
    del tbl0
    out = {k: [] for k in ARMS}
    for _ in range(windows):
        for name in ARMS:
            t0 = time.perf_counter()
            fence(chains[name]())
            out[name].append((time.perf_counter() - t0) / steps * 1e6)
    med = {k: round(float(np.median(v)), 1) for k, v in out.items()}
    return {"level": label, "lanes": lanes, "rows": n_rows, "dim": dim,
            **med, "windows_us": out,
            "graphed": all(c.graphed for c in chains.values())}


def run(windows=5, steps=30, lanes=53248, device="cuda", levels=LEVELS
        ) -> list:
    dev = resolve_device(device)
    name = device_name(dev)
    for arm, why in NO_COUNTERPART.items():
        print(json.dumps({"arm": arm, "no_counterpart": why}), flush=True)
    num = {**numerics(dev), "device": name}
    print(json.dumps(num), flush=True)
    if not num["pass"]:
        raise SystemExit("scatter_add_ numerics mismatch")
    rng = np.random.default_rng(0)
    lines = [num]
    for label, n_rows, dim in levels:
        rec = {**bench_case(label, n_rows, dim, lanes, windows, steps, dev,
                            rng), "device": name}
        print(json.dumps(rec), flush=True)
        lines.append(rec)
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return lines


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--windows", type=int, default=5)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--lanes", type=int, default=53248)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.windows, args.steps, args.lanes, args.device)


if __name__ == "__main__":
    main()
