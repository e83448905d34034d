#!/usr/bin/env python3
"""Find a robust synthetic config where CAFE's AUC lead over plain hashing
shows at unit-test scale, for the PyTorch / CUDA port (cafe_tpu_torch; no
jax). Port of tools/sweep_cafe_vs_hash.py: the same grid (Zipf {1.2,
1.35} x cr {0.003, 0.01} x threshold {5, 20} x epochs {8, 10}, seeds 7
and 8 a point), split, train_eval and printout.

On the card every step replays a CUDA graph (build_all's default:
CAFE and hash with SGD have no capture blocker); the train batches are
staged on the device once a run, in batch_iterator's order.

    python3 tools/sweep_cafe_vs_hash_torch.py [--points N] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import itertools
import os.path as osp
import sys

import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.config import Config  # noqa: E402
from cafe_tpu_torch.data import (CTRArrays, batch_iterator,  # noqa: E402
                                 make_synthetic_arrays)
from cafe_tpu_torch.device import resolve_device  # noqa: E402
from cafe_tpu_torch.train import build_all, inference  # noqa: E402

GRID = (
    [1.2, 1.35],          # zipf
    [0.003, 0.01],        # cr
    [5.0, 20.0],          # threshold
    [8, 10],              # epochs
)
SEEDS = [7, 8]


def split(data, frac=6 / 7):
    cut = int(len(data) * frac)
    d = data.dense
    return (CTRArrays(data.sparse[:cut], None if d is None else d[:cut],
                      data.label[:cut], data.counts),
            CTRArrays(data.sparse[cut:], None if d is None else d[cut:],
                      data.label[cut:], data.counts))


def staged_batches(train, batch, dev):
    """batch_iterator(train, batch, drop_last=True) on the device."""
    out = []
    for dense, sparse, label, valid in batch_iterator(train, batch,
                                                      drop_last=True):
        out.append((None if dense is None
                    else torch.from_numpy(dense).to(dev),
                    torch.from_numpy(sparse).to(dev),
                    torch.from_numpy(label).to(dev), valid))
    return out


def train_eval(cfg, train, test, epochs, batch=256, device="cuda",
               state=None, info=None):
    """Train `epochs` epochs, then the test AUC. Returns (auc, the last
    step's cafe* metrics). `state` replaces build_all's (the tests carry
    the JAX package's over); `info`, a dict, gets "graphed" and "steps"."""
    dev = resolve_device(device)
    model, embed, st, ts, es = build_all(cfg, train, device=dev)
    if state is not None:
        st = state
    batches = staged_batches(train, batch, dev)
    m = {}
    for _ in range(epochs):
        for dense, sparse, label, valid in batches:
            st, m = ts(st, dense, sparse, label, valid)
    metrics, _ = inference(cfg, es, st, test)
    if info is not None:
        info.update(graphed=bool(getattr(ts, "graphed", False)),
                    steps=epochs * len(batches))
    return metrics["roc_auc"], {k: float(v) for k, v in m.items()
                                if k.startswith("cafe")}


def run(points=None, device="cuda", rows=60000, vocab=20000, seeds=SEEDS
        ) -> list:
    """The sweep's first `points` grid points (all by default); one
    record per (point, seed), printed as the JAX tool prints it."""
    grids = list(itertools.product(*GRID))[:points]
    out = []
    for zipf, cr, th, epochs in grids:
        for seed in seeds:
            data = make_synthetic_arrays(rows=rows, fields=4, vocab=vocab,
                                         dense=4, zipf=zipf, seed=seed)
            train, test = split(data)
            base = Config(dataset="synthetic", embedding_dim=16,
                          learning_rate=0.1, compress_rate=cr,
                          cafe_sketch_threshold=th, cafe_hash_rate=0.3,
                          test_mini_batch_size=4096)
            res, info = {}, {}
            for method in ["hash", "cafe"]:
                cfg = dataclasses.replace(base, compress_method=method)
                auc, extra = train_eval(cfg, train, test, epochs,
                                        device=device, info=info)
                res[method] = auc
            print(f"zipf={zipf} cr={cr} th={th} ep={epochs} seed={seed} "
                  f"hash={res['hash']:.4f} cafe={res['cafe']:.4f} "
                  f"delta={res['cafe'] - res['hash']:+.4f} {extra}",
                  flush=True)
            out.append({"zipf": zipf, "cr": cr, "threshold": th,
                        "epochs": epochs, "seed": seed, **res,
                        "delta": res["cafe"] - res["hash"], "extra": extra,
                        **info})
    return out


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--points", type=int, default=None,
                    help="run only the first N grid points")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(args.points, args.device)


if __name__ == "__main__":
    main()
