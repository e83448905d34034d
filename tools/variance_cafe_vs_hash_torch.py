#!/usr/bin/env python3
"""Multi-seed variance of the headline CAFE-vs-hash AUC separation, for
the PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/variance_cafe_vs_hash.py: the same configuration (120,000 rows, 6
fields, vocabulary 30,000, Zipf 1.2, cr 0.003, threshold 30, hash rate
0.3, batch 256, 2 epochs, seeds 11, 23, 37) and printout: mean +- std
test AUC per method and the per-seed gap.

Training runs through tools/sweep_cafe_vs_hash_torch.py's train_eval
(on the card every step replays a CUDA graph).

    python3 tools/variance_cafe_vs_hash_torch.py [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import os.path as osp
import sys

import numpy as np

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from sweep_cafe_vs_hash_torch import train_eval  # noqa: E402

from cafe_tpu_torch.config import Config  # noqa: E402
from cafe_tpu_torch.data import CTRArrays, make_synthetic_arrays  # noqa

SEEDS = [11, 23, 37]


def seed_split(seed, rows=120000, vocab=30000):
    data = make_synthetic_arrays(rows=rows, fields=6, vocab=vocab,
                                 dense=8, zipf=1.2, seed=seed)
    cut = len(data) * 6 // 7
    d = data.dense
    return (CTRArrays(data.sparse[:cut], d[:cut], data.label[:cut],
                      data.counts),
            CTRArrays(data.sparse[cut:], d[cut:], data.label[cut:],
                      data.counts))


def base_config(seed) -> Config:
    return Config(dataset="synthetic", embedding_dim=16,
                  learning_rate=0.1, compress_rate=0.003,
                  cafe_sketch_threshold=30, cafe_hash_rate=0.3,
                  mini_batch_size=256, test_mini_batch_size=16384,
                  numpy_rand_seed=seed)


def run(seeds=SEEDS, device="cuda", rows=120000, vocab=30000) -> dict:
    res = {"hash": [], "cafe": []}
    info = {}
    for seed in seeds:
        train, test = seed_split(seed, rows, vocab)
        for method in ("hash", "cafe"):
            cfg = dataclasses.replace(base_config(seed),
                                      compress_method=method)
            auc, _ = train_eval(cfg, train, test, 2, batch=256,
                                device=device, info=info)
            res[method].append(auc)
            print(f"seed {seed} {method}: auc {auc:.4f}", flush=True)

    for method, aucs in res.items():
        print(f"{method}: {np.mean(aucs):.4f} +- {np.std(aucs):.4f}")
    gap = np.asarray(res["cafe"]) - np.asarray(res["hash"])
    print(f"cafe - hash gap: {gap.mean():.4f} +- {gap.std():.4f} "
          f"(per-seed: {[round(g, 4) for g in gap]})")
    return {"seeds": list(seeds), "auc": res,
            "mean": {k: float(np.mean(v)) for k, v in res.items()},
            "std": {k: float(np.std(v)) for k, v in res.items()},
            "gap": [float(g) for g in gap], "gap_mean": float(gap.mean()),
            "gap_std": float(gap.std()), **info}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    return run(device=args.device)


if __name__ == "__main__":
    main()
