#!/usr/bin/env python3
"""Per-source-line device time of the whole train step, for the PyTorch /
CUDA port (cafe_tpu_torch; no jax). Port of tools/profile_train.py: the
same flags and workload (the bench.py protocol: DLRM, batch 2048 over
Criteo-Kaggle's 26 vocabularies, dim 16, cr 1e-3), the op-level view
behind tools/step_breakdown_torch.py's stage totals.

`--reps` eager train steps (build_all(..., capture=False): a replayed
graph carries no line) run under tools/profile_lines_torch.py's
run_and_report, which ties each kernel to the source line in
cafe_tpu_torch/ that launched it. The check: the lines must account for
at least MIN_ATTRIBUTED of the device-busy time (the kernels' summed
time) in the same trace; the output reports the share left unattributed
and the run exits 1 below the bound.

    python3 tools/profile_train_torch.py [--reps 8]
        [--method cafe|hash|full] [--dim 16] [--dataset criteo]
        [--cr 0.001] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import sys

sys.path.insert(0, osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from profile_lines_torch import run_and_report  # noqa: E402

BATCH = 2048              # bench.py:78
MIN_ATTRIBUTED = 0.9      # of the device-busy time in the trace


def profile(method="cafe", dim=16, dataset="criteo", cr=0.001, reps=8,
            device="cuda", top=50, data=None, **cfg_kw) -> dict:
    """The per-line report of `reps` eager steps on `data` ((train_data,
    batches); default the bench protocol's), the Config taking `cfg_kw`
    besides."""
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.data.criteo import make_criteo_batches
    from cafe_tpu_torch.device import resolve_device
    from cafe_tpu_torch.train import build_all

    dev = resolve_device(device)
    cfg = Config(
        dataset=dataset, model="dlrm", embedding_dim=dim,
        compress_method=None if method == "full" else method,
        compress_rate=1.0 if method == "full" else cr,
        cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
        mini_batch_size=BATCH, learning_rate=0.1, optimizer="sgd",
        bf16=True, **cfg_kw)
    train_data, batches = data or make_criteo_batches(batch=BATCH,
                                                      device=dev)
    _, _, state, train_step, _ = build_all(cfg, train_data, device=dev,
                                           capture=False)
    d, s, lab, v = batches[0]

    def chained(state, d, s, lab, v):
        for _ in range(reps):
            state, _ = train_step(state, d, s, lab, v)
        return state

    rec = run_and_report(chained, (state, d, s, lab, v), reps, top=top)
    share = 1.0 - rec["unattributed_share"]
    print(f"attributed {share:.4f} of the device-busy time "
          f"({rec['total_us_per_rep']:.1f} us/step); unattributed "
          f"{rec['unattributed_share']:.4f} (bound: at least "
          f"{MIN_ATTRIBUTED})", flush=True)
    rec.update(method=method, dim=dim, dataset=dataset, cr=cr, reps=reps,
               attributed_share=share, min_attributed=MIN_ATTRIBUTED,
               graphed=False)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=8)
    ap.add_argument("--method", default="cafe",
                    choices=["cafe", "hash", "full"])
    ap.add_argument("--dim", type=int, default=16)
    ap.add_argument("--dataset", default="criteo")
    ap.add_argument("--cr", type=float, default=0.001)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = profile(args.method, args.dim, args.dataset, args.cr, args.reps,
                  args.device)
    print(json.dumps({k: v for k, v in rec.items() if k != "lines"}),
          flush=True)
    if rec["attributed_share"] < MIN_ATTRIBUTED:
        raise SystemExit(1)
    return rec


if __name__ == "__main__":
    main()
