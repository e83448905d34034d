"""Criteo-scale synthetic AUC grid — metric-vs-compression-rate at the
REAL Criteo Kaggle shapes (port of cafe_tpu/tools/criteo_grid.py).

Quality at scale is measured on a Zipf stream over the true 26-field
vocabularies (sum = 33,762,577 ids; tricks/sketchtest.py:41-45) with
id-driven labels: every id carries a fixed random logit, so hash
collisions measurably corrupt the signal and compression quality
differences are visible in AUC — the property the reference's
metric-vs-cr figures measure (visualization/plot_metric_cr.py).

Operating points follow tasks/criteo.json's paired (compress_rate,
sketch_threshold, hash_rate) schedule (tasks/criteo.json:44-56). The
promotion thresholds there are tuned for the 45.8M-row Criteo stream;
this grid's stream is shorter, so thresholds scale by rows/45.8M (scores
are mean-1 per batch, making the crossing count proportional to stream
length) — documented, not hidden.

Each config trains through the port's build_all (its train step replays
a CUDA graph on the card where train/step.capture_blockers allows),
batch_iterator -> device_prefetch, and evaluates with `inference`. It
runs on the card; `--platform cpu` runs on the CPU. Writes one JSON line
per finished config to --out (resumable; each record names the device it
ran on) and fails with exit code 1 if any config failed.

Usage:
  python -m cafe_tpu_torch.tools.criteo_grid --rows 4194304 \\
      --methods full hash cafe --crs 0.001 0.0001
  python -m cafe_tpu_torch.tools.criteo_grid --plot grid.png
"""

from __future__ import annotations

import argparse
import gc
import json
import os.path as osp
import subprocess
import sys
import time

import numpy as np
import torch

from ..config import Config
from ..data import CTRArrays, batch_iterator
from ..data.criteo import CRITEO_COUNTS
from ..data.loader import device_prefetch
from ..data.synthetic import _zipf_ids
from ..device import resolve_device
from ..train.loop import build_all, inference

REPO = osp.dirname(osp.dirname(osp.dirname(osp.abspath(__file__))))

CRITEO_ROWS = 45840617  # load_data.py:157-160

# (cr, cafe_threshold, cafe_hash_rate) — tasks/criteo.json pairing
POINTS = [
    (0.1, 20.0, 0.5),
    (0.01, 100.0, 0.3),
    (0.001, 500.0, 0.2),
    (0.0001, 500.0, 0.1),
]

# CAFE+ variants: plain (reference semantics), inherit (the
# beyond-reference Space-Saving count inheritance), auto (inherit +
# flow-proportional staging share); cafe_iv*: the amortized sketch insert
# (every k-th step, x-k score mass), the perf-mode A/B arms vs plain "cafe"
PLUS_VARIANTS = {
    "cafe_plus": {},
    "cafe_plus_inherit": {"cafe_plus_inherit": True},
    "cafe_plus_auto": {"cafe_plus_staging_frac": -1.0},
    "cafe_plus_auto_inherit": {"cafe_plus_inherit": True,
                               "cafe_plus_staging_frac": -1.0},
    "cafe_iv2": {"cafe_insert_interval": 2},
    "cafe_iv4": {"cafe_insert_interval": 4},
    "cafe_iv8": {"cafe_insert_interval": 8},
}


def gen_data(rows: int, zipf: float, seed: int, dense_w: float = 0.6):
    """Zipf stream over the real vocabularies; labels carry BOTH a
    dense-feature signal (learnable by every method's towers — keeps the
    full table strictly above any lossy embedding, round-2 verdict #9)
    and an id signal (corrupted by hash collisions — the axis the
    metric-vs-cr figures measure, plot_metric_cr.py:56-75)."""
    rng = np.random.default_rng(seed)
    counts = np.asarray(CRITEO_COUNTS, dtype=np.int32)
    cols, logits = [], np.zeros(rows, dtype=np.float32)
    for f, v in enumerate(counts):
        v = int(v)
        ids = (_zipf_ids(rng, rows, v, zipf) if v > 2
               else rng.integers(0, v, rows).astype(np.int32))
        cols.append(ids)
        id_logit = rng.normal(0.0, 1.0, size=v).astype(np.float32)
        logits += id_logit[ids]
    logits /= np.sqrt(len(counts))
    dense = np.log1p(rng.gamma(2.0, 2.0, size=(rows, 13))).astype(
        np.float32)
    w = rng.normal(0.0, 1.0, size=13).astype(np.float32)
    z = (dense - dense.mean(0)) / (dense.std(0) + 1e-9)
    dense_sig = (z @ w) / np.sqrt(13.0)
    logits = dense_w * dense_sig + logits
    p = 1.0 / (1.0 + np.exp(-logits))
    label = (rng.random(rows) < p).astype(np.int32)
    sparse = np.stack(cols, axis=1)
    return CTRArrays(sparse, dense, label, counts)


def grid_config(method: str, cr: float, thr: float, hr: float, rows: int,
                batch: int, **kw) -> Config:
    """The Config of one grid point: `method` at compress rate `cr`, the
    CAFE threshold `thr` scaled by rows / CRITEO_ROWS (at least 2), hash
    rate `hr`; `kw` overrides any field."""
    base_method = (None if method == "full"
                   else "cafe" if method in PLUS_VARIANTS else method)
    fields = dict(
        dataset="criteo", model="dlrm", embedding_dim=16,
        compress_method=base_method,
        cafe_plus=method.startswith("cafe_plus"),
        compress_rate=cr,
        cafe_sketch_threshold=max(thr * rows / CRITEO_ROWS, 2.0),
        cafe_hash_rate=hr, learning_rate=0.1,
        mini_batch_size=batch, test_mini_batch_size=16384,
        **PLUS_VARIANTS.get(method, {}))
    fields.update(kw)
    return Config(**fields)


def run_config(cfg, train, test, batch: int, epochs: int = 1,
               device="cuda", state=None):
    """Train `cfg` on `train` for `epochs` and evaluate on `test`: the
    record's numbers. `state` replaces build_all's initial state (a test
    passes the JAX package's through bridge.from_reference). On the card
    the record also holds the config's own peak allocated memory (above
    what was allocated before it was built)."""
    dev = resolve_device(device)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev)
    _, embed, own, step, ev = build_all(cfg, train, device=dev)
    state = own if state is None else state
    del own
    t0 = time.time()
    hot_fracs = []
    n_steps = 0
    for _ep in range(epochs):
        batches = batch_iterator(train, batch, drop_last=True)
        for dense, sparse, label, valid in device_prefetch(batches, dev):
            state, m = step(state, dense, sparse, label, valid)
            n_steps += 1
            if "cafe_hot_frac" in m and n_steps % 50 == 0:
                # a device copy (the next replay overwrites the step's
                # outputs), read after the loop: no host read in it
                hot_fracs.append(m["cafe_hot_frac"].clone())
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    train_s = time.time() - t0
    metrics, _ = inference(cfg, ev, state, test)
    out = {"auc": round(float(metrics["roc_auc"]), 5),
           "acc": round(float(metrics["accuracy"]), 5),
           "steps": n_steps, "train_s": round(train_s, 1),
           "ex_per_s": round(n_steps * batch / max(train_s, 1e-9))}
    if hot_fracs:
        hot_fracs = [float(h) for h in hot_fracs]
        out["hot_frac_last"] = round(hot_fracs[-1], 4)
        out["hot_frac_mean"] = round(float(np.mean(hot_fracs[-10:])), 4)
    sk = state.embed.get("part0", {}).get("sketch")
    part = next((p for p in embed.parts if hasattr(p, "sketch_cfg")), None)
    if isinstance(sk, dict) and "free_top" in sk and part is not None:
        # REAL capacity is buckets-1 (v1) / lim-1 (CAFE+), not the
        # ROW_ALIGN-padded free-stack length (hot_fraction's model)
        cap = (part.sketch_cfg.lim if part.plus
               else part.sketch_cfg.buckets) - 1
        out["slots_used"] = int(cap - int(sk["free_top"]))
        out["slot_capacity"] = cap
    if dev.type == "cuda":
        out["peak_mem_bytes"] = torch.cuda.max_memory_allocated(dev) - held
    return out


def card_name() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]


def plot_grid(jsonl_path: str, out_png: str) -> None:
    """Metric-vs-cr figure (reference contract: plot_metric_cr.py's
    method curves against the ideal line). Colors are the first slots of
    a CVD-validated categorical order; the ideal is a neutral dashed
    reference line, direct labels sit at the tight-compression end."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    rows = [json.loads(l) for l in open(jsonl_path)]
    # only rows from ONE (rows, zipf) experiment are comparable; plot the
    # largest group and say what was dropped
    groups = {}
    for r in rows:
        groups.setdefault((r["rows"], r["zipf"]), []).append(r)
    key = max(groups, key=lambda k: len(groups[k]))
    dropped = len(rows) - len(groups[key])
    if dropped:
        print(f"note: dropping {dropped} rows from other (rows, zipf) "
              f"configs; plotting {key}")
    rows = groups[key]
    series = {}
    for r in rows:
        series.setdefault(r["method"], {})[r["cr"]] = r["auc"]
    fig, ax = plt.subplots(figsize=(6.8, 4.2), dpi=150)
    full_auc = series.get("full", {}).get(1.0)
    if full_auc:
        ax.axhline(full_auc, color="#8a8a8a", lw=1.5, ls="--", zorder=1)
        ax.annotate(f"ideal (full table) {full_auc:.3f}",
                    xy=(0.03, full_auc), xytext=(0, -11),
                    textcoords="offset points", fontsize=8,
                    color="#555555")
    colors = {"cafe": "#2a78d6", "hash": "#eb6834", "cafe_plus": "#1baf7a",
              "off": "#eda100", "qr": "#e87ba4"}
    names = {"cafe": "CAFE", "hash": "Hash", "cafe_plus": "CAFE+",
             "off": "Off (oracle)", "qr": "QR"}
    offs = {"cafe": (10, -3), "hash": (10, -3), "cafe_plus": (10, -12),
            "off": (10, 2), "qr": (10, -10)}
    fallback = ["#4a3aa7", "#008300", "#e34948"]  # later categorical slots
    order = [m for m in ("cafe", "cafe_plus", "off", "qr", "hash")
             if m in series] + sorted(m for m in series
                                      if m not in names and m != "full")
    all_crs = []
    for m in order:
        pts = sorted((cr, auc) for cr, auc in series[m].items() if cr < 1.0)
        if not pts:
            continue
        xs = [p[0] for p in pts]
        ys = [p[1] for p in pts]
        all_crs += xs
        color = colors.get(m) or fallback[hash(m) % len(fallback)]
        ax.plot(xs, ys, color=color, lw=2, marker="o", ms=5,
                label=names.get(m, m), zorder=3)
        ax.annotate(names.get(m, m), xy=(xs[0], ys[0]),
                    xytext=offs.get(m, (10, -3)),
                    textcoords="offset points", fontsize=9,
                    color="#333333")
    ax.set_xscale("log")
    ax.invert_xaxis()
    if all_crs:
        ax.set_xlim(max(all_crs) * 2.0, min(all_crs) / 2.2)
    ax.set_xlabel("compression rate (log, decreasing →)")
    ax.set_ylabel("test AUC")
    ax.set_title("Criteo-scale synthetic stream (26 real vocabularies, "
                 "Σ=33.76M ids)", fontsize=10)
    ax.grid(True, which="both", color="#e6e6e6", lw=0.6, zorder=0)
    ax.spines[["top", "right"]].set_visible(False)
    ax.legend(frameon=False, fontsize=9, loc="lower left")
    fig.tight_layout()
    fig.savefig(out_png)
    print(f"wrote {out_png}")


def main(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--rows", type=int, default=4_194_304)
    p.add_argument("--zipf", type=float, default=1.1)
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--epochs", type=int, default=2,
                   help="passes over the train split (2-3 lets the full "
                        "table converge on rare ids; round-2 verdict #9)")
    p.add_argument("--dense_w", type=float, default=0.6,
                   help="weight of the dense-feature label signal")
    p.add_argument("--methods", nargs="+",
                   default=["full", "hash", "cafe"])
    p.add_argument("--crs", type=float, nargs="+", default=None,
                   help="subset of the grid's compress rates")
    p.add_argument("--out", default="docs/criteo_grid_torch.jsonl")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="cpu runs on the CPU; default the card")
    p.add_argument("--plot", default="",
                   help="render the metric-vs-cr figure from --out to "
                        "this path and exit")
    args = p.parse_args(argv)
    if args.plot:
        plot_grid(osp.join(REPO, args.out), args.plot)
        return
    device = resolve_device(args.platform)
    where = card_name() if device.type == "cuda" else "cpu"

    print(f"generating {args.rows} rows over the 26 Criteo vocabularies "
          f"(zipf {args.zipf})...", flush=True)
    t0 = time.time()
    data = gen_data(args.rows, args.zipf, args.seed, args.dense_w)
    cut = args.rows * 6 // 7
    train = CTRArrays(data.sparse[:cut], data.dense[:cut],
                      data.label[:cut], data.counts)
    test = CTRArrays(data.sparse[cut:], data.dense[cut:],
                     data.label[cut:], data.counts)
    print(f"generated in {time.time() - t0:.0f}s; "
          f"train {len(train)} test {len(test)}", flush=True)

    done = set()
    out_path = osp.join(REPO, args.out)
    try:
        for line in open(out_path):
            r = json.loads(line)
            done.add((r["method"], r["cr"], r["rows"]))
    except FileNotFoundError:
        pass

    points = [pt for pt in POINTS
              if args.crs is None or pt[0] in args.crs]
    grid = []
    if "full" in args.methods:
        grid.append(("full", None))
    for cr, thr, hr in points:
        for m in args.methods:
            if m != "full":
                grid.append((m, (cr, thr, hr)))

    skipped = []
    for method, pt in grid:
        cr, thr, hr = pt if pt else (1.0, 500.0, 0.5)
        key = (method, cr, args.rows)
        if key in done:
            print(f"skip {key} (done)", flush=True)
            continue
        cfg = grid_config(method, cr, thr, hr, args.rows, args.batch)
        print(f"--- {method} cr={cr} thr={cfg.cafe_sketch_threshold:.1f} "
              f"hash_rate={hr}", flush=True)
        try:
            res = run_config(cfg, train, test, args.batch, args.epochs,
                             device)
        except Exception as e:  # e.g. qr sizing below its operating floor
            print(f"SKIP {method} cr={cr}: {type(e).__name__}: {e}",
                  flush=True)
            skipped.append((method, cr, f"{type(e).__name__}: {e}"))
            continue
        finally:
            # free this config's state before the next one is built
            gc.collect()
            if device.type == "cuda":
                torch.cuda.empty_cache()
        rec = {"method": method, "cr": cr, "rows": args.rows,
               "zipf": args.zipf, "epochs": args.epochs,
               "dense_w": args.dense_w,
               "threshold": round(cfg.cafe_sketch_threshold, 2),
               "hash_rate": hr, **res, "device": where}
        with open(out_path, "a") as f:
            f.write(json.dumps(rec) + "\n")
        print(json.dumps(rec), flush=True)
    if skipped:
        # a silently thinner grid reads as "covered everything" — fail
        # loudly so regressions can't hide behind SKIP lines
        print(f"{len(skipped)} config(s) FAILED: {skipped}", flush=True)
        sys.exit(1)


if __name__ == "__main__":
    main()
