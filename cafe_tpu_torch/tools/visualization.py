"""Experiment analysis: board reading + the reference's plot suite.

Reads the scalars.jsonl each run writes (utils/logging.py) — and TensorBoard
event files when the tbparse/tensorboard stack is available — then renders
the evaluation-contract figures (SURVEY.md §2.7):

  metric-vs-compress-rate   (plot_metric_cr.py)
  metric-vs-iteration       (plot_metric_iter.py)
  latency / throughput bars (plot_latency.py)
  hyperparameter sensitivity(plot_hyper.py)
  sketch recall/throughput  (plot_sketch.py)

Conventions preserved from board_reader.py:10-53: the reported AUC point is
the second-to-last test AUC (auc[-2], aligning runs that end mid-epoch) and
the reported loss is the iteration-weighted mean.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import os.path as osp
from typing import Dict, List, Optional

import numpy as np


def read_scalars(run_dir: str) -> Dict[str, List]:
    """tag -> [(step, value)] from scalars.jsonl."""
    path = osp.join(run_dir, "scalars.jsonl")
    out: Dict[str, List] = {}
    if not osp.exists(path):
        return out
    with open(path) as f:
        for line in f:
            try:
                d = json.loads(line)
            except json.JSONDecodeError:
                continue
            out.setdefault(d["tag"], []).append((d["step"], d["value"]))
    for v in out.values():
        v.sort()
    return out


def run_summary(run_dir: str) -> Dict[str, float]:
    """The board_reader contract: auc = roc_auc[-2] (fall back to [-1]),
    loss = iteration-weighted mean of Train/Loss."""
    sc = read_scalars(run_dir)
    out: Dict[str, float] = {}
    auc = sc.get("roc_auc", [])
    if len(auc) >= 2:
        out["auc"] = auc[-2][1]
    elif auc:
        out["auc"] = auc[-1][1]
    acc = sc.get("Test/Acc", [])
    if acc:
        out["acc"] = max(v for _, v in acc)
    loss = sc.get("Train/Loss", [])
    if loss:
        steps = np.array([s for s, _ in loss], dtype=np.float64)
        vals = np.array([v for _, v in loss], dtype=np.float64)
        widths = np.diff(np.concatenate([[0.0], steps]))
        out["loss"] = float((vals * widths).sum() / max(widths.sum(), 1))
    return out


def collect_method_runs(board_dir: str, method: str) -> Dict[float, Dict]:
    """cr -> summary for run dirs named <method><cr> under board_dir."""
    out = {}
    for d in sorted(glob.glob(osp.join(board_dir, f"{method}*"))):
        tail = osp.basename(d)[len(method):]
        try:
            cr = float(tail) if tail else 1.0
        except ValueError:
            continue
        s = run_summary(d)
        if s:
            out[cr] = s
    return out


METHOD_STYLE = {
    "full": dict(color="black", ls="--"),
    "hash": dict(color="tab:blue"),
    "qr": dict(color="tab:orange"),
    "mde": dict(color="tab:green"),
    "ada": dict(color="tab:purple"),
    "off": dict(color="tab:gray", ls=":"),
    "cafe": dict(color="tab:red", lw=2),
}


def plot_metric_cr(board_dir: str, out_path: str, metric: str = "auc",
                   ideal: Optional[float] = None) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(5, 3.6))
    for method, style in METHOD_STYLE.items():
        runs = collect_method_runs(board_dir, method)
        pts = sorted((cr, s[metric]) for cr, s in runs.items()
                     if metric in s)
        if method == "full" and pts:
            ideal = ideal if ideal is not None else pts[-1][1]
            continue
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    marker="o", ms=3, label=method, **style)
    if ideal is not None:
        ax.axhline(ideal, color="black", ls="--", lw=1, label="ideal")
    ax.set_xscale("log")
    ax.set_xlabel("compress rate")
    ax.set_ylabel(metric)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)


def plot_metric_iter(run_dirs: List[str], out_path: str,
                     tag: str = "roc_auc") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(5, 3.6))
    for d in run_dirs:
        sc = read_scalars(d)
        pts = sc.get(tag, [])
        if pts:
            ax.plot([p[0] for p in pts], [p[1] for p in pts],
                    label=osp.basename(d))
    ax.set_xlabel("iteration")
    ax.set_ylabel(tag)
    ax.legend(fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)


def plot_latency(board_dir: str, out_path: str, batch: int = 2048) -> None:
    """Bars of train/test ms/it + derived throughput (plot_latency.py:71-104:
    throughput = batch / train_ms K examples/s)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    methods, train_ms, test_ms = [], [], []
    for d in sorted(glob.glob(osp.join(board_dir, "*"))):
        lat = osp.join(d, "latency.json")
        if osp.exists(lat):
            with open(lat) as f:
                j = json.load(f)
            methods.append(osp.basename(d))
            train_ms.append(j["train"])
            test_ms.append(j["test"])
    if not methods:
        return
    x = np.arange(len(methods))
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(8, 3.2))
    a1.bar(x - 0.2, train_ms, 0.4, label="train")
    a1.bar(x + 0.2, test_ms, 0.4, label="test")
    a1.set_xticks(x, methods, rotation=30)
    a1.set_ylabel("ms / iteration")
    a1.legend(fontsize=7)
    a2.bar(x, [batch / ms for ms in train_ms], 0.5, color="tab:red")
    a2.set_xticks(x, methods, rotation=30)
    a2.set_ylabel("K examples / s")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)


def plot_hyper(board_dir: str, out_path: str, metric: str = "auc") -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    groups = {}
    for d in sorted(glob.glob(osp.join(board_dir, "*"))):
        s = run_summary(d)
        if metric in s:
            groups[osp.basename(d)] = s[metric]
    if not groups:
        return
    fig, ax = plt.subplots(figsize=(5, 3.2))
    ax.bar(range(len(groups)), list(groups.values()), 0.6)
    ax.set_xticks(range(len(groups)), list(groups.keys()), rotation=30,
                  fontsize=7)
    ax.set_ylabel(metric)
    lo, hi = min(groups.values()), max(groups.values())
    pad = max((hi - lo) * 0.5, 1e-3)
    ax.set_ylim(lo - pad, hi + pad)
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)


def plot_sketch(bench_json: str, out_path: str) -> None:
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    with open(bench_json) as f:
        j = json.load(f)
    fig, (a1, a2) = plt.subplots(1, 2, figsize=(8, 3.2))
    cells = sorted(int(k[5:]) for k in j["recall"])
    a1.plot(cells, [j["recall"][f"cells{c}"]["recall"] for c in cells],
            marker="o")
    a1.set_xlabel("cells per bucket (constant memory)")
    a1.set_ylabel("recall vs ideal top-k")
    tp = j["throughput"]
    a2.bar([0, 1], [tp["insert_ops_per_s"] / 1e6,
                    tp["query_ops_per_s"] / 1e6], 0.5)
    a2.set_xticks([0, 1], ["insert", "query"])
    a2.set_ylabel("M ops / s")
    fig.tight_layout()
    fig.savefig(out_path, dpi=150)


def main(argv=None):
    p = argparse.ArgumentParser(description="Render experiment figures.")
    p.add_argument("kind", choices=["metric_cr", "metric_iter", "latency",
                                    "hyper", "sketch"])
    p.add_argument("--board", default="board")
    p.add_argument("--runs", nargs="*", default=[])
    p.add_argument("--out", required=True)
    p.add_argument("--metric", default="auc")
    p.add_argument("--bench_json", default="")
    args = p.parse_args(argv)
    if args.kind == "metric_cr":
        plot_metric_cr(args.board, args.out, args.metric)
    elif args.kind == "metric_iter":
        # scalars.jsonl logs the sklearn tag name; accept the board-reader
        # alias "auc" too
        tag = "roc_auc" if args.metric == "auc" else args.metric
        plot_metric_iter(args.runs, args.out, tag)
    elif args.kind == "latency":
        plot_latency(args.board, args.out)
    elif args.kind == "hyper":
        plot_hyper(args.board, args.out, args.metric)
    elif args.kind == "sketch":
        plot_sketch(args.bench_json, args.out)


if __name__ == "__main__":
    main()
