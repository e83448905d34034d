"""HotSketch microbenchmark of the PyTorch port (the twin of
cafe_tpu/tools/sketch_bench.py: the same flags, experiments and JSON
document, plus "device"; --device takes the place of --platform).

    python tools/sketch_bench_torch.py [--device cpu] [--stream_len N] ...

Experiments on a Zipfian id stream:

1. **Recall vs ideal top-k** across memory budgets and cells per bucket
   (cells x buckets held fixed), for the v1 sketch and for CAFE+: the
   exact tallies of the ids inserted are the oracle; recall is the share
   of the ideal top-|hot| ids the sketch marks hot.
2. **Throughput**: insert and query ops/s of the v1 sketch over a window
   of up to 100 batches. On the card the window is one CUDA graph of the
   whole window, replayed and timed with CUDA events (the device's time,
   as the JAX tool's one scanned program); on the CPU the host clock.
3. **Temporal drift**: recall of the hot set against a sliding-window
   top-k and the all-history top-k along the stream.

Prints one JSON document on stdout. jax-free; defaults to the card.
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

from cafe_tpu_torch.device import resolve_device  # noqa: E402
from cafe_tpu_torch.sketch import (CafePlusConfig, HotSketchConfig,  # noqa
                                   analyse, analyse_tracked, init_sketch,
                                   init_sketch_plus, sketch_insert,
                                   sketch_insert_plus, sketch_query)


def zipf_stream(n, vocab, s, seed=0):
    """The JAX tool's stream: Zipf(s) ranks drawn with numpy, mapped
    through a random permutation of the vocabulary."""
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** (-s)
    p /= p.sum()
    ids = rng.choice(vocab, size=n, p=p)
    perm = rng.permutation(vocab)
    return perm[ids].astype(np.int32)


def hot_set(state):
    dic, val = state["dic"].cpu().numpy(), state["val"].cpu().numpy()
    return set(val[dic != 0].tolist())


def hot_set_plus(state):
    out = set()
    for t in ("1", "2"):
        dic = state["dic" + t].cpu().numpy()
        out |= set(state["val" + t].cpu().numpy()[dic != 0].tolist())
    return out


def _stream_in(stream, batch, insert, st, dev):
    """Insert whole batches of the stream (the tail that fills no batch is
    left out, as the JAX tool leaves it); returns (state, ids inserted)."""
    ones = torch.ones(batch, dtype=torch.float32, device=dev)
    inserted = 0
    for lo in range(0, len(stream) - batch + 1, batch):
        st, _ = insert(st, torch.from_numpy(stream[lo:lo + batch]).to(dev),
                       ones)
        inserted = lo + batch
    return st, inserted


def _recall(stream, inserted, vocab, hot):
    counts = np.bincount(stream[:inserted], minlength=vocab)
    ideal = set(np.argsort(-counts)[: max(len(hot), 1)].tolist())
    return len(ideal & hot) / max(len(ideal), 1)


def run_recall(stream, vocab, buckets, threshold, cells, batch, dev):
    cfg = HotSketchConfig(buckets=buckets, threshold=threshold, cells=cells)
    st, n = _stream_in(stream, batch,
                       lambda s, i, sc: sketch_insert(cfg, s, i, sc),
                       init_sketch(cfg, dev), dev)
    hot = hot_set(st)
    return _recall(stream, n, vocab, hot), len(hot)


def run_recall_plus(stream, vocab, lim, threshold, cells, batch, dev,
                    adjust=True):
    """CAFE+ recall vs the offline ideal top-k."""
    cfg = CafePlusConfig(lim=lim, threshold=threshold, cells=cells,
                         adjust_threshold=adjust)
    st, n = _stream_in(stream, batch,
                       lambda s, i, sc: sketch_insert_plus(cfg, s, i, sc),
                       init_sketch_plus(cfg, dev), dev)
    hot = hot_set_plus(st)
    return (_recall(stream, n, vocab, hot), len(hot),
            float(st["threshold"]))


def run_tracked(stream, vocab, buckets, threshold, cells, batch, dev,
                insert_rounds=2):
    """Of the ideal top-k ids, the share HOT (analyse) and the share
    PRESENT in any cell (analyse_tracked)."""
    cfg = HotSketchConfig(buckets=buckets, threshold=threshold,
                          cells=cells, insert_rounds=insert_rounds)
    st, n = _stream_in(stream, batch,
                       lambda s, i, sc: sketch_insert(cfg, s, i, sc),
                       init_sketch(cfg, dev), dev)
    hot = hot_set(st)
    counts = np.bincount(stream[:n], minlength=vocab)
    ideal = torch.from_numpy(
        np.argsort(-counts)[: max(len(hot), 1)].astype(np.int32)).to(dev)
    return (float(analyse(cfg, st, ideal)),
            float(analyse_tracked(cfg, st, ideal)), len(hot))


def _window_s(fn, dev):
    """Seconds of one fn() call: on the card a CUDA graph of fn replayed
    behind warm-up calls and timed with events; on the CPU the host clock
    around one call after a warm one."""
    if dev.type != "cuda":
        fn()
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize(dev)
    return start.elapsed_time(end) / 1e3


def run_throughput(stream, buckets, threshold, batch, dev):
    """Insert and query ops/s over up to 100 batches (module docstring)."""
    cfg = HotSketchConfig(buckets=buckets, threshold=threshold)
    n_chunks = min(100, len(stream) // batch)
    if n_chunks == 0:
        return 0.0, 0.0
    stacked = torch.from_numpy(np.stack(
        [stream[lo * batch:(lo + 1) * batch]
         for lo in range(n_chunks)])).to(dev)
    ones = torch.ones(batch, dtype=torch.float32, device=dev)
    st0 = init_sketch(cfg, dev)
    out = {}

    def insert_window():
        st = st0
        for i in range(n_chunks):
            st, _ = sketch_insert(cfg, st, stacked[i], ones)
        out["st"] = st

    ins_s = _window_s(insert_window, dev)
    st = {k: v.clone() for k, v in out["st"].items()}

    def query_window():
        acc = torch.zeros((), dtype=torch.int64, device=dev)
        for i in range(n_chunks):
            acc = acc + sketch_query(cfg, st, stacked[i]).sum()
        out["acc"] = acc

    que_s = _window_s(query_window, dev)
    return batch * n_chunks / ins_s, batch * n_chunks / que_s


def run_drift(stream, vocab, buckets, threshold, batch, window, dev):
    """Sliding-window vs cumulative top-k recall along the stream."""
    cfg = HotSketchConfig(buckets=buckets, threshold=threshold)
    st = init_sketch(cfg, dev)
    ones = torch.ones(batch, dtype=torch.float32, device=dev)
    points = []
    stride = max(len(stream) // 5 // batch, 1) * batch
    for lo in range(0, len(stream) - batch, batch):
        st, _ = sketch_insert(cfg, st, torch.from_numpy(
            stream[lo:lo + batch]).to(dev), ones)
        if lo and lo % stride == 0:
            hot = hot_set(st)
            k = max(len(hot), 1)
            wslice = stream[max(0, lo - window):lo + batch]
            cum = np.bincount(stream[: lo + batch], minlength=vocab)
            win = np.bincount(wslice, minlength=vocab)
            r_cum = len(set(np.argsort(-cum)[:k].tolist()) & hot) / k
            r_win = len(set(np.argsort(-win)[:k].tolist()) & hot) / k
            points.append({"pos": lo, "recall_cumulative": round(r_cum, 4),
                           "recall_window": round(r_win, 4)})
    return points


def parse_args(argv=None):
    p = argparse.ArgumentParser()
    p.add_argument("--stream_len", type=int, default=400000)
    p.add_argument("--vocab", type=int, default=50000)
    p.add_argument("--zipf", type=float, default=1.2)
    p.add_argument("--buckets", type=int, default=2048)
    p.add_argument("--threshold", type=float, default=20.0)
    p.add_argument("--batch", type=int, default=4096)
    p.add_argument("--cells", type=int, nargs="+", default=[4, 8, 16, 32])
    p.add_argument("--kernel", choices=["v1", "plus", "both"],
                   default="both")
    p.add_argument("--rounds_sweep", action="store_true",
                   help="insert_rounds x cells droop diagnostic")
    p.add_argument("--device", default="cuda",
                   help="where the sketch runs (cpu for a CPU run)")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    dev = resolve_device(args.device)
    stream = zipf_stream(args.stream_len, args.vocab, args.zipf)
    out = {"config": vars(args), "recall": {}, "recall_plus": {},
           "throughput": {},
           "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                      else "cpu")}
    for cells in args.cells:
        # constant memory: cells * buckets held fixed
        buckets = args.buckets * 4 // cells
        r, nhot = run_recall(stream, args.vocab, buckets, args.threshold,
                             cells, args.batch, dev)
        out["recall"][f"cells{cells}"] = {"recall": round(r, 4),
                                          "hot": nhot}
    if args.kernel in ("plus", "both"):
        for cells in args.cells:
            lim = args.buckets * 4 // cells
            r, nhot, thr = run_recall_plus(stream, args.vocab, lim,
                                           args.threshold, cells,
                                           args.batch, dev)
            out["recall_plus"][f"cells{cells}"] = {
                "recall": round(r, 4), "hot": nhot,
                "final_threshold": round(thr, 2)}
    if args.rounds_sweep:
        out["rounds_sweep"] = {}
        for cells in (16, 32):
            buckets = args.buckets * 4 // cells
            for rounds in (2, 4, 8):
                hot_r, tracked_r, nhot = run_tracked(
                    stream, args.vocab, buckets, args.threshold, cells,
                    args.batch, dev, insert_rounds=rounds)
                out["rounds_sweep"][f"cells{cells}_rounds{rounds}"] = {
                    "recall_hot": round(hot_r, 4),
                    "recall_tracked": round(tracked_r, 4), "hot": nhot}
    ins_ops, que_ops = run_throughput(stream, args.buckets, args.threshold,
                                      args.batch, dev)
    out["throughput"] = {"insert_ops_per_s": round(ins_ops),
                         "query_ops_per_s": round(que_ops)}
    out["drift"] = run_drift(stream, args.vocab, args.buckets,
                             args.threshold, args.batch,
                             window=args.stream_len // 4, dev=dev)
    print(json.dumps(out, indent=2))
    return out


if __name__ == "__main__":
    main()
