#!/usr/bin/env python3
"""Trace an eager function and aggregate device time by source line, for
the PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of
tools/profile_lines.py: run_and_report(fn, args, reps) and the same
three workloads.

How a kernel finds its line. fn runs under torch.profiler (CPU and CUDA
activities, with_stack=True) inside LineMarks, a TorchFunctionMode that
wraps every torch call made from a cafe_tpu_torch frame in a
record_function named "@<file>:<line>" after the innermost such frame
(the profiler's own Python frames carry only a function's first line).
In the exported Chrome trace each kernel is tied, by its correlation id
(the trace's ac2g flow events join the same pairs), to the runtime call
that launched it, and that launch to

1. for a backward op (run by autograd's device thread), the forward op
   with its sequence number, and then as 2 at that op;
2. the innermost "@file:line" mark enclosing it on its thread;
3. else the innermost profiled Python function under cafe_tpu_torch/
   enclosing it (a ctypes launch of the port's own kernels), named
   "file(first line): function";
4. else "?" (unattributed).

On the CPU the outermost operator events stand in for kernels (the
time is then CPU time). Eager only: a replayed CUDA graph is one launch
and carries no line.

    python3 tools/profile_lines_torch.py [--reps 30]
        [--what insert|apply27k|query] [--device cuda]
"""

from __future__ import annotations

import argparse
import json
import os
import os.path as osp
import sys
from collections import defaultdict

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

REPO = osp.dirname(osp.dirname(osp.abspath(__file__)))
sys.path.insert(0, REPO)

PKG = "cafe_tpu_torch" + os.sep
TRACE_DIR = osp.join(REPO, "build", "profile_lines")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _site(path: str) -> str:
    """`path` from cafe_tpu_torch/ on, or '' outside the package."""
    i = path.rfind(PKG)
    return path[i:] if i >= 0 else ""


class LineMarks(TorchFunctionMode):
    """Marks each torch call made from cafe_tpu_torch code with a
    record_function "@<file>:<line>" of its innermost package frame."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if getattr(func, "__name__", "") == "__get__":   # attributes
            return func(*args, **kwargs)
        f = sys._getframe(1)
        while f is not None and not _site(f.f_code.co_filename):
            f = f.f_back
        if f is None:
            return func(*args, **kwargs)
        with torch.profiler.record_function(
                f"@{_site(f.f_code.co_filename)}:{f.f_lineno}"):
            return func(*args, **kwargs)


class _Intervals:
    """Per-thread intervals (start, end, label); `innermost_many` answers
    "the innermost accepted interval enclosing (thread, t)" for many
    points by one sweep a thread (a thread's profiler events nest)."""

    def __init__(self):
        self.by_thread = defaultdict(list)

    def add(self, thread, start, dur, label):
        self.by_thread[thread].append((start, start + dur, label))

    def innermost_many(self, points, accept=None):
        out = [None] * len(points)
        queries = defaultdict(list)
        for i, p in enumerate(points):
            if p is not None:
                queries[p[0]].append((p[1], i))
        for thread, qs in queries.items():
            iv = sorted(self.by_thread.get(thread, ()),
                        key=lambda x: (x[0], -x[1]))
            stack, j = [], 0
            for t, i in sorted(qs):
                while j < len(iv) and iv[j][0] <= t:
                    while stack and stack[-1][1] < iv[j][0]:
                        stack.pop()
                    stack.append(iv[j])
                    j += 1
                while stack and stack[-1][1] < t:
                    stack.pop()
                for s, e, label in reversed(stack):
                    if e >= t and (accept is None or accept(label)):
                        out[i] = label
                        break
        return out


def attribute(events, device_type="cuda"):
    """[(line, device_us)] for each device event of a Chrome trace, by the
    rules of the module docstring; on the CPU the outermost cpu_op events
    stand in for kernels."""
    marks, frames, ops = _Intervals(), _Intervals(), _Intervals()
    launches, flows = {}, {}
    fwd_by_seq = {}
    devices = []
    for e in events:
        ph, cat = e.get("ph"), e.get("cat")
        thread = (e.get("pid"), e.get("tid"))
        if ph == "s" and cat == "ac2g":
            flows[e.get("id")] = (thread, e.get("ts"))
            continue
        if ph != "X":
            continue
        ts, dur = e.get("ts", 0.0), e.get("dur", 0.0) or 0.0
        args = e.get("args", {}) or {}
        name = e.get("name", "")
        if cat == "user_annotation" and name.startswith("@"):
            marks.add(thread, ts, dur, name[1:])
        elif cat == "python_function" and _site(name.split("(")[0]):
            frames.add(thread, ts, dur, _site(name))
        elif cat == "cpu_op":
            seq = args.get("Sequence number")
            fwd = args.get("Fwd thread id")
            ops.add(thread, ts, dur, (seq, fwd))
            if seq is not None and not fwd and seq not in fwd_by_seq:
                fwd_by_seq[seq] = (thread, ts)
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (thread, ts)
        elif cat in DEVICE_CATS:
            devices.append((args.get("correlation"), dur))
    if device_type == "cuda":
        points = [launches.get(c, flows.get(c)) for c, _ in devices]
        durs = [d for _, d in devices]
    else:
        # the outermost operators of each thread stand in for kernels
        points, durs = [], []
        for thread, iv in ops.by_thread.items():
            end = -1.0
            for s, e, _ in sorted(iv, key=lambda x: (x[0], -x[1])):
                if s >= end:
                    points.append((thread, s))
                    durs.append(e - s)
                    end = e
    # a backward op's launch stands at its forward op
    seq_ops = ops.innermost_many(points, lambda lab: lab[0] is not None)
    points = [fwd_by_seq.get(op[0], p) if op is not None and op[1] else p
              for p, op in zip(points, seq_ops)]
    mark = marks.innermost_many(points)
    frame = frames.innermost_many(points)
    return [(m or f or "?", d) for m, f, d in zip(mark, frame, durs)]


def report(attributed, reps, top=40) -> dict:
    """Print the JAX tool's table; returns {"total_us_per_rep",
    "attributed_us_per_rep", "unattributed_share", "lines": {line:
    [us_per_rep, count_per_rep]}}."""
    agg = defaultdict(lambda: [0.0, 0])
    tot = 0.0
    for line, dur in attributed:
        agg[line][0] += dur
        agg[line][1] += 1
        tot += dur
    print(f"total device: {tot / reps:.1f} us/rep over {reps} reps")
    rows = sorted(agg.items(), key=lambda kv: -kv[1][0])
    for src, (d, n) in rows[:top]:
        print(f"{d / reps:9.2f} us/rep x{n / reps:7.1f}  {src}")
    un = agg.get("?", [0.0, 0])[0]
    return {"total_us_per_rep": tot / reps,
            "attributed_us_per_rep": (tot - un) / reps,
            "unattributed_share": un / tot if tot else 0.0,
            "lines": {k: [v[0] / reps, v[1] / reps] for k, v in rows}}


def run_and_report(fn, args, reps, top=40, trace_dir=TRACE_DIR) -> dict:
    """Run fn(*args) once (warm-up), then once under the profiler inside
    LineMarks; print device time by source line, per rep. fn should run
    the op under test `reps` times."""
    from torch.profiler import ProfilerActivity, profile

    from cafe_tpu_torch.device import device_name
    from cafe_tpu_torch.utils.timing import fence, tensors_of
    print("warming up...", flush=True)
    out = fn(*args)
    fence(out)
    dev_type = "cuda" if any(t.is_cuda for t in tensors_of(args)) \
        else "cpu"
    acts = [ProfilerActivity.CPU]
    if dev_type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    with profile(activities=acts, with_stack=True) as prof:
        with LineMarks():
            out = fn(*args)
        fence(out)
    os.makedirs(trace_dir, exist_ok=True)
    path = osp.join(trace_dir, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    rec = report(attribute(events, dev_type), reps, top)
    rec["trace"] = path
    rec["device"] = device_name(dev_type)
    return rec


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--reps", type=int, default=30)
    ap.add_argument("--what", default="insert",
                    choices=["insert", "apply27k", "query"])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    from cafe_tpu_torch.device import resolve_device
    from cafe_tpu_torch.sketch import hotsketch as hs

    dev = resolve_device(args.device)
    B, HOT, vocab = 53248, 9728, 33_000_000       # tools/profile_lines.py
    rng = np.random.default_rng(0)
    u = rng.random(B) ** 4.0
    ids = torch.from_numpy(((u * vocab).astype(np.int64) * 1000000007
                            % vocab).astype(np.int32)).to(dev)
    scores = torch.from_numpy(rng.random(B).astype(np.float32)
                              + 0.5).to(dev)
    cfg = hs.HotSketchConfig(buckets=HOT, threshold=500.0)
    st = hs.init_sketch(cfg, device=dev)
    R = args.reps

    if args.what == "insert":
        def chained(st, ids, scores):
            for _ in range(R):
                st, _ = hs.sketch_insert(cfg, st, ids, scores)
            return st
        return run_and_report(chained, (st, ids, scores), R)
    if args.what == "query":
        def chained(st, ids):
            acc = torch.zeros((), dtype=torch.int64, device=dev)
            for _ in range(R):
                acc = acc + hs.sketch_query(cfg, st, ids)[0].sum()
            return acc
        return run_and_report(chained, (st, ids), R)
    from cafe_tpu_torch.ops.sorted_update import apply_rows_pass
    NTAB, D = 27136, 16
    tab = torch.from_numpy(rng.standard_normal((NTAB, D))
                           .astype(np.float32)).to(dev)
    ridx = torch.from_numpy(rng.integers(0, NTAB, B).astype(np.int32)).to(dev)
    grad = torch.from_numpy(rng.standard_normal((B, D)).astype(np.float32)
                            * .01).to(dev)

    def chained(tab, ridx, grad):
        for _ in range(R):
            tab, _ = apply_rows_pass(tab, {}, ridx, grad, 0.05, "sgd")
        return tab
    return run_and_report(chained, (tab, ridx, grad), R)


if __name__ == "__main__":
    main()
