#!/usr/bin/env python3
"""Microbenchmark candidate lane-op primitives on the card, for the
PyTorch / CUDA port (cafe_tpu_torch; no jax). Port of tools/micro_ops.py:
the same ops, shapes (53,248 lanes, 9,728 sketch buckets, a 27,136 x 16
table), REPS and printout.

Every op is chained REPS = 16 times, all of them in ONE captured CUDA
graph, replayed once under torch.profiler. Each op is registered on a
line of its own in build_ops, and its device time is read from the
replay's trace: a marker kernel (torch.cuda._sleep of one cycle) is
captured first and after each op's chain, the graph runs its kernels in
capture order, so the replay's kernels between two markers, in time
order, are one op's (the tool checks that every op's end marker is
there; the trace may leave out a replay's first kernel, the leading
marker). On the CPU each op's chain is timed as a record_function span
(CPU time).

JAX ops without a counterpart are printed with the reason: the
`*_hints` scatters (torch's scatter takes no sortedness or uniqueness
hint) and `ss_denseN_in_B_sort` (torch.searchsorted has one method).

    python3 tools/micro_ops_torch.py [--device cuda]
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import os.path as osp
import sys
from collections import defaultdict

import numpy as np
import torch

sys.path.insert(0, osp.dirname(osp.dirname(osp.abspath(__file__))))

from cafe_tpu_torch.device import device_name, resolve_device  # noqa
from cafe_tpu_torch.utils.timing import fence  # noqa: E402
from tools.compiled_call_torch import compiled_call  # noqa: E402

REPS = 16
DEVICE_CATS = ("kernel", "gpu_memset", "gpu_memcpy")
MARKER = "spin_kernel"      # torch.cuda._sleep's kernel
NO_COUNTERPART = {
    "scat_add_S4_hints": "torch's scatter takes no indices_are_sorted / "
                         "unique_indices hint",
    "scat_add_N16_hints": "torch's scatter takes no indices_are_sorted / "
                          "unique_indices hint",
    "ss_denseN_in_B_sort": "torch.searchsorted has one method (no "
                           "scan_unrolled / sort choice)",
}


def _sort2(a, b2, c):
    """lax.sort((a, b2, c), num_keys=2): by a, then b2; c carried."""
    o1 = torch.argsort(b2, stable=True)
    perm = o1[torch.argsort(a[o1], stable=True)]
    return a[perm], b2[perm], c[perm]


def build_ops(device, B=53248, S=9728, N=27136, D=16):
    """op name -> (fn, args). Each op sits on ONE line of its own (the
    line the report names)."""
    rng = np.random.default_rng(0)

    def t(x):
        return torch.from_numpy(x).to(device)
    idx = t(rng.integers(0, S, B).astype(np.int32)).long()
    sidx = torch.sort(idx).values
    ridx = t(rng.integers(0, N, B).astype(np.int32)).long()
    sridx = torch.sort(ridx).values
    cell = t(rng.integers(0, 4, B).astype(np.int32)).long()
    vals = t(rng.random(B).astype(np.float32))
    gmat = t(rng.random((B, D)).astype(np.float32))
    tab4 = t(rng.random((S, 4)).astype(np.float32))
    tab8i = t(rng.integers(0, 100, (S, 8)).astype(np.int32))
    tab16i = t(rng.integers(0, 100, (S, 16)).astype(np.int32))
    tabND = t(rng.random((N, D)).astype(np.float32))
    rows27 = torch.arange(N, dtype=torch.int64, device=device)
    bc = t(rng.random((B, 4)).astype(np.float32))
    idx4k = idx[:4096]
    v4k = t(rng.integers(0, 99, 4096).astype(np.int32))
    three = torch.full((4096,), 3, dtype=torch.int64, device=device)
    two = torch.full((4096,), 2, dtype=torch.int64, device=device)
    packed = v4k[0] + torch.zeros((B,), dtype=torch.int32, device=device)
    col0 = tab4[:, 0].contiguous()
    four = torch.arange(4, device=device)

    ops = {}

    def add(name, fn, *args):
        ops[name] = (fn, args)

    add("scat_add_S4_plain", lambda t, i, c, v: t.index_put((i, c), v, accumulate=True), tab4, idx, cell, vals)
    add("scat_add_S8_packed", lambda t, i, c, v: t.index_put((i, c), v, accumulate=True), tab8i, idx, cell, packed)
    add("scat_add_N16_plain", lambda t, i, g: t.index_add(0, i, g), tabND, ridx, gmat)
    add("scat_set_S16_4klanes", lambda t, i, v: t.index_put((i, three), v), tab16i, idx4k, v4k)
    add("scat_add_S4_4klanes", lambda t, i, v: t.index_put((i, two), v, accumulate=True), tab4, idx4k, v4k.float())
    add("tala_B4", lambda b, c: torch.gather(b, 1, c[:, None])[:, 0], bc, cell)
    add("onehot_sel_B4", lambda b, c: torch.where(c[:, None] == four[None, :], b, 0.0).sum(1), bc, cell)
    add("gather_S4_B", lambda t, i: t[i], tab4, idx)
    add("gather_S8i_B", lambda t, i: t[i], tab8i, idx)
    add("gather_S16i_B", lambda t, i: t[i], tab16i, idx)
    add("gather_N16_B", lambda t, i: t[i], tabND, ridx)
    add("gather_S1d_B", lambda t, i: t[i], col0, idx)
    add("gather_S16i_4k", lambda t, i: t[i], tab16i, idx4k)
    add("ss_denseN_in_B_scan", lambda a, q: torch.searchsorted(a, q), sridx, rows27)
    add("ss_4kq_in_B_scan", lambda a, q: torch.searchsorted(a, q), sridx, rows27[:4096])
    add("ss_Bq_in_4k_scan", lambda a, q: torch.searchsorted(a, q), sridx[:4096], ridx)
    add("cumsum_B16_f32", lambda g: torch.cumsum(g, 0), gmat)
    add("cumsum_B_s32", lambda i: torch.cumsum(i, 0, dtype=torch.int32), idx.int())
    add("sort3_B_2keys", lambda a, b2, c: _sort2(a, b2, c), idx, ridx, vals)
    add("argsort_B", lambda i: torch.argsort(i, stable=True), idx)
    add("segsum_B_S_hint", lambda v, s: torch.zeros(S, device=v.device).index_add(0, s, v), vals, sidx)
    add("segsum_B16_N_hint", lambda g, s: torch.zeros((N, D), device=g.device).index_add(0, s, g), gmat, sridx)
    return ops


def op_lines() -> dict:
    """op name -> the line of build_ops that registers it."""
    src, start = inspect.getsourcelines(build_ops)
    out = {}
    for off, text in enumerate(src):
        s = text.strip()
        if s.startswith('add("'):
            out[s.split('"')[1]] = start + off
    return out


def _device_events(prof_path):
    with open(prof_path) as f:
        ev = json.load(f)["traceEvents"]
    return sorted((e for e in ev if e.get("ph") == "X"
                   and e.get("cat") in DEVICE_CATS),
                  key=lambda e: e["ts"])


def _profile(fn, path, cuda):
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if cuda
                                     else [])
    with profile(activities=acts) as prof:
        fn()
    prof.export_chrome_trace(path)
    return path


def run(device="cuda", trace_dir=None, **shape) -> dict:
    dev = resolve_device(device)
    cuda = dev.type == "cuda"
    trace_dir = trace_dir or osp.join(
        osp.dirname(osp.dirname(osp.abspath(__file__))), "build",
        "micro_ops")
    os.makedirs(trace_dir, exist_ok=True)
    for name, why in NO_COUNTERPART.items():
        print(json.dumps({"op": name, "no_counterpart": why}), flush=True)
    ops = build_ops(dev, **shape)
    names = list(ops)

    agg = defaultdict(float)
    if cuda:
        def marked():
            outs = []
            torch.cuda._sleep(1)                      # leading marker
            for name in names:
                fn, args = ops[name]
                for _ in range(REPS):
                    out = fn(*args)
                torch.cuda._sleep(1)                  # the op's end
                outs.append(out)
            return outs
        graph = compiled_call(marked, dev)
        fence(graph())
        path = _profile(lambda: fence(graph()),
                        osp.join(trace_dir, "replay.json"), True)
        events = _device_events(path)
        marks = [i for i, e in enumerate(events) if MARKER in e["name"]]
        lead = bool(marks) and marks[0] == 0
        if len(marks) != len(names) + lead:
            raise AssertionError(
                f"micro_ops: {len(marks)} marker kernels in the replay of "
                f"{len(events)} kernels, not {len(names) + 1} (first "
                f"{[e['name'][:40] for e in events[:4]]}, markers at "
                f"{marks[:6]}...{marks[-3:]})")
        # a replay's first kernel may go unreported: then the leading
        # marker is the one missing, and the first op starts the trace
        bounds = marks if lead else [-1] + marks
        for name, lo, hi in zip(names, bounds, bounds[1:]):
            agg[name] = sum(e["dur"] for e in events[lo + 1:hi])
        leading_marker_seen = lead
        graphed = True
    else:
        leading_marker_seen = None

        def chained():
            for name in names:
                fn, args = ops[name]
                with torch.profiler.record_function(name):
                    for _ in range(REPS):
                        fn(*args)
        chained()
        path = _profile(chained, osp.join(trace_dir, "cpu.json"), False)
        with open(path) as f:
            for e in json.load(f)["traceEvents"]:
                if e.get("ph") == "X" and e.get("cat") == "user_annotation" \
                        and e.get("name") in ops:
                    agg[e["name"]] += e["dur"]
        graphed = False
    lines = op_lines()
    print(f"\nper-op DEVICE time (avg over {REPS} reps):")
    for n in names:
        print(f"  {n:28s} {agg.get(n, 0.0) / REPS:9.1f} us")
    return {"us_per_op": {n: agg[n] / REPS for n in names},
            "lines": {n: f"tools/micro_ops_torch.py:{lines[n]}"
                      for n in names},
            "graphed": graphed, "reps": REPS,
            "leading_marker_seen": leading_marker_seen,
            "no_counterpart": NO_COUNTERPART,
            "device": device_name(dev)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    rec = run(args.device)
    print(json.dumps(rec), flush=True)
    return rec


if __name__ == "__main__":
    main()
