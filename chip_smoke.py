#!/usr/bin/env python3
"""Drive the PyTorch / CUDA port (cafe_tpu_torch) on one NVIDIA card and
check it end to end.

    python3 chip_smoke.py     # needs one CUDA card

Phases, each printing one JSON line and raising on failure:

1. build + device: the kernels are compiled from the repo's .cu sources
   (one nvcc per source, all at once); the card's name and power limit;
2. kernels: K1 and K2 against their plain PyTorch versions on the card
   at the slice's shapes (K1 bit-exact, on its edge cases too: a
   20,000-lane run, empty row bands, no rows, every lane dropped; two
   launches bit-equal; K2 within its f32 bound), timed beside the plain
   version, one library call and the memory bound; K1 also inside a
   replayed CUDA graph of 20 calls (`graph_ms`);
3. headline: DLRM + CAFE, Criteo-Kaggle's 26 vocabularies, batch 2048,
   dim 16, cr 1e-3, bf16 towers, SGD, a sketch insert every step — timed
   eager steps through build_all(capture=False) / train_step; K1 must
   launch once per step (phases 3, 5, 7 and 8 drive the eager step, as
   before the steps were graphed; phases 17-21 the graphed one);
4. kernels_rowsum: K3 against its plain version at the headline table
   (27,136 x 16) with 53,248 lanes: the ids the trained CafePart routes
   a batch to, duplicate-heavy Zipf ids, and one row taking every kept
   lane (a run over 208 tiles) — within the f32 reordering bound of the
   longest run, bit-equal on dyadic payloads, and two launches bit-equal
   to each other; timed as phase 2, with each stage's device time (prep,
   sort, sum, fix-up) read by kernel name from a torch.profiler window;
5. headline_dense: the headline with --sparse_apply_impl dense; K1 and K3
   must each launch once per step;
6. parity: 3 headline steps on the card (build_all's default step: 2
   eager warm-up calls, then a captured CUDA graph) and on the CPU from
   one state
   (frequency scores, low threshold so ids promote), for the auto and the
   dense sparse apply: sketch and routing equal, loss / params / table
   within a stated tolerance;
7. sibling: the dim-128 config (cr 0.1, lr 1.0, CriteoTB towers on the
   Kaggle vocabularies; a 3.2M-row table) — K1 and K2 must launch;
8. profile: 5 headline steps (auto and dense) under torch.profiler —
   device busy time, idle share, kernels per step (tables in
   chiprun_out/); the landing must be one kernel a step (K1's
   land_max_kernel, no fill kernel);
9. cli (run after phase 21): main_torch.main, whose train and eval
   steps replay CUDA graphs, on a Criteo-Kaggle-shaped memmap in the
   reference's binary format (114,688 rows: 48 train and 8 test batches
   of 2048) with the headline flags, --sparse_apply_impl dense and an lr
   schedule: run A trains, evaluates twice and checkpoints (K1 and K3
   must launch 48 times, counted per replay); run B loads the best
   checkpoint into a graphed eval step and must reproduce run A's
   metrics there; run C measures the latency protocol;
10. kernels_a2a: K5 at n = 1 at the headline's exchange shapes (ids
   [1, 53,248] int32, rows [1, 53,248, 16] f32), bit-equal to its plain
   version (NCCL all_to_all_single) and timed beside it, `copy_` and the
   memory bound, and inside a replayed CUDA graph of 20 calls
   (`graph_ms`); then K5 between 4 processes on the one card through
   CUDA IPC over 3 successive calls, bit-equal on every rank (not timed:
   processes on one card without MPS are time-sliced);
11. sharded: the headline through build_all(mesh=make_mesh(1)) on NCCL
   with --shard_exchange pallas, timed as the headline (K5 must launch 4
   times and K1 once per step); the same state through explicit, a2a and
   pallas, and on the CPU (a gloo group of 1), 3 steps each with
   frequency scores: sketch and routing equal, tables within the bound;
   5 traced steps, the landing one kernel a step;
12. cli_sharded: main_torch.main on the memmap with --mesh_shape 1
   --shard_embeddings true --shard_exchange pallas: 48 steps and 2 evals,
   with the launch counts checked;
13. kernels_gather (run right after kernels_rowsum): K4 against its plain
   version, bit for bit, at decision 4's shape (53,248 uniform ids into a
   4,194,304 x 128 f32 table), at the headline table (27,136 x 16) with
   the ids the trained CafePart routes a batch to, in bf16, on two
   unaligned views (4-byte words, bytes) and at B = tile; timed beside
   the plain version, index_select and the memory bound;
14. ab_decisions: the four decisions of tools/ab_decisions_torch.py in
   this process at full width, 2 windows x 20 steps: four report lines,
   K4 launched 10 + 3 x 20 times in decision 4, K1 once a step in
   decisions 1-3 and K2 once a step in decision 2; before them, the
   donate_off arm's multi-step must leave its input state unchanged;
15. ab_insert_land: tools/ab_insert_land_torch.py (level 1, the equal-state
   check of all four landing arms, level 2), 2 windows x 20 steps; only
   the pallas arm launches K1, once an insert;
16. roofline: cafe_tpu_torch.tools.roofline at its default shapes: K2
   launched by optimizer_apply, every frac_of_peak <= 1.05.
The tools' own prints go to OUT_DIR/tools_*.txt; the tools time eager
steps.

The compiled step (CUDA graphs, train/capture.py), run before phase 9:

17-19. headline_graph, headline_dense_graph, sibling_graph: the step of
   phases 3, 5 and 7 built graphed (it must report `.graphed`) and eager
   on one state, in alternating windows of 20 steps ended by a
   synchronize, 5 each: ms/step and windows of each, peak memory,
   capture time, and the launches a graphed step makes, counted per
   replay, which must equal what the capture recorded (K1 once; K3 or
   K2 once in dense and sibling). Then the gate `replay_equals_eager`,
   with frequency scores and a low threshold (ids promote) over 12
   batches with a tail and an empty one: from one start state the
   sketch, tick, step, promotions and routed rows bit-equal between the
   eager and the replayed trajectory (and, in dense, whose K3 apply is
   deterministic, the tables, params and metrics); and step by step from
   one cloned state every tensor and metric bit-equal, the tables
   bit-equal in dense and, in headline (index_add_) and sibling (K2),
   whose scatter-adds sum in float atomics, within twice the reordering
   bound of the step's scatter-add (each order within it of the exact
   sums), beside the gap between two eager steps;
20. eval_graph: the graphed eval step's scores equal the eager one's
   batch for batch, then alternating windows of 20 calls, 5 each;
21. profile_headline_graph: phase 8's trace of 5 replayed headline
   steps (device busy, idle share, kernels a step, one K1 a step);
22. cli_timing (after phase 9): main_torch.main graphed and eager, in
   turns, on a 458,752-row memmap (192 train batches) at
   --steps_per_dispatch 1 and 8: train ms/it from the printed 32-it
   windows after it 128 (its 160 and 192), and each one's latency protocol (eval ms/it);
   K1 and K3 once a step.

The baseline methods and the other towers, at full Kaggle width (run
after phase 16), each built through build_all and graphed unless
train/step.capture_blockers names a reason (AdaEmbed's step stays
eager):

23. methods: QR (add, mult, concat), MDE, Off (hot dictionaries from the
   batches' dataset), weighted pooling (hash, learned) and AE
   (--max_ind_range 65536, one batch of pretraining first) at the
   headline flags with --sparse_apply_impl dense; QR and AdaEmbed at the
   sibling's (dim 128, cr 0.1, lr 1.0; AdaEmbed's first step runs its
   check and rebuild over all 33.76 M ids: the admitted count and a
   rebuild's time). Each: 3 windows of 20 steps after the first step and
   the warm-up calls, ms/step, its own peak allocated memory, graphed or
   not, and the kernels it launched, each as often as the apply routes
   of ops/sparse.py predict (K3 per dense-apply table, K2 per table of
   >= 2^20 rows at dim 128); then K2 against its plain version at the
   sibling QR's q table and AdaEmbed's pool (lanes at n_rows included)
   and K3 at the headline QR's q and r tables and Off's table, with the
   rows each routes a batch to; then `card_vs_cpu`: 3 steps (2 warm-up
   calls and a replay) on the card and on the CPU, each from one state,
   with AE's pretraining first: integer state and routed rows equal,
   every scatter-added table within twice its reordering bound plus the
   lanes' card-vs-CPU gradient gap, other embedding state bit-equal,
   dense params within 1e-3 (bf16 towers), AE's pretrained tensors
   within 1e-5;
24. towers: WDL and DCN over CAFE at the headline flags (dense apply), as
   phase 23; the gate with frequency scores and a low threshold, so the
   sketch compares exactly;
25. cli_qr_dcn: main_torch.main --compress_method qr --model dcn at the
   headline flags on the CLI_ROWS memmap: 48 steps, 2 evals, K3 twice a
   step.

CAFE+, the two-tier sketch with the adaptive threshold (each at full
Kaggle width, graphed; K1 never launches on a CAFE+ path):

26-29. cafe_plus, cafe_plus_dense, cafe_plus_sibling, cafe_plus_reset
   (run after phases 17-19): the headline flags with --cafe_plus true
   (auto apply; dense apply: K3 once a replay), the sibling's (K2 once a
   replay), and the headline with frequency scores and threshold 1, so
   the reset fires every few steps. Each as phase 17 (eager and graphed
   windows, launches a replay, peak memory) beside v1's graphed ms/step
   of this call; how often the reset and the decay fired in those steps
   (a counter on the card, two compares and an add before each step, in
   both arms); the replay gate of phase 17 (frequency scores;
   the reset configuration keeps its threshold of 1, and its trajectory
   must see the reset fire); and `card_vs_cpu`, phase 23's gate (3
   steps, each from one state; the reset configuration 3 card steps in,
   where the reset fires);
30. plus_reset_cost_headline, plus_reset_cost_sibling: the insert at
   each shape, a call's share of 5 calls captured in a CUDA graph: the
   speculative reset alone, the insert, the insert without the reset;
31. profile_cafe_plus_graph: phase 21's trace of 5 replayed CAFE+
   headline steps (no K1);
32. cli_plus (after phase 9): phase 9's runs A, B and C with
   --cafe_plus true (K3 48 times in run A, no K1);
33. sharded_plus, sharded_parity_plus (after phase 11): the sharded
   headline with --cafe_plus true at world size 1 (K5 4 times a step),
   and phase 11's parity (every CAFE+ sketch field equal in each mode
   and on the CPU);
34. sketch_bench (last): tools/sketch_bench_torch.py on a 60,000-id Zipf
   stream; CAFE+ recall above 0.6.

Then the kernels line (every kernel's launches on the main path, those
made by graph replays, error, times, bound and, for K1 and K5, graph_ms)
and, last, the device line. Every JSON line carries `elapsed_s`, the
seconds since the script started.
Exits non-zero without a CUDA card or without the cafe_tpu_torch package
beside it.
"""

import contextlib
import dataclasses
import gc
import io
import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
F32_OPS_PER_S = 67e12          # H100 SXM, f32 outside the tensor cores
HEADLINE_STEPS, WINDOWS = 20, 5
SIBLING_STEPS = 5
OUT_DIR = "chiprun_out"
CLI_ROWS = 114688             # 6/7 train: 48 batches of 2048; 8 test ones
CLI_TIMING_ROWS = 458752      # 192 train batches of 2048; 32 test ones
CLI_FLAGS = ["--dataset", "criteo", "--embedding_dim", "16",
             "--compress_method", "cafe", "--compress_rate", "0.001",
             "--cafe_sketch_threshold", "500", "--cafe_hash_rate", "0.5",
             "--mini_batch_size", "2048", "--learning_rate", "0.1",
             "--bf16", "true", "--sparse_apply_impl", "dense",
             "--test_mini_batch_size", "2048"]


T0 = time.perf_counter()


def emit(obj) -> None:
    """One JSON line, with the seconds since the script started, on
    stdout and appended to OUT_DIR/chip_smoke.jsonl (the whole run: a
    caller may keep only the end of stdout)."""
    line = json.dumps({**obj, "elapsed_s": time.perf_counter() - T0})
    print(line, flush=True)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, "chip_smoke.jsonl"), "a") as f:
        f.write(line + "\n")


def time_ms(fn, reps=30, warmup=3) -> float:
    """Median device time of fn() over `reps` runs, CUDA events. Each run
    is queued behind a ~0.5 ms device sleep, so the events time the
    device's work and not the host's launch latency (a function that
    waits for the device inside, like a boolean-mask index, still
    includes its own wait)."""
    for _ in range(warmup):
        fn()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        torch.cuda._sleep(1_000_000)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return float(np.median([s.elapsed_time(e) for s, e in ev]))


def host_ms(fn, reps=30) -> float:
    """Host time of one fn() call while the device is kept busy (the
    wrapper's own cost: checks, allocation, the ctypes launch)."""
    torch.cuda._sleep(50_000_000)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = (time.perf_counter() - t0) * 1e3 / reps
    torch.cuda.synchronize()
    return t


def graph_ms(fn, calls=20, reps=10) -> float:
    """Per-call device time of `calls` fn() calls captured in one CUDA
    graph: median over `reps` replays, each queued behind a device sleep
    and timed with events around the replay. A capture that fails
    raises."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in ev:
        torch.cuda._sleep(1_000_000)
        start.record()
        graph.replay()
        end.record()
    torch.cuda.synchronize()
    del graph
    return float(np.median([s.elapsed_time(e) for s, e in ev])) / calls


def bound_ms(n_bytes: float, n_ops: float):
    t_bytes, t_ops = n_bytes / HBM_BYTES_PER_S, n_ops / F32_OPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops
                                       else "operations")


def land_case(rng, b, c, n, kind="random"):
    if kind == "all_dropped":            # below 0 and at or past n
        keys = np.concatenate([rng.integers(-60, 0, b // 3),
                               rng.integers(n, n + 50, b - b // 3)])
    elif kind == "key_eq_n":
        keys = np.concatenate([rng.integers(0, n, b - 8), np.full(8, n)])
    elif kind == "sparse_rows":
        keys = rng.choice(np.arange(0, n, 7), b)
    elif kind == "band":                 # empty rows before and after
        keys = rng.integers(n // 3, 2 * n // 3, b)
    elif kind == "hot_run":              # one row takes 20,000 lanes
        keys = np.concatenate([rng.integers(0, n, b - 20000),
                               np.full(20000, n // 2)])
    elif kind == "rows_zero":            # n == 0: every lane dropped
        keys = rng.integers(-5, 50, b)
    else:
        keys = rng.integers(0, n + 7, b)
    keys = np.sort(keys).astype(np.int32)
    enc = np.where(rng.random((b, c)) < 0.6,
                   rng.integers(0, 1 << 30, (b, c)), -1).astype(np.int32)
    return torch.from_numpy(keys).cuda(), torch.from_numpy(enc).cuda()


def phase_kernels(land, scatter_add):
    rng = np.random.default_rng(0)
    out = {}
    # ---- K1: both slice shapes + the edge cases of the card tests
    k1 = []
    for b, c, n, kind in [(53248, 5, 9646, "random"),
                          (36864, 5, 1543432, "random"),
                          (100, 4, 128, "random"), (512, 2, 64, "all_dropped"),
                          (333, 5, 97, "key_eq_n"),
                          (256, 3, 4096, "sparse_rows"),
                          (30000, 5, 5000, "hot_run"),
                          (4096, 5, 200000, "band"),
                          (777, 5, 0, "rows_zero")]:
        keys, enc = land_case(rng, b, c, n, kind)
        got = land.land_max(enc, keys, n)
        again = land.land_max(enc, keys, n)
        want = land.land_max_plain(enc, keys, n)
        torch.cuda.synchronize()
        err = int((got.long() - want.long()).abs().max()) if n else 0
        if err != 0 or got.shape != want.shape:
            raise AssertionError(f"K1 differs from its plain version at "
                                 f"{(b, c, n, kind)}: max err {err}")
        if not torch.equal(got, again):
            raise AssertionError(f"K1: two launches differ at "
                                 f"{(b, c, n, kind)}")
        row = {"shape": [b, c, n], "kind": kind, "max_abs_err": err,
               "two_launches_equal": True}
        if kind == "random":
            out_lib = torch.full((n, c), -1, dtype=torch.int32,
                                 device="cuda")
            keep = (keys >= 0) & (keys < n)
            idx = keys[keep].long()[:, None].expand(-1, c).contiguous()
            src = enc[keep].contiguous()
            bms, by = bound_ms((b * c + b + n * c) * 4, b * c)
            row.update(
                ms=time_ms(lambda: land.land_max(enc, keys, n)),
                graph_ms=graph_ms(lambda: land.land_max(enc, keys, n)),
                host_ms=host_ms(lambda: land.land_max(enc, keys, n)),
                plain_ms=time_ms(lambda: land.land_max_plain(enc, keys, n)),
                library_ms=time_ms(lambda: out_lib.scatter_reduce_(
                    0, idx, src, "amax", include_self=True)),
                bound_ms=bms, bound_by=by)
        k1.append(row)
    out["land_max"] = k1
    emit({"phase": "kernels_land_max", "cases": k1})

    # ---- K2: the sibling's table with Zipf ids, duplicate groups > 1000
    n, d, b = 3232256, 128, 36864
    ranks = (rng.random(b) ** 6 * n).astype(np.int64)
    ids = ((ranks * 1000000007) % n).astype(np.int32)
    ids[rng.choice(b, 24, replace=False)] = -1          # dropped lanes
    ids[rng.choice(b, 24, replace=False)] = n
    table0 = torch.rand((n, d), generator=torch.Generator().manual_seed(1))
    table0 = (table0 - 0.5).cuda()
    upd = torch.from_numpy(
        rng.normal(0, 0.01, (b, d)).astype(np.float32)).cuda()
    row = scatter_add_case(scatter_add, table0, torch.from_numpy(ids).cuda(),
                           upd)
    if row["max_group"] <= 1000:
        raise AssertionError(f"K2 oracle needs a group > 1000 lanes, "
                             f"got {row['max_group']}")
    del table0
    out["scatter_add"] = row
    emit({"phase": "kernels_scatter_add", **row})
    return out


def scatter_add_case(scatter_add, table, ids, upd):
    """K2 against its plain version on one input (dropped lanes below 0
    and at or past the table's rows allowed): within the worst-case f32
    reordering bound, bit-equal on dyadic payloads; timed beside the
    plain version, index_add_ and the memory bound. Raises on a
    disagreement."""
    n, d = table.shape
    b = ids.shape[0]
    keep = (ids >= 0) & (ids < n)
    _, group_sizes = torch.unique(ids[keep], return_counts=True)
    g_max, uniq = int(group_sizes.max()), int(group_sizes.numel())
    before = scatter_add.KERNEL.launches
    got = scatter_add.scatter_add_(table.clone(), ids, upd)
    if scatter_add.KERNEL.launches != before + 1:
        raise AssertionError("K2: the wrapper did not launch the kernel")
    want = scatter_add.scatter_add_plain_(table.clone(), ids, upd)
    err = float((got - want).abs().max())
    # worst-case f32 reordering bound: each of the g_max adds of a group
    # can round by 2^-24 of the running sum, at most |row| + sum |upd|
    tol = g_max * 2.0 ** -24 * (float(table.abs().max())
                                + g_max * float(upd.abs().max()))
    if not err <= tol:
        raise AssertionError(f"K2 differs from its plain version at "
                             f"{(n, d, b)}: {err} > {tol}")
    del got, want
    # the same ids with dyadic payloads (multiples of 2^-10, every row's
    # running sum far below 2^14): f32 adds them exactly in any order, so
    # the kernel must match bit for bit, and a lost or doubled update
    # cannot hide under the reordering bound above
    table_q = torch.round(table * 1024) / 1024
    upd_q = torch.round(upd * 1024) / 1024
    got = scatter_add.scatter_add_(table_q.clone(), ids, upd_q)
    want = scatter_add.scatter_add_plain_(table_q, ids, upd_q)
    err_exact = float((got - want).abs().max())
    if err_exact != 0.0:
        raise AssertionError(f"K2 differs from its plain version on exact "
                             f"dyadic sums at {(n, d, b)}: {err_exact}")
    del got, want, table_q, upd_q
    lib_ids, lib_upd = ids[keep].long(), upd[keep].contiguous()
    bms, by = bound_ms(b * 4 + b * d * 4 + 2 * uniq * d * 4, b * d)
    work = table.clone()
    row = {"shape": [n, d, b], "max_group": g_max, "distinct_rows": uniq,
           "dropped_lanes": int(b - int(keep.sum())),
           "lanes_at_n_rows": int((ids == n).sum()),
           "max_abs_err": err, "tolerance": tol,
           "max_abs_err_dyadic": err_exact,
           "ms": time_ms(lambda: scatter_add.scatter_add_(work, ids, upd)),
           "host_ms": host_ms(
               lambda: scatter_add.scatter_add_(work, ids, upd)),
           "plain_ms": time_ms(
               lambda: scatter_add.scatter_add_plain_(work, ids, upd)),
           "library_ms": time_ms(
               lambda: work.index_add_(0, lib_ids, lib_upd)),
           "bound_ms": bms, "bound_by": by}
    del work
    return row


def headline_cfg(Config, **kw):
    base = dict(dataset="criteo", model="dlrm", embedding_dim=16,
                compress_method="cafe", compress_rate=0.001,
                cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                mini_batch_size=2048, learning_rate=0.1, optimizer="sgd",
                bf16=True, cafe_insert_interval=1)
    base.update(kw)
    return Config(**base)


def drive(build_all, fence, cfg, data, batches, kernels, steps, windows,
          device="cuda", mesh=None):
    """Build the EAGER step on `device` (or on `mesh`), reset the kernel
    counts, run 2 warm-up steps and `windows` timed windows of `steps`
    steps, each ended by the port's fence (a device synchronize); return
    (state, embed, phase record). The graphed steps: phase_graph."""
    _, embed, state, step, _ = build_all(cfg, data, device=device,
                                         mesh=mesh, capture=False)
    fence(state)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    n_run = 0
    for i in range(2):
        state, m = step(state, *batches[i % len(batches)])
        n_run += 1
    fence(state, m)
    win_ms, promos = [], 0
    for _ in range(windows):
        t0 = time.perf_counter()
        for i in range(steps):
            state, m = step(state, *batches[n_run % len(batches)])
            n_run += 1
            promos += m["cafe_promotions"]
        fence(state, m)
        win_ms.append((time.perf_counter() - t0) * 1e3 / steps)
    launches = {name: k.launches for name, k in kernels.items()}
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    ms = float(np.median(win_ms))
    return state, embed, {
        "steps": n_run, "ms_per_step": ms, "window_ms": win_ms,
        "examples_per_s": cfg.mini_batch_size * 1e3 / ms, "loss": loss,
        "promotions": int(promos), "hot_frac": float(m["cafe_hot_frac"]),
        "peak_mem_gb": (torch.cuda.max_memory_allocated() / 2**30
                        if device == "cuda" else None),
        "launches": launches,
        "parts": [type(p).__name__ for p in embed.parts]}


def phase_parity(build_all, from_reference, to_numpy, Config, data,
                 batches_cpu, batches_gpu, impl):
    """3 headline steps on the card and on the CPU from one state, with
    sparse apply `impl` (auto: index_add_; dense: K3 on the card, its
    plain version on the CPU)."""
    cfg = headline_cfg(Config, cafe_use_freq=True, cafe_sketch_threshold=2.0,
                       sparse_apply_impl=impl)
    _, c_embed, c_state, c_step, _ = build_all(cfg, data, device="cpu")
    _, g_embed, _, g_step, _ = build_all(cfg, data, device="cuda")
    g_state = from_reference(c_state, "cuda")
    rec = {"max_abs_diff": {}}
    for i in range(3):
        c_state, cm = c_step(c_state, *batches_cpu[i])
        g_state, gm = g_step(g_state, *batches_gpu[i])
    c, g = to_numpy(c_state), to_numpy(g_state)
    csk, gsk = c["embed"]["part0"]["sketch"], g["embed"]["part0"]["sketch"]
    for f in ("val", "cnt", "dic", "free", "free_top", "tot"):
        if not np.array_equal(csk[f], gsk[f]):
            raise AssertionError(f"sketch {f} differs between card and CPU")
    _, c_aux = c_embed.gather(c_state.embed, batches_cpu[0][1])
    _, g_aux = g_embed.gather(g_state.embed, batches_gpu[0][1])
    if not torch.equal(c_aux["part0"][1], g_aux["part0"][1].cpu()):
        raise AssertionError("routed rows differ between card and CPU")
    # bf16 towers: both round operands to bf16 and multiply in f32; the
    # f32 sums run in other orders, so a value can land one bf16 ulp
    # apart and move later grads by ~0.4%. Over 3 steps at lr 0.1 that
    # stays well below 1e-3.
    tol = 1e-3
    pairs = [("loss", float(cm["loss"]), float(gm["loss"])),
             ("table", c["embed"]["part0"]["table"],
              g["embed"]["part0"]["table"])]
    for tower in ("bot", "top"):
        for j, (cl, gl) in enumerate(zip(c["params"][tower],
                                         g["params"][tower])):
            for k in ("w", "b"):
                pairs.append((f"{tower}{j}.{k}", cl[k], gl[k]))
    for name, cv, gv in pairs:
        diff = float(np.max(np.abs(np.asarray(cv) - np.asarray(gv))))
        rec["max_abs_diff"][name] = diff
        if not diff <= tol:
            raise AssertionError(f"{name} differs by {diff} > {tol}")
    rec.update(impl=impl, tolerance=tol,
               promotions_cpu=int(cm["cafe_promotions"]),
               hot_frac=float(gm["cafe_hot_frac"]), sketch_equal=True,
               routing_equal=True)
    return rec


def phase_profile(build_all, cfg, data, batches, name, mesh=None,
                  capture=False, landings=1):
    """Trace 5 steps of `cfg` (eager, or with `capture` the replayed
    graph: 3 calls before the window warm it up and capture it); write
    the kernel table to OUT_DIR. A step must run `landings` K1 kernels
    (1 for the v1 sketch, 0 for CAFE+) and no fill kernel."""
    from torch.profiler import ProfilerActivity, profile
    _, _, state, step, _ = build_all(cfg, data, device="cuda", mesh=mesh,
                                     capture=capture)
    if capture and not step.graphed:
        raise AssertionError(f"profile {name}: the step is not graphed")
    for i in range(3):
        state, _ = step(state, *batches[i])
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for i in range(5):
            state, _ = step(state, *batches[i % len(batches)])
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    avgs = prof.key_averages()
    # device kernels only (aten ops also carry their kernels' time)
    dev = [(a.key, getattr(a, "self_device_time_total",
                           getattr(a, "self_cuda_time_total", 0)), a.count)
           for a in avgs if a.device_type == torch.autograd.DeviceType.CUDA]
    dev = sorted([x for x in dev if x[1] > 0], key=lambda x: -x[1])
    busy_us = sum(x[1] for x in dev)
    ours = [x for x in dev if "land_max_kernel" in x[0]
            or "fill_kernel" in x[0] or "scatter_add_kernel" in x[0]
            or "rowsum_" in x[0] or "cafe_rowsum" in x[0]
            or "a2a_send_kernel" in x[0]]
    # the v1 sketch insert's landing: K1's one kernel a step, no fill pass
    landing = sum(c for k, _, c in dev if "land_max_kernel" in k) / 5
    fills = [k for k, _, _ in dev if "fill_kernel" in k]
    if landing != landings or fills:
        raise AssertionError(f"profile {name}: {landing} landing kernels a "
                             f"step (want {landings}), fill kernels {fills}")
    os.makedirs(OUT_DIR, exist_ok=True)
    key = ("self_device_time_total"
           if hasattr(avgs[0], "self_device_time_total")
           else "self_cuda_time_total")
    with open(os.path.join(OUT_DIR, f"profile_{name}.txt"), "w") as f:
        f.write(avgs.table(sort_by=key, row_limit=60))
    return {"steps": 5, "wall_ms_per_step": wall_us / 5e3,
            "device_busy_ms_per_step": busy_us / 5e3,
            "device_idle_share": (1.0 - busy_us / wall_us) if dev else None,
            "kernels_per_step": sum(x[2] for x in dev) / 5,
            "landing_kernels_per_step": landing,
            "top_kernels": [{"name": k[:80], "ms_per_step": t / 5e3,
                             "calls_per_step": c / 5}
                            for k, t, c in dev[:10] + ours]}


GRAPH_STEPS, GRAPH_WINDOWS = 20, 5
# the replay gates' 12 batches: full ones, a tail and an empty batch
GATE_VALIDS = [2048, 2048, 2048, 2048 - 301, 2048, 0, 2048, 2048, 2047,
               2048, 2048, 2048]


def _order(windows):
    """Eager and graphed windows in turns, each pair's order flipped:
    e g g e e g ..."""
    return [m for w in range(windows)
            for m in (("eager", "graphed") if w % 2 == 0
                      else ("graphed", "eager"))]


def phase_graph(build_all, build_train_step, warmup_calls, fence, cfg, data,
                batches, kernels, steps=GRAPH_STEPS, windows=GRAPH_WINDOWS,
                per_replay_want=None, counter=None):
    """The eager and the graphed train step of `cfg` on one state, in
    alternating windows of `steps` steps that end in a synchronize:
    ms/step (median of `windows` each, and the windows), peak memory
    (and what was allocated before the build),
    capture time, and the kernel launches a graphed step counted per
    replay, which must equal what its capture recorded and
    `per_replay_want` (default: K1 once). With `counter` (fire_counter),
    its hook runs before every step and its count is the record's
    `fires`."""
    gc.collect()
    torch.cuda.empty_cache()
    allocated_before = torch.cuda.memory_allocated()
    model, embed, state, g_step, _ = build_all(cfg, data, device="cuda")
    if not g_step.graphed:
        raise AssertionError(f"{cfg.embedding_dim}-dim step not graphed: "
                             f"{g_step.capture_blockers}")
    before_step, read_fires = counter(embed) if counter else (None, None)
    e_step = build_train_step(model, embed, cfg, capture=False)
    steppers = {"eager": e_step, "graphed": g_step}
    n = 0

    def run(step, count):
        nonlocal state, n
        for _ in range(count):
            if before_step is not None:
                before_step(state)
            state, m = step(state, *batches[n % len(batches)])
            n += 1
        fence(state, m)
        return m

    for k in kernels.values():
        k.launches = 0
    run(g_step, warmup_calls + 1)          # warm-up calls, then capture
    run(e_step, 2)
    per_replay = g_step.launches_per_replay()
    times = {"eager": [], "graphed": []}
    peak = {"eager": [0, 0], "graphed": [0, 0]}
    graphed_launches = {name: 0 for name in kernels}
    for mode in _order(windows):
        before = {name: k.launches for name, k in kernels.items()}
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        m = run(steppers[mode], steps)
        times[mode].append((time.perf_counter() - t0) * 1e3 / steps)
        peak[mode] = [max(peak[mode][0], torch.cuda.max_memory_allocated()),
                      max(peak[mode][1], torch.cuda.max_memory_reserved())]
        if mode == "graphed":
            for name, k in kernels.items():
                graphed_launches[name] += k.launches - before[name]
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    per_step = {name: v / (windows * steps)
                for name, v in graphed_launches.items() if v}
    if per_step != {name: float(v) for name, v in per_replay.items()}:
        raise AssertionError(f"graphed launches a step {per_step} differ "
                             f"from the capture's {per_replay}")
    want = per_replay_want or {"land_max": 1}
    if any(per_replay.get(k, 0) != v for k, v in want.items()):
        raise AssertionError(f"launches a replay {per_replay}, want {want}")
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    return {"graphed": True, "steps": n, "windows": windows,
            "steps_per_window": steps,
            "eager_ms_per_step": med["eager"],
            "graphed_ms_per_step": med["graphed"],
            "eager_window_ms": times["eager"],
            "graphed_window_ms": times["graphed"],
            "speedup": med["eager"] / med["graphed"],
            "graphed_examples_per_s": cfg.mini_batch_size * 1e3
            / med["graphed"],
            "peak_allocated_gb": {k: v[0] / 2**30 for k, v in peak.items()},
            "allocated_before_gb": allocated_before / 2**30,
            "peak_reserved_gb": {k: v[1] / 2**30 for k, v in peak.items()},
            "capture_s": g_step.capture_s,
            "launches_per_replay": per_replay, "loss": loss,
            "launches": {name: k.launches for name, k in kernels.items()},
            **({"fires": read_fires(state)} if counter else {})}


def lane_grads(model, embed, state, dense, ids, labels, valid, bce):
    """d loss / d gathered rows of every part, as the train step takes
    them (its weights, loss and autograd leaves), from `state`."""
    raws, auxs = embed.gather(state.embed, ids)
    raws = {k: v.detach().requires_grad_() for k, v in raws.items()}
    w = (torch.arange(ids.shape[0], device=ids.device) < valid).float()
    with torch.enable_grad():
        p = model.apply(state.params, dense,
                        embed.transform(state.embed_dense, raws))
        grads = torch.autograd.grad(bce(p, labels, w, w.sum()),
                                    [raws[k] for k in sorted(raws)])
    return dict(zip(sorted(raws), grads)), auxs


def reorder_bound(table, rows, upd):
    """The f32 reordering bound of one scatter-add of `upd` into `table`
    at `rows` (phase_kernels' K2 bound): each of the g_max adds of the
    largest group may round by 2^-24 of its running sum."""
    _, groups = torch.unique(rows.reshape(-1), return_counts=True)
    g_max = int(groups.max())
    return g_max * 2.0 ** -24 * (float(table.abs().max())
                                 + g_max * float(upd.abs().max()))


def _bits(t):
    return t.reshape(-1).contiguous().view(torch.uint8)


def _equal_except(a, b, skip):
    """Paths of the tensors of two TrainStates that differ bit for bit,
    those in `skip` left out."""
    out = []

    def walk(x, y, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], y[k], f"{path}/{k}")
        elif isinstance(x, (list, tuple)):
            for i, (u, v) in enumerate(zip(x, y)):
                walk(u, v, f"{path}[{i}]")
        elif isinstance(x, torch.Tensor) and path not in skip \
                and not torch.equal(_bits(x), _bits(y)):
            out.append(path)
    walk(a._asdict(), b._asdict(), "")
    return out


def cafe_key(embed):
    """(part, its state key) of the layer's CAFE part (a layer whose small
    fields stay full has it after the full table)."""
    i = next(i for i, p in enumerate(embed.parts)
             if type(p).__name__ == "CafePart")
    return embed.parts[i], f"part{i}"


def count_fires(fires, part, sk):
    """Add to `fires` whether the next CAFE+ insert from sketch state `sk`
    resets (real_n past 1.2 x lim) and decays (decay_acc x alpha past V):
    host reads, so eager runs only. Nothing for a v1 part."""
    if not getattr(part, "plus", False):
        return
    cfg = part.sketch_cfg
    fires["reset"] += int(cfg.adjust_threshold
                          and int(sk["real_n"]) > int(cfg.lim * 1.2))
    fires["decay"] += int(float(sk["decay_acc"] * float(np.float32(
        cfg.alpha))) > 10000.0)


def fire_counter(embed):
    """(before_step hook, read) counting on the card how often the next
    CAFE+ insert resets and decays: two compares and one add a step, no
    host read, so the timed windows can carry it."""
    part, key = cafe_key(embed)
    cfg = part.sketch_cfg
    acc = torch.zeros(2, dtype=torch.int32, device=part.device)
    trip, alpha = int(cfg.lim * 1.2), float(np.float32(cfg.alpha))

    def before_step(state):
        sk = state.embed[key]["sketch"]
        acc.add_(torch.stack([sk["real_n"] > trip,
                              sk["decay_acc"] * alpha > 10000.0]))

    def read(state):
        sk = state.embed[key]["sketch"]
        reset, decay = (int(x) for x in acc.cpu())
        return {"reset": reset, "decay": decay, "trip": trip,
                "final": {k: float(sk[k]) for k in ("threshold", "real_n",
                                                     "decay_acc", "step")}}
    return before_step, read


def gate_replay(build_all, build_train_step, clone_state, from_reference,
                to_numpy, bce, cfg, data, batches, exact_tables):
    """Replayed steps against eager ones, with frequency scores (integer
    counts, so no float sum can move the sketch):

    * trajectory: from one start state, the eager and the graphed step
      over the 12 GATE_VALIDS batches (a tail, an empty batch): sketch,
      tick, step, promotions and routed rows bit-equal; with
      `exact_tables` (a deterministic apply) the tables, params and
      metrics too; else their largest differences are recorded;
    * per step: before each of the 12 steps the graphed state is cloned,
      the eager step runs on the clone and the graphed one on the state:
      every tensor and metric bit-equal, the tables bit-equal with
      `exact_tables`, else apart by at most twice the reordering bound of
      the step's scatter-add (reorder_bound: float atomics in index_add_
      and K2 sum in no fixed order, and each order lies within the bound
      of the exact sums)."""
    model, embed, state0, g_step, _ = build_all(cfg, data, device="cuda")
    if not g_step.graphed:
        raise AssertionError("gate: the step is not graphed")
    e_step = build_train_step(model, embed, cfg, capture=False)
    start = to_numpy(state0)
    del state0

    def batch(i):
        return (*batches[i % len(batches)][:3], GATE_VALIDS[i])

    cafe, key = cafe_key(embed)

    def routed(state):
        _, aux = embed.gather(state.embed, batches[0][1])
        return aux[key][1]

    runs = {}
    fires = {"reset": 0, "decay": 0}
    for name, step in (("eager", e_step), ("graphed", g_step)):
        st, ms = from_reference(start, "cuda"), []
        for i in range(len(GATE_VALIDS)):
            if name == "eager":
                count_fires(fires, cafe, st.embed[key]["sketch"])
            st, m = step(st, *batch(i))
            ms.append({k: v.clone() for k, v in m.items()})
        runs[name] = (st, ms)
    torch.cuda.synchronize()
    (e_st, e_ms), (g_st, g_ms) = runs["eager"], runs["graphed"]
    ints = [f"/embed/{p}/{k}" for p in e_st.embed
            for k in ("tick", "sketch") if k in e_st.embed[p]]
    diff = _equal_except(e_st, g_st, skip=())
    bad_int = [d for d in diff if d == "/step"
               or any(d.startswith(i) for i in ints)]
    promos = [[float(m["cafe_promotions"]) for m in ms]
              for ms in (e_ms, g_ms)]
    if bad_int or promos[0] != promos[1] \
            or not torch.equal(routed(e_st), routed(g_st)):
        raise AssertionError(f"gate trajectory: integer state differs "
                             f"{bad_int}, promotions {promos}")
    if sum(promos[0]) == 0:
        raise AssertionError("gate: no id promoted")
    metric_diff = max(float((em[k] - gm[k]).abs().max())
                      for em, gm in zip(e_ms, g_ms) for k in em)
    if exact_tables and (diff or metric_diff != 0.0):
        raise AssertionError(f"gate trajectory: {diff} differ, metrics by "
                             f"{metric_diff}")
    e_np, g_np = to_numpy(e_st), to_numpy(g_st)
    traj = {"steps": len(GATE_VALIDS), "valids": GATE_VALIDS,
            "integer_state_equal": True, "promotions": promos[1],
            "plus_fires": fires if cafe.plus else None,
            "float_leaves_differing": diff,
            "max_abs_diff_metrics": metric_diff,
            "max_abs_diff_tables": {
                p: float(np.max(np.abs(e_np["embed"][p]["table"]
                                       - g_np["embed"][p]["table"])))
                for p in e_np["embed"]},
            "max_abs_diff_params": float(max(
                np.max(np.abs(a[k] - b[k]))
                for t in ("bot", "top")
                for a, b in zip(e_np["params"][t], g_np["params"][t])
                for k in ("w", "b")))}
    del runs, e_st, e_np, g_np

    tables = {p: f"/embed/{p}/table" for p in g_st.embed}
    per_step = []
    eager_twice = []
    for i in range(len(GATE_VALIDS)):
        x = clone_state(g_st)
        # a second eager step from the same state: how far two eager
        # steps' float-atomic sums land apart (0 where none are)
        x2 = None if exact_tables else clone_state(g_st)
        grads, auxs = lane_grads(model, embed, x, *batch(i), bce)
        bounds = {}
        for p, g in grads.items():
            rows = auxs[p][1] if isinstance(auxs[p], tuple) else auxs[p]
            bounds[p] = reorder_bound(x.embed[p]["table"], rows,
                                      cfg.learning_rate * g)
        ex, em = e_step(x, *batch(i))
        if x2 is not None:
            x2, _ = e_step(x2, *batch(i))
            eager_twice.append(max(float(
                (ex.embed[p]["table"] - x2.embed[p]["table"]).abs().max())
                for p in tables))
        g_st, gm = g_step(g_st, *batch(i))
        torch.cuda.synchronize()
        diff = _equal_except(ex, g_st, skip=set(tables.values()))
        bad_m = [k for k in em if not torch.equal(_bits(em[k]),
                                                  _bits(gm[k]))]
        errs = {p: float((ex.embed[p]["table"] - g_st.embed[p]["table"])
                         .abs().max()) for p in tables}
        # each order lies within the bound of the exact sums, so two
        # orders lie within twice it of each other
        bad_t = [p for p, e in errs.items()
                 if e > (0.0 if exact_tables else 2.0 * bounds[p])]
        if diff or bad_m or bad_t:
            raise AssertionError(f"gate step {i}: {diff} and metrics "
                                 f"{bad_m} differ; tables {errs} against "
                                 f"{bounds}")
        per_step.append({"table_max_abs_diff": errs, "bound": bounds})
        del x, x2, ex
    return {"exact_tables": exact_tables, "trajectory": traj,
            "per_step": {"steps": len(per_step),
                         "other_state_and_metrics_equal": True,
                         "eager_vs_eager_table_max_abs_diff": eager_twice,
                         "table_max_abs_diff": max(
                             max(r["table_max_abs_diff"].values())
                             for r in per_step),
                         "largest_share_of_allowed": max(
                             e / (2.0 * r["bound"][p]) if not exact_tables
                             else 0.0 for r in per_step
                             for p, e in r["table_max_abs_diff"].items()),
                         "tightest_bound": min(min(r["bound"].values())
                                               for r in per_step)}}


def phase_eval_graph(build_all, cfg, data, batches, warmup_calls,
                     calls=GRAPH_STEPS, windows=GRAPH_WINDOWS):
    """The eager and the graphed eval step on one trained headline state:
    scores bit-equal batch for batch, then alternating windows of
    `calls` calls (ms a call, median of `windows` each)."""
    model, embed, state, step, g_eval = build_all(cfg, data, device="cuda")
    _, _, _, _, e_eval = build_all(cfg, data, device="cuda", capture=False)
    if not g_eval.graphed or e_eval.graphed:
        raise AssertionError("eval_graph: the eval steps are not "
                             "(graphed, eager)")
    for i in range(4):
        state, _ = step(state, *batches[i])
    for i in range(warmup_calls + len(batches)):
        dense, sparse, _, _ = batches[i % len(batches)]
        got = g_eval(state, dense, sparse).clone()
        want = e_eval(state, dense, sparse)
        if not torch.equal(got, want):
            raise AssertionError(f"eval_graph: scores of batch {i} differ")
    times = {"eager": [], "graphed": []}
    for mode in _order(windows):
        ev = g_eval if mode == "graphed" else e_eval
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for i in range(calls):
            p = ev(state, *batches[i % len(batches)][:2])
        torch.cuda.synchronize()
        times[mode].append((time.perf_counter() - t0) * 1e3 / calls)
    med = {mode: float(np.median(t)) for mode, t in times.items()}
    del p
    return {"graphed": True, "scores_equal_batches": warmup_calls
            + len(batches), "calls_per_window": calls, "windows": windows,
            "eager_ms_per_call": med["eager"],
            "graphed_ms_per_call": med["graphed"],
            "eager_window_ms": times["eager"],
            "graphed_window_ms": times["graphed"],
            "speedup": med["eager"] / med["graphed"],
            "capture_s": g_eval.capture_s}


# K3's stages by kernel name: the prep kernel, CUB's radix sort (its
# kernels carry rowsum.cu's wrapped namespace; in this window nothing
# else sorts), the tile kernel and the fix-up kernel
ROWSUM_STAGES = (("prep", "rowsum_prep_kernel"),
                 ("sort", "DeviceRadixSort"),
                 ("sum", "rowsum_tile_kernel"),
                 ("fixup", "rowsum_fixup_kernel"))


def stage_ms(fn, stages, reps=20):
    """Device ms a call of fn() per stage, summed over the kernels whose
    names hold the stage's pattern, from a torch.profiler window of
    `reps` calls."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    out = {f"{name}_ms": 0.0 for name, _ in stages}
    for a in prof.key_averages():
        if a.device_type != torch.autograd.DeviceType.CUDA:
            continue
        t = getattr(a, "self_device_time_total",
                    getattr(a, "self_cuda_time_total", 0))
        for name, pattern in stages:
            if pattern in a.key:
                out[f"{name}_ms"] += t / reps / 1e3
    return out


def rowsum_case(rowsum, table, ids, upd, stages=True):
    """K3 against its plain version on one input: a record with its
    times (with `stages`, each stage's from a profiler window). Raises on
    a disagreement."""
    n, d = table.shape
    b = ids.shape[0]
    keep = (ids >= 0) & (ids < n)
    kept = ids[keep].long()
    _, run_sizes = torch.unique(kept, return_counts=True)
    g_max, uniq = int(run_sizes.max()), int(run_sizes.numel())
    before = rowsum.KERNEL.launches
    got = rowsum.sparse_add_dense_(table.clone(), ids, upd)
    if rowsum.KERNEL.launches != before + 1:
        raise AssertionError("K3: the wrapper did not launch the kernel")
    again = rowsum.sparse_add_dense_(table.clone(), ids, upd)
    want = rowsum.sparse_add_dense_plain_(table.clone(), ids, upd)
    err = float((got - want).abs().max())
    # worst-case f32 reordering bound of the longest run (the plain
    # version's index_add_ uses atomics on the card), as for K2
    tol = g_max * 2.0 ** -24 * (float(table.abs().max())
                                + g_max * float(upd.abs().max()))
    if not err <= tol:
        raise AssertionError(f"K3 differs from its plain version: {err} > "
                             f"{tol}")
    if not torch.equal(got, again):
        raise AssertionError("K3: two launches on one input differ")
    # dyadic payloads (multiples of 2^-10, every sum far below 2^14): f32
    # adds them exactly in any order, so K3 must match bit for bit
    table_q = torch.round(table * 1024) / 1024
    upd_q = torch.round(upd * 1024 * 8) / 1024
    got_q = rowsum.sparse_add_dense_(table_q.clone(), ids, upd_q)
    want_q = rowsum.sparse_add_dense_plain_(table_q, ids, upd_q)
    err_exact = float((got_q - want_q).abs().max())
    if err_exact != 0.0:
        raise AssertionError(f"K3 differs from its plain version on exact "
                             f"dyadic sums: {err_exact}")
    del got, again, want, table_q, upd_q, got_q, want_q
    lib_upd = upd[keep].contiguous()
    work = table.clone()
    if stages:
        stages = stage_ms(lambda: rowsum.sparse_add_dense_(work, ids, upd),
                          ROWSUM_STAGES)
        if not all(v > 0 for v in stages.values()):
            raise AssertionError(f"K3: a stage without device time in the "
                                 f"trace: {stages}")
        stages["kernel_ms"] = stages["sum_ms"] + stages["fixup_ms"]
    bms, by = bound_ms(b * 4 + b * d * 4 + 2 * uniq * d * 4, b * d)
    return {"shape": [n, d, b], "max_run": g_max, "distinct_rows": uniq,
            "dropped_lanes": int(b - kept.numel()),
            "tiles": -(-b // rowsum.TILE), "sort_bits": n.bit_length(),
            "max_abs_err": err, "tolerance": tol,
            "max_abs_err_dyadic": err_exact, "deterministic": True,
            "ms": time_ms(lambda: rowsum.sparse_add_dense_(work, ids, upd)),
            **(stages or {}),
            "host_ms": host_ms(
                lambda: rowsum.sparse_add_dense_(work, ids, upd)),
            "plain_ms": time_ms(
                lambda: rowsum.sparse_add_dense_plain_(work, ids, upd)),
            "library_ms": time_ms(
                lambda: work.index_add_(0, kept, lib_upd)),
            "bound_ms": bms, "bound_by": by}


def phase_rowsum(rowsum, embed, state, batches):
    """K3 at the headline table: the rows the trained CafePart routes one
    batch to (hot and hashed ids of the 26 fields), Zipf ids drawn as
    the sibling's K2 check draws them (runs of thousands of lanes), and
    one row taking every kept lane, with dropped lanes below 0 and at N
    in the last two."""
    rng = np.random.default_rng(2)
    table = state.embed["part0"]["table"].clone()
    n, d = table.shape
    _, aux = embed.gather(state.embed, batches[0][1])
    routed = aux["part0"][1].reshape(-1).to(torch.int32)
    b = routed.shape[0]
    ranks = (rng.random(b) ** 6 * n).astype(np.int64)
    zipf = ((ranks * 1000000007) % n).astype(np.int32)
    dropped = [rng.choice(b, 24, replace=False) for _ in range(2)]
    zipf[dropped[0]], zipf[dropped[1]] = -1, n
    one_row = np.full(b, n // 3, np.int32)
    one_row[dropped[0]], one_row[dropped[1]] = -1, n
    upd = torch.from_numpy(
        rng.normal(0, 0.01, (b, d)).astype(np.float32)).cuda()
    cases = {"routed": rowsum_case(rowsum, table, routed, upd),
             "zipf": rowsum_case(rowsum, table,
                                 torch.from_numpy(zipf).cuda(), upd),
             "one_row": rowsum_case(rowsum, table,
                                    torch.from_numpy(one_row).cuda(), upd)}
    return cases


def gather_case(gather, table, ids, tile=256):
    """K4 against its plain version on one input, bit for bit, timed as
    phase 2. Raises on a disagreement."""
    b = ids.shape[0]
    row_bytes = table.shape[1] * table.element_size()
    before = gather.KERNEL.launches
    got = gather.gather(table, ids, tile)
    want = gather.gather_plain(table, ids, tile)
    torch.cuda.synchronize()
    if gather.KERNEL.launches != before + 1:
        raise AssertionError("K4: the wrapper did not launch the kernel")
    if not torch.equal(got.view(torch.uint8), want.view(torch.uint8)):
        raise AssertionError(f"K4 differs from its plain version at "
                             f"{tuple(table.shape)} {table.dtype}")
    del got, want
    bms, by = bound_ms(2 * b * row_bytes + b * 4, 0)
    # the copy unit the wrapper picks (its output, a fresh allocation, is
    # 256-byte aligned)
    vec = gather.vector_bytes(row_bytes, table.stride(0)
                              * table.element_size(), table.data_ptr(), 256)
    return {"shape": [*table.shape, b], "dtype": str(table.dtype),
            "tile": tile, "vector_bytes": vec,
            "max_abs_err": 0.0,
            "ms": time_ms(lambda: gather.gather(table, ids, tile)),
            "host_ms": host_ms(lambda: gather.gather(table, ids, tile)),
            "plain_ms": time_ms(lambda: gather.gather_plain(table, ids,
                                                            tile)),
            "library_ms": time_ms(lambda: torch.index_select(table, 0, ids)),
            "bound_ms": bms, "bound_by": by}


def phase_gather(gather, embed, state, batches):
    """K4 at decision 4's shape and at the headline table with its routed
    ids (module docstring, phase 13)."""
    rng = np.random.default_rng(3)
    gen = torch.Generator(device="cuda").manual_seed(1)
    big = torch.randn((1 << 22, 128), generator=gen, device="cuda")
    uniform = torch.from_numpy(
        rng.integers(0, 1 << 22, 53248).astype(np.int32)).cuda()
    table = state.embed["part0"]["table"]
    _, aux = embed.gather(state.embed, batches[0][1])
    routed = aux["part0"][1].reshape(-1).to(torch.int32)
    n = 1 << 18
    some = torch.from_numpy(rng.integers(0, n, 53248).astype(np.int32)).cuda()
    words = torch.randn((n, 129), generator=gen, device="cuda")[:, 1:]
    halves = torch.randn((n, 65), generator=gen, device="cuda").to(
        torch.bfloat16)[:, 1:]
    cases = {"decision4": gather_case(gather, big, uniform),
             "b_eq_tile": gather_case(gather, big, uniform[:256])}
    del big
    cases.update(
        headline=gather_case(gather, table, routed),
        headline_bf16=gather_case(gather, table.to(torch.bfloat16), routed),
        view_words=gather_case(gather, words, some),
        view_bytes=gather_case(gather, halves, some, tile=128))
    widths = {k: v["vector_bytes"] for k, v in cases.items()}
    if (widths["decision4"], widths["view_words"],
            widths["view_bytes"]) != (16, 4, 1):
        raise AssertionError(f"K4 cases miss a vector width: {widths}")
    torch.cuda.empty_cache()
    return cases


def write_criteo_memmap(make_criteo_arrays, path, rows):
    """A Criteo-Kaggle-shaped dataset in the reference's binary format."""
    a = make_criteo_arrays(rows)
    a.sparse.tofile(os.path.join(path, "processed_sparse_sep.bin"))
    a.dense.tofile(os.path.join(path, "processed_dense.bin"))
    a.label.astype(np.int32).tofile(os.path.join(path,
                                                 "processed_label.bin"))
    a.counts.astype(np.int32).tofile(os.path.join(path,
                                                  "processed_count.bin"))


def run_cli(main_fn, argv, log_name):
    """main_torch.main(argv) with its prints kept in chiprun_out/."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        result = main_fn(argv)
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, log_name), "w") as f:
        f.write(buf.getvalue())
    return result, buf.getvalue().splitlines()


def cli_timing(main_fn, eager_fn, make_criteo_arrays, kernels):
    """main_torch.main (graphed) and its eager twin in turns on a
    CLI_TIMING_ROWS memmap (192 train batches): one epoch each at
    --steps_per_dispatch 1 and 8, train ms/it the median of the printed
    32-it windows after it 128 (the driver prints every it up to 100,
    each print a synchronize); then the latency protocol of each (eval
    ms/it). K1 and K3 must launch once a step."""
    scratch = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                           "build")
    os.makedirs(scratch, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_timing_", dir=scratch)
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_TIMING_ROWS)
        base = CLI_FLAGS + ["--data_path", root, "--print_freq", "32"]
        out = {"rows": CLI_TIMING_ROWS}
        for mode, k in (("eager", 1), ("graphed", 1), ("graphed", 8),
                        ("eager", 8)):
            for kern in kernels.values():
                kern.launches = 0
            _, lines = run_cli(main_fn if mode == "graphed" else eager_fn,
                               base + ["--steps_per_dispatch", str(k),
                                       "--test_freq", "0"],
                               f"cli_timing_{mode}_k{k}.txt")
            its = [(int(w[3].split("/")[0]), float(w[7]))
                   for w in (ln.split() for ln in lines
                             if ln.startswith("Finished training it "))]
            windows = [ms for it, ms in its if it > 128 and it % 32 == 0]
            launches = {n: kern.launches for n, kern in kernels.items()}
            if len(windows) != 2 or not (launches["land_max"]
                                         == launches["rowsum"] == 192):
                raise AssertionError(f"cli {mode} k={k}: windows {its}, "
                                     f"launches {launches}")
            out[f"{mode}_k{k}"] = {"train_ms_per_it": float(np.median(
                windows)), "windows_ms": windows, "launches": launches}
        for mode in ("graphed", "eager"):
            tb = os.path.join(root, f"tb_latency_{mode}")
            res, _ = run_cli(main_fn if mode == "graphed" else eager_fn,
                             base + ["--test_throughput", "true",
                                     "--tensor_board_filename", tb],
                             f"cli_latency_{mode}.txt")
            out[f"{mode}_latency"] = res["latency"]
        return out
    finally:
        shutil.rmtree(root, ignore_errors=True)


def phase_cli(main_fn, make_criteo_arrays, kernels, device="cuda", extra=(),
              want=None, tag="cli"):
    """Runs A (train + eval + checkpoints), B (inference from the best
    checkpoint) and C (latency protocol) of main_torch.main with CLI_FLAGS
    and `extra`, whose steps replay CUDA graphs on the card (train and
    eval). On the card run A must launch `want` (default K1 and K3 48
    times each); the prints go to OUT_DIR/<tag>_run_*.txt."""
    want = want or {"land_max": 48, "rowsum": 48}
    here = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(here, "build")
    os.makedirs(scratch, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=scratch)
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        base = CLI_FLAGS + ["--data_path", root] + list(extra)
        if device == "cpu":
            base += ["--force_platform", "cpu"]
        model = os.path.join(root, "m")
        tb_a = os.path.join(root, "tb_a")
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res_a, out_a = run_cli(main_fn, base + [
            "--lr_num_warmup_steps", "8", "--lr_decay_start_step", "24",
            "--lr_num_decay_steps", "24", "--print_freq", "8",
            "--test_freq", "24", "--save_model", model, "--save_freq", "20",
            "--tensor_board_filename", tb_a], f"{tag}_run_a.txt")
        wall_a = time.perf_counter() - t0
        launches_a = {name: k.launches for name, k in kernels.items()}
        trained = [ln.split() for ln in out_a
                   if ln.startswith("Finished training it ")]
        its = [int(w[3].split("/")[0]) for w in trained]
        ms_it = [float(w[7]) for w in trained]
        losses = [float(w[-1]) for w in trained]
        evals = [ln for ln in out_a if ln.startswith(" accuracy")]
        if its[-1] != 48 or not all(np.isfinite(losses)):
            raise AssertionError(f"cli run A: its {its}, losses {losses}")
        if len(evals) != 2:
            raise AssertionError(f"cli run A printed {len(evals)} eval "
                                 f"lines, not 2")
        if device == "cuda" and any(launches_a[k] != v
                                    for k, v in want.items()):
            raise AssertionError(f"cli run A: launches {launches_a}, "
                                 f"want {want}")
        for f in ("m", "m.meta.json", "m.latest", "tb_a/scalars.jsonl"):
            if not os.path.exists(os.path.join(root, f)):
                raise AssertionError(f"cli run A wrote no {f}")
        with open(os.path.join(tb_a, "scalars.jsonl")) as f:
            scalars = [json.loads(ln) for ln in f]
        events = {}
        for sc in scalars:
            if sc["tag"] != "Train/Loss":
                events.setdefault(sc["step"], {})[sc["tag"]] = sc["value"]
        best_step = max(events, key=lambda st: (events[st]["Test/Acc"],
                                                -st))
        best = events[best_step]

        res_b, _ = run_cli(main_fn, base + [
            "--load_model", model, "--inference_only", "true",
            "--tensor_board_filename", os.path.join(root, "tb_b")],
            f"{tag}_run_b.txt")
        diffs = {k: abs(v - best["Test/Acc" if k == "accuracy" else k])
                 for k, v in res_b["metrics"].items()}
        if not max(diffs.values()) <= 1e-6:
            raise AssertionError(f"cli run B differs from run A's best "
                                 f"test event: {diffs}")

        tb_c = os.path.join(root, "tb_c")
        for k in kernels.values():
            k.launches = 0
        res_c, _ = run_cli(main_fn, base + [
            "--test_throughput", "true", "--tensor_board_filename", tb_c],
            f"{tag}_run_c.txt")
        launches_c = {name: k.launches for name, k in kernels.items()}
        with open(os.path.join(tb_c, "latency.json")) as f:
            latency = json.load(f)
        if latency != res_c["latency"] or not latency["test"] > 0:
            raise AssertionError(f"cli run C: latency {latency}")
        return {"rows": CLI_ROWS, "run_a": {
                    "its": len(its), "wall_s": wall_a,
                    "ms_per_it_median": float(np.median(ms_it)),
                    "loss_first": losses[0], "loss_last": losses[-1],
                    "eval_lines": evals, "best_event_it": best_step,
                    "best_metrics": best, "launches": launches_a},
                "run_b": {"metrics": res_b["metrics"],
                          "max_abs_diff_vs_run_a_best": max(diffs.values())},
                "run_c": {"latency": latency, "launches": launches_c}}
    finally:
        shutil.rmtree(root, ignore_errors=True)

A2A_IPC = dict(n=4, chunk=13312, dim=16, epochs=3, seed=5)


def a2a_inputs(n, chunk, dim, seed, rank):
    """Rank `rank`'s seeded all-to-all inputs: ids [n, chunk] int32 and
    rows [n, chunk, dim] f32."""
    rng = np.random.default_rng([seed, rank])
    ids = rng.integers(0, 2**31 - 1, (n, chunk), dtype=np.int64)
    return (torch.from_numpy(ids.astype(np.int32)),
            torch.from_numpy(rng.standard_normal((n, chunk, dim),
                                                 dtype=np.float32)))


def a2a_ipc_rank(rank, store, out_dir):
    """One of the 4 processes of the one-card K5 check: a gloo group for
    the IPC handles, card 0 for the data; writes its verdict as JSON."""
    from cafe_tpu_torch.kernels import a2a
    from cafe_tpu_torch.parallel import Mesh
    cfg = A2A_IPC
    n = cfg["n"]
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=n)
    mesh = Mesh(size=n, rank=rank, device=torch.device("cuda", 0),
                group=dist.new_group(list(range(n)), backend="gloo"))
    equal = []
    for e in range(cfg["epochs"]):
        seed = cfg["seed"] + e
        ins = [a2a_inputs(n, cfg["chunk"], cfg["dim"], seed, s)
               for s in range(n)]
        for leg in (0, 1):
            got = a2a.all_to_all(ins[rank][leg].cuda(), mesh).cpu()
            want = torch.stack([ins[s][leg][rank] for s in range(n)])
            equal.append(bool(torch.equal(got, want)))
    torch.cuda.synchronize()
    launches = a2a.KERNEL.launches
    mesh.close()
    dist.destroy_process_group()
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump({"rank": rank, "equal": equal, "launches": launches}, f)


def phase_a2a(a2a, mesh):
    """K5 at n = 1 (headline exchange shapes) and across 4 processes on
    the one card."""
    gen = torch.Generator().manual_seed(4)
    m = 53248
    legs = {"ids": torch.randint(0, 2**31 - 1, (1, m), dtype=torch.int32,
                                 generator=gen).cuda(),
            "rows": torch.randn((1, m, 16), generator=gen).cuda()}
    rec = {"n1": {}}
    for name, x in legs.items():
        got = a2a.all_to_all(x, mesh)
        want = a2a.all_to_all_plain(x, mesh)
        torch.cuda.synchronize()
        if not (torch.equal(got, want) and torch.equal(got, x)):
            raise AssertionError(f"K5 {name} leg differs from its plain "
                                 f"version at n = 1")
        out = torch.empty_like(x)
        nbytes = x.numel() * x.element_size()
        bms, by = bound_ms(2 * nbytes, 0)
        rec["n1"][name] = {
            "shape": list(x.shape), "bytes": nbytes, "max_abs_err": 0.0,
            "ms": time_ms(lambda: a2a.all_to_all(x, mesh)),
            "graph_ms": graph_ms(lambda: a2a.all_to_all(x, mesh)),
            "host_ms": host_ms(lambda: a2a.all_to_all(x, mesh)),
            "plain_ms": time_ms(lambda: a2a.all_to_all_plain(x, mesh)),
            "library_ms": time_ms(lambda: out.copy_(x)),
            "bound_ms": bms, "bound_by": by}

    # 4 processes on card 0, CUDA IPC between them, 3 calls of each leg
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_a2a_",
                            dir=os.path.join(here, "build"))
    ctx = multiprocessing.get_context("spawn")
    n = A2A_IPC["n"]
    procs = [ctx.Process(target=a2a_ipc_rank,
                         args=(r, os.path.join(root, "store"), root))
             for r in range(n)]
    t0 = time.perf_counter()
    try:
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=300)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
    verdicts = []
    for r in range(n):
        path = os.path.join(root, f"rank{r}.json")
        if not os.path.exists(path):
            raise AssertionError(f"K5 IPC check: rank {r} wrote no result "
                                 f"(exit codes {[p.exitcode for p in procs]})")
        with open(path) as f:
            verdicts.append(json.load(f))
    shutil.rmtree(root, ignore_errors=True)
    want_launches = 2 * A2A_IPC["epochs"]
    if not all(all(v["equal"]) and v["launches"] == want_launches
               for v in verdicts):
        raise AssertionError(f"K5 across 4 processes on one card: "
                             f"{verdicts}")
    rec["ipc_one_card"] = {
        **A2A_IPC, "bit_equal_every_rank_every_call": True,
        "launches_per_rank": want_launches,
        "wall_s": time.perf_counter() - t0,
        "timed": False,
        "why_not_timed": "processes sharing one card without MPS run "
                         "time-sliced, not concurrently: a correctness "
                         "check of the IPC writes and flags only"}
    return rec


def phase_sharded_parity(build_all, from_reference, to_numpy, Config, data,
                         batches_cpu, batches_gpu, mesh_gpu, mesh_cpu,
                         plus=False):
    """3 frequency-score steps from one state on the card in each
    exchange mode and on the CPU (gloo, pallas = K5's plain version):
    sketch (v1, or with `plus` CAFE+), routing and promotions equal
    everywhere; tables, params and loss within the bf16-tower bound of
    phase_parity."""
    def cfg(mode):
        return headline_cfg(Config, cafe_use_freq=True,
                            cafe_sketch_threshold=2.0, mesh_shape=1,
                            shard_embeddings=True, shard_exchange=mode,
                            cafe_plus=plus)
    _, _, start, _, _ = build_all(cfg("pallas"), data, mesh=mesh_cpu)
    start = to_numpy(start)          # n = 1: the rank's state is global
    runs = {}
    for name, mesh, batches in (("pallas", mesh_gpu, batches_gpu),
                                ("explicit", mesh_gpu, batches_gpu),
                                ("a2a", mesh_gpu, batches_gpu),
                                ("pallas_cpu", mesh_cpu, batches_cpu)):
        mode = name.split("_")[0]
        _, embed, _, step, _ = build_all(cfg(mode), data, mesh=mesh)
        state = from_reference(start, mesh.device)
        promos = []
        for i in range(3):
            state, m = step(state, *batches[i])
            promos.append(int(m["cafe_promotions"]))
        _, aux = embed.gather(state.embed, batches[0][1])
        runs[name] = (to_numpy(state), float(m["loss"]), promos,
                      aux["part0"][1].cpu())
    ref_state, ref_loss, ref_promos, ref_rows = runs["pallas"]
    rec = {"tolerance": 1e-3, "max_abs_diff": {}, "promotions": ref_promos}
    for name, (st, loss, promos, rows) in runs.items():
        for f in ref_state["embed"]["part0"]["sketch"]:
            if not np.array_equal(st["embed"]["part0"]["sketch"][f],
                                  ref_state["embed"]["part0"]["sketch"][f]):
                raise AssertionError(f"sharded {name}: sketch {f} differs "
                                     f"from the card's pallas run")
        if promos != ref_promos or not torch.equal(rows, ref_rows):
            raise AssertionError(f"sharded {name}: promotions {promos} or "
                                 f"routing differ from the card's pallas "
                                 f"run {ref_promos}")
        diffs = {"loss": abs(loss - ref_loss),
                 "table": float(np.max(np.abs(
                     st["embed"]["part0"]["table"]
                     - ref_state["embed"]["part0"]["table"])))}
        for tower in ("bot", "top"):
            for j, (a, b) in enumerate(zip(st["params"][tower],
                                           ref_state["params"][tower])):
                diffs[f"{tower}{j}"] = float(max(
                    np.max(np.abs(a[k] - b[k])) for k in ("w", "b")))
        rec["max_abs_diff"][name] = diffs
        if not max(diffs.values()) <= rec["tolerance"]:
            raise AssertionError(f"sharded {name} differs from the card's "
                                 f"pallas run: {diffs}")
    if sum(ref_promos) == 0:
        raise AssertionError("sharded parity: no id promoted")
    rec.update(sketch_equal=True, routing_equal=True,
               modes=list(runs))
    return rec


def phase_cli_sharded(main_fn, make_criteo_arrays, kernels):
    """main_torch.main on the memmap with the sharded pallas exchange at
    world size 1: 48 train steps, 2 evals of 8 batches."""
    here = os.path.dirname(os.path.abspath(__file__))
    os.makedirs(os.path.join(here, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_clis_",
                            dir=os.path.join(here, "build"))
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        for k in kernels.values():
            k.launches = 0
        t0 = time.perf_counter()
        res, out = run_cli(main_fn, CLI_FLAGS + [
            "--data_path", root, "--mesh_shape", "1",
            "--shard_embeddings", "true", "--shard_exchange", "pallas",
            "--print_freq", "8", "--test_freq", "24",
            "--tensor_board_filename", os.path.join(root, "tb")],
            "cli_sharded.txt")
        wall = time.perf_counter() - t0
        launches = {name: k.launches for name, k in kernels.items()}
        trained = [ln.split() for ln in out
                   if ln.startswith("Finished training it ")]
        its = [int(w[3].split("/")[0]) for w in trained]
        losses = [float(w[-1]) for w in trained]
        evals = [ln for ln in out if ln.startswith(" accuracy")]
        if its[-1] != 48 or not all(np.isfinite(losses)) or len(evals) != 2:
            raise AssertionError(f"cli_sharded: its {its}, losses {losses}, "
                                 f"{len(evals)} eval lines")
        # 4 K5 calls a train step (fetch ids + rows, apply ids + grads),
        # 2 an eval batch (fetch ids + rows)
        want = {"land_max": 48, "rowsum": 48, "a2a": 4 * 48 + 2 * 2 * 8}
        if any(launches[k] != v for k, v in want.items()):
            raise AssertionError(f"cli_sharded: launches {launches}, "
                                 f"expected {want}")
        return {"its": len(its), "wall_s": wall,
                "ms_per_it_median": float(np.median(
                    [float(w[7]) for w in trained])),
                "loss_first": losses[0], "loss_last": losses[-1],
                "eval_lines": evals, "metrics": res["metrics"],
                "launches": launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


def load_tool(name):
    """A root tool script (tools/<name>.py) as a module."""
    import importlib.util
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(here, "tools", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@contextlib.contextmanager
def tool_log(name):
    """A tool's own prints, kept in chiprun_out/tools_<name>.txt."""
    os.makedirs(OUT_DIR, exist_ok=True)
    with open(os.path.join(OUT_DIR, f"tools_{name}.txt"), "w") as f, \
            contextlib.redirect_stdout(f):
        yield


AB_WINDOWS, AB_STEPS = 2, 20


def check_donate_off(build_all, build_multi_step, Config, data, batches,
                     device="cuda"):
    """The donate_off arm of decision 1: one 8-step dispatch from a state
    leaves that state's tensors unchanged on the card."""
    from cafe_tpu_torch.utils.timing import fence
    cfg = headline_cfg(Config, donate_state=False)
    _, _, state, step, _ = build_all(cfg, data, device=device)
    multi = build_multi_step(step, 8, donate=False)
    fused = tuple(torch.cat([b[j] for b in batches[:8]]) for j in range(3))
    table0 = state.embed["part0"]["table"].clone()
    cnt0 = state.embed["part0"]["sketch"]["cnt"].clone()
    w0 = state.params["top"][0]["w"].clone()
    new, _ = multi(state, *fused, 8 * 2048)
    fence(new)
    unchanged = (torch.equal(state.embed["part0"]["table"], table0)
                 and torch.equal(state.embed["part0"]["sketch"]["cnt"], cnt0)
                 and torch.equal(state.params["top"][0]["w"], w0))
    moved = not torch.equal(new.embed["part0"]["table"], table0)
    if not (unchanged and moved):
        raise AssertionError(f"donate_off: input unchanged {unchanged}, "
                             f"output moved {moved}")
    return {"input_state_unchanged": True, "output_moved": True}


def phase_ab_decisions(ab, kernels, donate_check):
    """The four decisions at full width, AB_WINDOWS x AB_STEPS each, with
    each one's launch counts checked (module docstring, phase 14)."""
    warm, timed = ab.WARMUP, AB_WINDOWS * AB_STEPS
    k = ab.DISPATCH_K
    steps_1 = 2 * (warm + AB_WINDOWS * (AB_STEPS // k)) * k
    want = {1: {"land_max": steps_1, "gather": 0},
            2: {"land_max": 2 * (warm + timed),
                "scatter_add": 2 * (warm + timed), "gather": 0},
            3: {"land_max": 2 * (warm + timed), "gather": 0},
            4: {"gather": warm + timed, "land_max": 0}}
    rec = {"windows": AB_WINDOWS, "steps": AB_STEPS,
           "donate_off_check": donate_check, "decisions": [],
           "launches": {name: 0 for name in kernels}}
    for d in (1, 2, 3, 4):
        for kern in kernels.values():
            kern.launches = 0
        with tool_log(f"ab_decisions_{d}"):
            line = ab.DECISIONS[d](AB_WINDOWS, steps=AB_STEPS,
                                   device="cuda")
        torch.cuda.empty_cache()
        launches = {name: kern.launches for name, kern in kernels.items()}
        bad = {n: (launches[n], v) for n, v in want[d].items()
               if launches[n] != v}
        if bad:
            raise AssertionError(f"ab_decisions {d}: launches (got, want) "
                                 f"{bad}")
        rec["decisions"].append({**line, "launches": launches})
        for name, v in launches.items():
            rec["launches"][name] += v
    return rec


def phase_ab_insert_land(land_tool, kernels):
    """tools/ab_insert_land_torch.py at full width (module docstring,
    phase 15); the tool itself raises if an arm's state differs."""
    for kern in kernels.values():
        kern.launches = 0
    args = land_tool.parse_args(["--windows", str(AB_WINDOWS), "--steps",
                                 str(AB_STEPS)])
    with tool_log("ab_insert_land"):
        records = land_tool.run(args)
    torch.cuda.empty_cache()
    launches = {name: kern.launches for name, kern in kernels.items()}
    eq = [r for r in records if r["level"] == "equal_state"]
    if [r["impl"] for r in eq] != land_tool.IMPLS[1:] or not all(
            r["equal"] for r in eq):
        raise AssertionError(f"ab_insert_land: equal_state {eq}")
    # the pallas arm's inserts only: 6 warm-up + windows x steps at
    # level 1 and again at level 2, and the 4 inserts of the check
    want = 2 * (6 + AB_WINDOWS * AB_STEPS) + 4
    if launches["land_max"] != want:
        raise AssertionError(f"ab_insert_land: K1 launched "
                             f"{launches['land_max']} times, not {want}")
    return {"windows": AB_WINDOWS, "steps": AB_STEPS, "records": records,
            "launches": launches}


def phase_roofline(roofline, kernels):
    """cafe_tpu_torch.tools.roofline at its defaults (phase 16)."""
    for kern in kernels.values():
        kern.launches = 0
    with tool_log("roofline"):
        out = roofline.main([])
    torch.cuda.empty_cache()
    launches = {name: kern.launches for name, kern in kernels.items()}
    iters = 100
    if launches["scatter_add"] != 2 * iters:
        raise AssertionError(f"roofline: K2 launched "
                             f"{launches['scatter_add']} times, not "
                             f"{2 * iters} (optimizer_apply)")
    fracs = {k: v["frac_of_peak"] for k, v in out.items()
             if isinstance(v, dict) and "frac_of_peak" in v}
    stages = [v for v in out.values() if isinstance(v, dict) and "ms" in v]
    if not all(f <= 1.05 for f in fracs.values()) or not all(
            v["ms"] > 0 for v in stages):
        raise AssertionError(f"roofline: a share of the peak above 1.05 "
                             f"(the window's clock is wrong) or a stage "
                             f"without time: {out}")
    return {**out, "launches": launches}


METHOD_STEPS, METHOD_WINDOWS = 20, 3
AE_MAX_IND_RANGE = 65536      # bounds AE pretraining's [B, F, vocab] logits
GATE_STEPS = 3                # 2 warm-up calls and a replay when graphed
DENSE_TOL = 1e-3              # phase_parity's bound for bf16 towers
AE_TOL = 1e-5                 # f32 pretraining, cuBLAS against the CPU


def method_configs(Config):
    """{name: (phase, config)}: the methods at the headline flags (dense
    apply), QR and AdaEmbed at the sibling's, the towers over CAFE."""
    dense = dict(sparse_apply_impl="dense")
    sib = dict(dataset="criteotb", embedding_dim=128, compress_rate=0.1,
               learning_rate=1.0)
    return {
        "qr_add": ("methods", headline_cfg(Config, compress_method="qr",
                                           **dense)),
        "qr_mult": ("methods", headline_cfg(
            Config, compress_method="qr", qr_operation="mult", **dense)),
        "qr_concat": ("methods", headline_cfg(
            Config, compress_method="qr", qr_operation="concat", **dense)),
        "mde": ("methods", headline_cfg(Config, compress_method="mde",
                                        **dense)),
        "off": ("methods", headline_cfg(Config, compress_method="off",
                                        **dense)),
        "hash_weighted": ("methods", headline_cfg(
            Config, compress_method="hash", weighted_pooling="learned",
            **dense)),
        "ae": ("methods", headline_cfg(
            Config, compress_method="ae", max_ind_range=AE_MAX_IND_RANGE,
            **dense)),
        "qr_sibling": ("methods", headline_cfg(Config, compress_method="qr",
                                               **sib)),
        "ada_sibling": ("methods", headline_cfg(
            Config, compress_method="ada", **sib)),
        "wdl": ("towers", headline_cfg(Config, model="wdl", **dense)),
        "dcn": ("towers", headline_cfg(Config, model="dcn", **dense)),
    }


def sparse_updates(part, st, ids, g, aux, lr):
    """[(state key, rows [M], per-lane change [M, d])] of every table
    part.apply_grads scatter-adds into (SGD), computed as it computes
    them: the oracle of gate_card_cpu's bound (and of its kernel
    count)."""
    kind = type(part).__name__
    if kind == "QRPart":
        qi, ri = aux[:2]
        if part.operation == "mult":
            gq, gr = g * aux[3], g * aux[2]
        elif part.operation == "concat":
            gq, gr = g[..., :part.q_dim], g[..., part.q_dim:]
        else:
            gq = gr = g
        out = [("q", qi, -lr * gq), ("r", ri, -lr * gr)]
    elif kind == "HashedTablePart" and part.weighted:
        learned = part.weighted == "learned"
        widx = part._w_index(ids)
        out = [("table", aux[0] if learned else aux,
                -lr * g * st["w"][widx.long()])]
        if learned:
            out.append(("w", widx, -lr * (g * aux[1]).sum(-1,
                                                          keepdim=True)))
    elif kind == "AdaPart":
        gid, rows = aux
        norms = torch.sqrt((g * g).sum(-1) + 1e-30)
        norms = norms * g.shape[0] / (norms.sum(0, keepdim=True) + 1e-30)
        out = [("weight", torch.where(rows > 0, rows, st["weight"].shape[0]),
                -lr * g), ("grad_norm", gid, norms[..., None])]
    elif kind == "AEGroupPart":
        out = []                                  # frozen
    else:
        rows = {"OffPart": lambda a: a[0], "CafePart": lambda a: a[1]}.get(
            kind, lambda a: a)(aux)
        out = [("table", rows, -lr * g)]
    return [(key, rows.reshape(-1), upd.reshape(rows.numel(), -1))
            for key, rows, upd in out]


def predicted_launches(embed, state, batch):
    """Kernel launches one step of `embed` makes, by the apply routes of
    ops/sparse.py: K2 or K3 per scatter-added table, K1 per v1 CAFE part."""
    from cafe_tpu_torch.ops.sparse import _use_dense_rowsum, _use_pallas_apply
    out = {"land_max": 0, "scatter_add": 0, "rowsum": 0}
    for i, p in enumerate(embed.parts):
        st = state.embed[f"part{i}"]
        lanes = batch * len(p.field_idx)
        keys = {"QRPart": ("q", "r"), "AdaPart": ("weight",),
                "AEGroupPart": ()}.get(type(p).__name__, ("table",))
        if getattr(p, "weighted", "") == "learned":
            keys += ("w",)
        for key in keys:
            n, d = st[key].shape
            if _use_pallas_apply(n, d, p.apply_impl):
                out["scatter_add"] += 1
            elif _use_dense_rowsum(n, d, lanes, p.apply_impl):
                out["rowsum"] += 1
        out["land_max"] += type(p).__name__ == "CafePart" and not p.plus
    return out


def phase_method(build_all, fence, cfg, data, batches, kernels,
                 pretrain=None):
    """One configuration through build_all on the card (graphed where
    train/step.capture_blockers is empty): AE pretraining first when
    `pretrain`, then the first step timed alone (AdaEmbed's check and
    rebuild run in it), WARMUP_CALLS more (a graphed step captures on
    the last), METHOD_WINDOWS windows of METHOD_STEPS steps ended by a
    synchronize. Each kernel must launch as predicted_launches says, each
    step. Returns (embed, state, record)."""
    from cafe_tpu_torch.train.capture import WARMUP_CALLS
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    _, embed, state, step, _ = build_all(cfg, data, device="cuda")
    fence(state)
    torch.cuda.reset_peak_memory_stats()
    for k in kernels.values():
        k.launches = 0
    rec = {"allocated_before_gb": before / 2**30,
           "state_gb": (torch.cuda.memory_allocated() - before) / 2**30,
           "graphed": bool(step.graphed),
           "capture_blockers": list(getattr(step, "capture_blockers", [])),
           "parts": [type(p).__name__ for p in embed.parts]}
    if pretrain is not None:
        t0 = time.perf_counter()
        rec["pretrain_batches"] = pretrain(embed, state, data, "cuda")
        fence(state)
        rec["pretrain_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    state, m = step(state, *batches[0])
    fence(state, m)
    rec["first_step_ms"] = (time.perf_counter() - t0) * 1e3
    n = 1
    for _ in range(WARMUP_CALLS):
        state, m = step(state, *batches[n % len(batches)])
        n += 1
    fence(state, m)
    win = []
    for _ in range(METHOD_WINDOWS):
        t0 = time.perf_counter()
        for _ in range(METHOD_STEPS):
            state, m = step(state, *batches[n % len(batches)])
            n += 1
        fence(state, m)
        win.append((time.perf_counter() - t0) * 1e3 / METHOD_STEPS)
    loss = float(m["loss"])
    if not np.isfinite(loss):
        raise AssertionError(f"non-finite loss {loss}")
    launches = {name: k.launches for name, k in kernels.items()}
    per_step = predicted_launches(embed, state, cfg.mini_batch_size)
    want = {name: v * n for name, v in per_step.items()}
    if any(launches[name] != v for name, v in want.items()):
        raise AssertionError(f"launches {launches}, predicted {want}")
    ms = float(np.median(win))
    rec.update(
        steps=n, ms_per_step=ms, window_ms=win,
        examples_per_s=cfg.mini_batch_size * 1e3 / ms, loss=loss,
        # the configuration's own: above what was allocated before it
        peak_allocated_gb=(torch.cuda.max_memory_allocated() - before)
        / 2**30,
        launches=launches, launches_per_step=per_step,
        kernels_launched=sorted(k for k, v in launches.items() if v),
        stats={k: float(v) for k, v in m.items()
               if k not in ("loss", "correct", "weight")})
    return embed, state, rec


def _pairs(card, cpu):
    """(path, card leaf, CPU leaf) of two state trees, as numpy."""
    from cafe_tpu_torch.train.capture import _leaves
    return [(path, a.detach().cpu().numpy(), b.detach().numpy())
            for (path, a), (_, b) in zip(_leaves(card), _leaves(cpu))]


def gate_card_cpu(build_all, from_reference, to_numpy, bce, cfg, data,
                  batches, batches_cpu, pretrain=None, pre_steps=0):
    """GATE_STEPS steps of `cfg` on the card (build_all's default step)
    and on the CPU, each step from one state (the card's, copied to the
    CPU before it); AE pretraining first when `pretrain`, `pre_steps`
    card steps first (a CAFE+ sketch near its reset's trip). For a CAFE+
    part the record counts the resets and decays of the gated steps.

    * integer state (Off's hot_dict, AdaEmbed's dic and step, the CAFE
      sketch) and the rows both route the batch to after the step:
      exactly equal;
    * each scatter-added table (sparse_updates): within twice the f32
      reordering bound of its scatter-add (reorder_bound) plus, per row,
      the sum of |card - CPU| of the lane updates it received (the lane
      gradients come from each device's towers, lane_grads);
    * every other float leaf of the embedding state: bit-equal; dense
      params and projections within DENSE_TOL, the AE tensors after
      pretraining within AE_TOL.
    AdaEmbed's step 1 rebuilds on both (nothing is admitted, so every
    sample churns); the samples themselves differ (CPU and CUDA
    generators)."""
    g_model, g_embed, g_state, g_step, _ = build_all(cfg, data,
                                                     device="cuda")
    c_model, c_embed, _, c_step, _ = build_all(cfg, data, device="cpu",
                                               capture=False)
    lr = cfg.learning_rate
    rec = {"steps": GATE_STEPS, "graphed": bool(g_step.graphed),
           "max_abs_diff": {}, "max_share_of_bound": {}}
    fires = {"reset": 0, "decay": 0}
    for i in range(pre_steps):
        g_state, _ = g_step(g_state, *batches[i % len(batches)])

    def worse(d, key, v):
        d[key] = max(d.get(key, 0.0), v)

    if pretrain is not None:
        c_state = from_reference(to_numpy(g_state), "cpu")
        pretrain(g_embed, g_state, data, "cuda")
        pretrain(c_embed, c_state, data, "cpu")
        for path, a, b in _pairs(g_state.embed, c_state.embed):
            diff = float(np.abs(a - b).max()) if a.size else 0.0
            worse(rec["max_abs_diff"], "pretrain" + path, diff)
            if not diff <= AE_TOL:
                raise AssertionError(f"pretraining: {path} differs by "
                                     f"{diff} > {AE_TOL}")
    for i in range(GATE_STEPS):
        for j, part in enumerate(g_embed.parts):
            count_fires(fires, part, g_state.embed[f"part{j}"].get("sketch"))
        c_state = from_reference(to_numpy(g_state), "cpu")
        gb, cb = batches[i], batches_cpu[i]
        g_grads, g_aux = lane_grads(g_model, g_embed, g_state, *gb, bce)
        c_grads, c_aux = lane_grads(c_model, c_embed, c_state, *cb, bce)
        bounds = {}
        for j, part in enumerate(g_embed.parts):
            key = f"part{j}"
            g_up = sparse_updates(part, g_state.embed[key],
                                  gb[1][:, g_embed._cols[j]], g_grads[key],
                                  g_aux[key], lr)
            c_up = sparse_updates(c_embed.parts[j], c_state.embed[key],
                                  cb[1][:, c_embed._cols[j]], c_grads[key],
                                  c_aux[key], lr)
            for (leaf, rows, upd), (_, _, c_upd) in zip(g_up, c_up):
                table = g_state.embed[key][leaf].reshape(
                    g_state.embed[key][leaf].shape[0], -1)
                keep = (rows >= 0) & (rows < table.shape[0])
                lane_gap = torch.zeros_like(table).index_add_(
                    0, torch.where(keep, rows, 0).long(),
                    (upd - c_upd.cuda()).abs() * keep[:, None])
                # no kept lane (AdaEmbed's first step): nothing may land
                bounds[f"/{key}/{leaf}"] = float(lane_gap.max()) + (
                    2 * reorder_bound(table, rows[keep], upd)
                    if bool(keep.any()) else 0.0)
        g_state, gm = g_step(g_state, *gb)
        c_state, cm = c_step(c_state, *cb)
        for name in gm:
            if name.endswith(("_promotions", "_admitted")) and \
                    int(gm[name]) != int(cm[name]):
                raise AssertionError(f"step {i}: {name} {int(gm[name])} "
                                     f"on the card, {int(cm[name])} on "
                                     f"the CPU")
        worse(rec["max_abs_diff"], "loss",
              abs(float(gm["loss"]) - float(cm["loss"])))
        for path, a, b in _pairs(g_state.embed, c_state.embed):
            if a.dtype.kind in "biu" or path not in bounds:
                if not np.array_equal(a, b):
                    raise AssertionError(f"step {i}: {path} differs "
                                         f"between card and CPU")
                continue
            diff = float(np.abs(a - b).max())
            worse(rec["max_abs_diff"], path, diff)
            worse(rec["max_share_of_bound"], path,
                  diff / bounds[path] if bounds[path] else 0.0)
            if not diff <= bounds[path]:
                raise AssertionError(f"step {i}: {path} differs by {diff} "
                                     f"> its bound {bounds[path]}")
        for f in ("params", "embed_dense"):
            for path, a, b in _pairs(getattr(g_state, f),
                                     getattr(c_state, f)):
                diff = float(np.abs(a - b).max())
                worse(rec["max_abs_diff"], f + path, diff)
                if not diff <= DENSE_TOL:
                    raise AssertionError(f"step {i}: {f}{path} differs by "
                                         f"{diff} > {DENSE_TOL}")
        _, g_aux = g_embed.gather(g_state.embed, gb[1])
        _, c_aux = c_embed.gather(c_state.embed, cb[1])
        for path, a, b in _pairs(g_aux, c_aux):
            if a.dtype.kind in "biu" and not np.array_equal(a, b):
                raise AssertionError(f"step {i}: routed {path} differs "
                                     f"between card and CPU")
    rec.update(integer_state_equal=True, routing_equal=True,
               dense_tolerance=DENSE_TOL, pre_steps=pre_steps,
               plus_fires=fires if any(getattr(p, "plus", False)
                                       for p in g_embed.parts) else None)
    return rec


def method_kernel_cases(name, rowsum, scatter_add, embed, state, batch):
    """K2 and K3 against their plain versions at the shapes a method's
    step gives them: K2 at the sibling QR's q table (its batch's q rows,
    24 lanes moved to n_rows) and AdaEmbed's weight pool (its batch's
    rows, slot-0 lanes at n_rows); K3 at the headline QR's q and r
    tables and Off's table, with the rows they route a batch to (without
    the stage breakdown: late in the run torch.profiler recorded no
    device time; kernels_rowsum has the stages)."""
    if name not in ("qr_sibling", "ada_sibling", "qr_add", "off"):
        return {}
    rng = np.random.default_rng(4)
    _, aux = embed.gather(state.embed, batch[1])
    key = next(f"part{i}" for i, p in enumerate(embed.parts)
               if type(p).__name__ in ("QRPart", "AdaPart", "OffPart"))
    part, st = embed.parts[int(key[4:])], state.embed[key]

    def upd_for(ids, d):
        return torch.from_numpy(rng.normal(
            0, 0.01, (ids.shape[0], d)).astype(np.float32)).cuda()

    if name == "qr_sibling":
        ids = aux[key][0].reshape(-1).to(torch.int32).clone()
        n = st["q"].shape[0]
        ids[torch.from_numpy(rng.choice(ids.shape[0], 24,
                                        replace=False)).cuda()] = n
        return {"scatter_add_q": scatter_add_case(
            scatter_add, st["q"], ids, upd_for(ids, st["q"].shape[1]))}
    if name == "ada_sibling":
        rows = aux[key][1].reshape(-1)
        ids = torch.where(rows > 0, rows, st["weight"].shape[0]).to(
            torch.int32)
        return {"scatter_add_weight": scatter_add_case(
            scatter_add, st["weight"], ids,
            upd_for(ids, st["weight"].shape[1]))}
    if name == "qr_add":
        out = {}
        for leaf, rows in (("q", aux[key][0]), ("r", aux[key][1])):
            ids = rows.reshape(-1).to(torch.int32)
            out[f"rowsum_{leaf}"] = rowsum_case(
                rowsum, st[leaf], ids, upd_for(ids, st[leaf].shape[1]),
                stages=False)
        return out
    ids = aux[key][0].reshape(-1).to(torch.int32)       # off
    return {"rowsum_table": rowsum_case(
        rowsum, st["table"], ids, upd_for(ids, st["table"].shape[1]),
        stages=False)}


def modded_data(CTRArrays, data, batches, mod):
    """`data` and `batches` with every id taken modulo `mod` and the
    vocabularies capped at it, as --max_ind_range makes the loader's."""
    sub = CTRArrays(np.ascontiguousarray(data.sparse % mod), data.dense,
                    data.label, np.minimum(data.counts, mod))
    return sub, [(d, s % mod, l, v) for d, s, l, v in batches]


def phase_cli_methods(main_fn, make_criteo_arrays, kernels, device="cuda"):
    """main_torch.main --compress_method qr --model dcn at the headline
    flags (dense apply) on the CLI_ROWS memmap: 48 graphed steps and 2
    evals, K3 twice a step (q and r) on the card, finite losses."""
    here = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(here, "build")
    os.makedirs(scratch, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_methods_", dir=scratch)
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        for k in kernels.values():
            k.launches = 0
        res, out = run_cli(main_fn, CLI_FLAGS + [
            "--data_path", root, "--compress_method", "qr", "--model", "dcn",
            "--print_freq", "8", "--test_freq", "24",
            "--tensor_board_filename", ""]
            + (["--force_platform", "cpu"] if device == "cpu" else []),
            "cli_qr_dcn.txt")
        launches = {name: k.launches for name, k in kernels.items()}
        trained = [ln.split() for ln in out
                   if ln.startswith("Finished training it ")]
        losses = [float(w[-1]) for w in trained]
        evals = [ln for ln in out if ln.startswith(" accuracy")]
        if int(trained[-1][3].split("/")[0]) != 48 or not all(
                np.isfinite(losses)) or len(evals) != 2:
            raise AssertionError(f"cli qr+dcn: {trained[-1]}, losses "
                                 f"{losses}, {len(evals)} evals")
        if device == "cuda" and launches != {**{n: 0 for n in kernels},
                                             "rowsum": 96}:
            raise AssertionError(f"cli qr+dcn: launches {launches}")
        return {"rows": CLI_ROWS, "its": 48, "loss_first": losses[0],
                "loss_last": losses[-1], "eval_lines": evals,
                "ms_per_it_median": float(np.median(
                    [float(w[7]) for w in trained])),
                "metrics": res["metrics"], "launches": launches}
    finally:
        shutil.rmtree(root, ignore_errors=True)


PLUS_PRE_STEPS = 3            # card steps before the reset's card gate


def plus_configs(Config, cfg128):
    """{name: (config, launches a graph replay must make)} of the CAFE+
    phases: the headline flags (auto and dense apply), the sibling's, and
    the headline with frequency scores and threshold 1, so every placed
    id crosses at once and the reset fires every few steps."""
    plus = dict(cafe_plus=True)
    return {
        "cafe_plus": (headline_cfg(Config, **plus), {"land_max": 0}),
        "cafe_plus_dense": (headline_cfg(Config, sparse_apply_impl="dense",
                                         **plus),
                            {"land_max": 0, "rowsum": 1}),
        "cafe_plus_sibling": (dataclasses.replace(cfg128, **plus),
                              {"land_max": 0, "scatter_add": 1}),
        "cafe_plus_reset": (headline_cfg(Config, cafe_use_freq=True,
                                         cafe_sketch_threshold=1.0, **plus),
                            {"land_max": 0}),
    }


def phase_plus(name, cfg, want, fns, data, batches, batches_cpu, kernels):
    """One CAFE+ configuration: phase_graph (eager and graphed windows,
    the launches a replay makes equal to `want`), how often its reset and
    decay fired in those steps (counted on the card), the replay gate and
    the card-vs-CPU gate (frequency scores; the reset configuration
    keeps its own threshold of 1 and gates from PLUS_PRE_STEPS steps in,
    and must show the reset firing in all three)."""
    (build_all, build_train_step, warmup_calls, fence, clone_state,
     from_reference, to_numpy, bce) = fns
    rec = phase_graph(build_all, build_train_step, warmup_calls, fence, cfg,
                      data, batches, kernels, per_replay_want=want,
                      counter=fire_counter)
    torch.cuda.empty_cache()
    reset = name == "cafe_plus_reset"
    gate_cfg = cfg if reset else dataclasses.replace(
        cfg, cafe_use_freq=True, cafe_sketch_threshold=2.0)
    rec["replay_equals_eager"] = gate_replay(
        build_all, build_train_step, clone_state, from_reference, to_numpy,
        bce, gate_cfg, data, batches,
        exact_tables=cfg.sparse_apply_impl == "dense")
    torch.cuda.empty_cache()
    rec["card_vs_cpu"] = gate_card_cpu(
        build_all, from_reference, to_numpy, bce, gate_cfg, data, batches,
        batches_cpu, pre_steps=PLUS_PRE_STEPS if reset else 0)
    torch.cuda.empty_cache()
    if reset:
        seen = {"windows": rec["fires"]["reset"],
                "replay_gate": rec["replay_equals_eager"]["trajectory"][
                    "plus_fires"]["reset"],
                "card_vs_cpu": rec["card_vs_cpu"]["plus_fires"]["reset"]}
        if not all(seen.values()):
            raise AssertionError(f"{name}: the reset did not fire in each "
                                 f"run: {seen}")
    return rec


def phase_plus_reset_cost(build_all, cfg, data, batches, steps=3):
    """The CAFE+ insert at the shape of `cfg` on the sketch state after
    `steps` eager steps, with the first batch's offset ids and scores of
    1: device ms (a call's share of 5 calls captured in one CUDA graph,
    median of 5 replays) of the speculative reset alone, of the whole
    insert, and of the insert without the reset (adjust_threshold off)."""
    from cafe_tpu_torch.sketch.hotsketch_plus import (_reset,
                                                      sketch_insert_plus)
    _, embed, state, step, _ = build_all(cfg, data, device="cuda",
                                         capture=False)
    for i in range(steps):
        state, _ = step(state, *batches[i])
    part, key = cafe_key(embed)
    sk, pcfg = state.embed[key]["sketch"], part.sketch_cfg
    oids = part._oids(batches[0][1][:, embed._cols[int(key[4:])]]).reshape(-1)
    ones = torch.ones(oids.shape[0], device=oids.device)
    no_reset = pcfg._replace(adjust_threshold=False)

    def ms(fn):
        return graph_ms(fn, calls=5, reps=5)

    rec = {"lim": pcfg.lim, "n1": pcfg.n1, "n2": pcfg.n2,
           "cells": int(sk["cnt1"].numel() + sk["cnt2"].numel()),
           "lanes": int(oids.shape[0]),
           "reset_ms": ms(lambda: _reset(pcfg, sk)),
           "insert_ms": ms(lambda: sketch_insert_plus(pcfg, sk, oids, ones)),
           "insert_without_reset_ms": ms(
               lambda: sketch_insert_plus(no_reset, sk, oids, ones))}
    rec["reset_share_of_insert"] = rec["reset_ms"] / rec["insert_ms"]
    del state, sk
    torch.cuda.empty_cache()
    return rec


def phase_sketch_bench(bench, kernels):
    """tools/sketch_bench_torch.py in this process on a 60,000-id Zipf
    stream (tests/test_sketch_plus.py's recall case: vocabulary 4,000,
    s 1.2, lim 512, threshold 8, batches of 512): CAFE+ recall must clear
    that test's bound of 0.6. Its prints go to OUT_DIR."""
    for kern in kernels.values():
        kern.launches = 0
    with tool_log("sketch_bench"):
        out = bench.main(["--stream_len", "60000", "--vocab", "4000",
                          "--zipf", "1.2", "--buckets", "512",
                          "--threshold", "8", "--batch", "512",
                          "--cells", "4", "--device", "cuda"])
    recall = out["recall_plus"]["cells4"]["recall"]
    if not recall > 0.6:
        raise AssertionError(f"sketch_bench: CAFE+ recall {recall} <= 0.6")
    return {**{k: out[k] for k in ("recall", "recall_plus", "throughput",
                                   "drift", "device")},
            "launches": {name: k.launches for name, k in kernels.items()}}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cafe_tpu_torch.bridge import from_reference, to_numpy
    from cafe_tpu_torch.config import Config, parse_args
    import main_torch
    from cafe_tpu_torch.data import (CTRArrays, make_criteo_arrays,
                                     make_criteo_batches, num_batches)
    from cafe_tpu_torch.kernels import (KERNELS, a2a, build, gather, land,
                                        rowsum, scatter_add)
    from cafe_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from cafe_tpu_torch.tools import roofline
    from cafe_tpu_torch.train import build_all, build_multi_step, run
    from cafe_tpu_torch.train.loop import pretrain_autoencoders
    from cafe_tpu_torch.train.capture import WARMUP_CALLS
    from cafe_tpu_torch.train.step import _bce, build_train_step, clone_state
    from cafe_tpu_torch.utils.timing import fence

    if os.path.exists(os.path.join(OUT_DIR, "chip_smoke.jsonl")):
        os.remove(os.path.join(OUT_DIR, "chip_smoke.jsonl"))
    torch.backends.cuda.matmul.allow_tf32 = False   # f32 towers stay f32
    torch.backends.cudnn.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(smi, flush=True)
    t0 = time.perf_counter()
    reports = build.build()
    emit({"phase": "device", "nvidia_smi": smi,
          "device": torch.cuda.get_device_name(0),
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "build_s": time.perf_counter() - t0,
          "ptxas": {src: [ln.split(":", 1)[-1].strip()
                          for ln in log.splitlines() if "Used" in ln]
                    for src, log in reports.items()}})

    kern = phase_kernels(land, scatter_add)

    data, batches = make_criteo_batches(batch=2048, n_batches=8)
    batches_cpu = [(d.cpu(), s.cpu(), l.cpu(), v)
                   for d, s, l, v in batches[:3]]
    by_path = {}

    def check_launches(name, rec, want):
        for k, n in want.items():
            if rec["launches"][k] != n:
                raise AssertionError(f"{name}: {k} launched "
                                     f"{rec['launches'][k]} times, not {n}")
        by_path[name] = rec["launches"]

    state, embed, head = drive(build_all, fence, headline_cfg(Config), data,
                               batches, KERNELS, HEADLINE_STEPS, WINDOWS)
    check_launches("headline", head, {"land_max": head["steps"]})
    emit({"phase": "headline", **head})

    kern["rowsum"] = phase_rowsum(rowsum, embed, state, batches)
    emit({"phase": "kernels_rowsum", **kern["rowsum"]})
    kern["gather"] = phase_gather(gather, embed, state, batches)
    emit({"phase": "kernels_gather", **kern["gather"]})
    del state, embed

    state, _, dense = drive(build_all, fence,
                            headline_cfg(Config, sparse_apply_impl="dense"),
                            data, batches, KERNELS, HEADLINE_STEPS, WINDOWS)
    del state
    check_launches("headline_dense", dense,
                   {"land_max": dense["steps"], "rowsum": dense["steps"],
                    "scatter_add": 0})
    emit({"phase": "headline_dense", **dense})

    for impl in ("auto", "dense"):
        emit({"phase": "parity", **phase_parity(
            build_all, from_reference, to_numpy, Config, data, batches_cpu,
            batches, impl)})

    cfg128 = headline_cfg(Config, dataset="criteotb", embedding_dim=128,
                          compress_rate=0.1, learning_rate=1.0)
    state, _, sib = drive(build_all, fence, cfg128, data, batches, KERNELS,
                          SIBLING_STEPS, 1)
    del state
    check_launches("sibling", sib, {"land_max": sib["steps"],
                                    "scatter_add": sib["steps"]})
    emit({"phase": "sibling", **sib})
    torch.cuda.empty_cache()

    for name, cfg in (("headline", headline_cfg(Config)),
                      ("headline_dense",
                       headline_cfg(Config, sparse_apply_impl="dense"))):
        emit({"phase": f"profile_{name}", **phase_profile(
            build_all, cfg, data, batches, name)})

    # ---- the compiled step: CUDA graphs beside the eager steps
    in_graphs = {}
    v1_graphed = {}

    def graph_launches():
        return {name: k.graph_launches for name, k in KERNELS.items()}

    def count_in_graphs(path, before):
        in_graphs[path] = {name: n - before[name]
                           for name, n in graph_launches().items()}

    for name, cfg in (("headline_graph", headline_cfg(Config)),
                      ("headline_dense_graph",
                       headline_cfg(Config, sparse_apply_impl="dense")),
                      ("sibling_graph", cfg128)):
        before = graph_launches()
        rec = phase_graph(build_all, build_train_step, WARMUP_CALLS, fence,
                          cfg, data, batches, KERNELS)
        count_in_graphs(name, before)
        by_path[name] = rec["launches"]
        torch.cuda.empty_cache()
        rec["replay_equals_eager"] = gate_replay(
            build_all, build_train_step, clone_state, from_reference,
            to_numpy, _bce, dataclasses.replace(
                cfg, cafe_use_freq=True, cafe_sketch_threshold=2.0),
            data, batches, exact_tables=cfg.sparse_apply_impl == "dense")
        torch.cuda.empty_cache()
        v1_graphed[name] = rec["graphed_ms_per_step"]
        emit({"phase": name, **rec})

    # ---- CAFE+ (the two-tier sketch) graphed beside eager, with its gates
    plus_fns = (build_all, build_train_step, WARMUP_CALLS, fence,
                clone_state, from_reference, to_numpy, _bce)
    for name, (cfg, want) in plus_configs(Config, cfg128).items():
        before = graph_launches()
        rec = phase_plus(name, cfg, want, plus_fns, data, batches,
                         batches_cpu, KERNELS)
        count_in_graphs(name, before)
        by_path[name] = rec["launches"]
        v1 = {"cafe_plus_dense": "headline_dense_graph",
              "cafe_plus_sibling": "sibling_graph"}.get(name,
                                                        "headline_graph")
        rec["v1_graphed_ms_per_step_same_call"] = v1_graphed[v1]
        rec["vs_v1_graphed"] = rec["graphed_ms_per_step"] / v1_graphed[v1]
        emit({"phase": name, **rec})
    for name, cfg in (("headline", headline_cfg(Config, cafe_plus=True)),
                      ("sibling", dataclasses.replace(cfg128,
                                                      cafe_plus=True))):
        emit({"phase": f"plus_reset_cost_{name}", **phase_plus_reset_cost(
            build_all, cfg, data, batches)})
    emit({"phase": "profile_cafe_plus_graph", **phase_profile(
        build_all, headline_cfg(Config, cafe_plus=True), data, batches,
        "cafe_plus_graph", capture=True, landings=0)})
    emit({"phase": "eval_graph", **phase_eval_graph(
        build_all, headline_cfg(Config), data, batches, WARMUP_CALLS)})
    emit({"phase": "profile_headline_graph", **phase_profile(
        build_all, headline_cfg(Config), data, batches, "headline_graph",
        capture=True)})

    before = graph_launches()
    cli = phase_cli(main_torch.main, make_criteo_arrays, KERNELS)
    count_in_graphs("cli", before)
    by_path["cli"] = cli["run_a"]["launches"]
    by_path["cli_throughput"] = cli["run_c"]["launches"]
    emit({"phase": "cli", **cli})
    before = graph_launches()
    clip = phase_cli(main_torch.main, make_criteo_arrays, KERNELS,
                     extra=["--cafe_plus", "true"],
                     want={"land_max": 0, "rowsum": 48}, tag="cli_plus")
    count_in_graphs("cli_plus", before)
    by_path["cli_plus"] = clip["run_a"]["launches"]
    by_path["cli_plus_throughput"] = clip["run_c"]["launches"]
    emit({"phase": "cli_plus", **clip})
    before = graph_launches()
    timing = cli_timing(
        main_torch.main, lambda argv: run(parse_args(argv), capture=False),
        make_criteo_arrays, KERNELS)
    count_in_graphs("cli_timing", before)
    by_path["cli_timing"] = {
        name: sum(r["launches"][name] for r in timing.values()
                  if isinstance(r, dict) and "launches" in r)
        for name in KERNELS}
    emit({"phase": "cli_timing", **timing})

    # ---- the sharded slice at world size 1: NCCL on the card, and a
    # gloo group of 1 for the CPU side of the parity
    maybe_init_distributed(Config(), "cuda")
    mesh_gpu = make_mesh(1, device="cuda")
    mesh_cpu = make_mesh(1, device="cpu")
    kern["a2a"] = phase_a2a(a2a, mesh_gpu)
    emit({"phase": "kernels_a2a", **kern["a2a"]})

    cfg_sh = headline_cfg(Config, mesh_shape=1, shard_embeddings=True,
                          shard_exchange="pallas")
    state, _, shd = drive(build_all, fence, cfg_sh, data, batches, KERNELS,
                          HEADLINE_STEPS, WINDOWS, mesh=mesh_gpu)
    del state
    check_launches("sharded", shd, {"land_max": shd["steps"],
                                    "a2a": 4 * shd["steps"]})
    shd["headline_ms_per_step_same_call"] = head["ms_per_step"]
    shd["vs_headline"] = shd["ms_per_step"] / head["ms_per_step"]
    emit({"phase": "sharded", **shd})
    emit({"phase": "sharded_parity", **phase_sharded_parity(
        build_all, from_reference, to_numpy, Config, data, batches_cpu,
        batches, mesh_gpu, mesh_cpu)})
    emit({"phase": "profile_sharded", **phase_profile(
        build_all, cfg_sh, data, batches, "sharded", mesh=mesh_gpu)})
    cfg_shp = dataclasses.replace(cfg_sh, cafe_plus=True)
    state, _, shp = drive(build_all, fence, cfg_shp, data, batches, KERNELS,
                          HEADLINE_STEPS, 2, mesh=mesh_gpu)
    del state
    check_launches("sharded_plus", shp, {"land_max": 0,
                                         "a2a": 4 * shp["steps"]})
    emit({"phase": "sharded_plus", **shp})
    emit({"phase": "sharded_parity_plus", **phase_sharded_parity(
        build_all, from_reference, to_numpy, Config, data, batches_cpu,
        batches, mesh_gpu, mesh_cpu, plus=True)})

    clis = phase_cli_sharded(main_torch.main, make_criteo_arrays, KERNELS)
    by_path["cli_sharded"] = clis["launches"]
    emit({"phase": "cli_sharded", **clis})
    mesh_gpu.close()
    mesh_cpu.close()
    dist.destroy_process_group()
    torch.cuda.empty_cache()

    # ---- the measurement tools of the hot path (K4's path)
    abd = phase_ab_decisions(
        load_tool("ab_decisions_torch"), KERNELS,
        check_donate_off(build_all, build_multi_step, Config, data,
                         batches))
    by_path["ab_decisions"] = abd["launches"]
    emit({"phase": "ab_decisions", **abd})
    abl = phase_ab_insert_land(load_tool("ab_insert_land_torch"), KERNELS)
    by_path["ab_insert_land"] = abl["launches"]
    emit({"phase": "ab_insert_land", **abl})
    roof = phase_roofline(roofline, KERNELS)
    by_path["roofline"] = roof["launches"]
    emit({"phase": "roofline", **roof})

    # ---- the baseline methods and the other towers, full Kaggle width
    ae_data, ae_batches = modded_data(CTRArrays, data, batches,
                                      AE_MAX_IND_RANGE)
    ae_cpu = [(d.cpu(), s.cpu(), l.cpu(), v) for d, s, l, v in ae_batches]

    def pretrain(embed, state, dat, device):
        return pretrain_autoencoders(embed, state, dat, 2048,
                                     num_batches(dat, 2048), device)

    for name, (phase, cfg) in method_configs(Config).items():
        ae = cfg.method == "ae"
        dat, bats, bats_cpu = ((ae_data, ae_batches, ae_cpu) if ae
                               else (data, batches, batches_cpu))
        before = graph_launches()
        embed, state, rec = phase_method(build_all, fence, cfg, dat, bats,
                                         KERNELS,
                                         pretrain if ae else None)
        count_in_graphs(name, before)
        by_path[name] = rec["launches"]
        graphed_want = name != "ada_sibling"
        if rec["graphed"] != graphed_want:
            raise AssertionError(f"{name}: graphed {rec['graphed']}, "
                                 f"{rec['capture_blockers']}")
        if name == "ada_sibling":
            part = next(p for p in embed.parts if type(p).__name__
                        == "AdaPart")
            st = state.embed[f"part{embed.parts.index(part)}"]
            times = []
            for _ in range(3):
                t0 = time.perf_counter()
                part._rebuild(st)
                fence(st)
                times.append((time.perf_counter() - t0) * 1e3)
            rec.update(hotn=part.hotn, ids=part.total_n,
                       admitted=int((st["dic"] > 0).sum()),
                       rebuild_ms=float(np.median(times)),
                       rebuild_window_ms=times)
        rec["kernel_cases"] = method_kernel_cases(
            name, rowsum, scatter_add, embed, state, bats[0])
        del embed, state
        torch.cuda.empty_cache()
        gate_cfg = cfg if cfg.method != "cafe" else dataclasses.replace(
            cfg, cafe_use_freq=True, cafe_sketch_threshold=2.0)
        rec["card_vs_cpu"] = gate_card_cpu(
            build_all, from_reference, to_numpy, _bce, gate_cfg, dat, bats,
            bats_cpu, pretrain if ae else None)
        torch.cuda.empty_cache()
        emit({"phase": phase, "config": name, **rec})
    clim = phase_cli_methods(main_torch.main, make_criteo_arrays, KERNELS)
    by_path["cli_qr_dcn"] = clim["launches"]
    emit({"phase": "cli_qr_dcn", **clim})
    skb = phase_sketch_bench(load_tool("sketch_bench_torch"), KERNELS)
    by_path["sketch_bench"] = skb["launches"]
    emit({"phase": "sketch_bench", **skb})

    sources = {"land_max": ("cafe_tpu_torch/kernels/land.cu",
                            "cafe_tpu/ops/pallas_land.py:167",
                            kern["land_max"][0]),
               "scatter_add": ("cafe_tpu_torch/kernels/scatter_add.cu",
                               "cafe_tpu/ops/pallas_apply.py:164",
                               kern["scatter_add"]),
               "rowsum": ("cafe_tpu_torch/kernels/rowsum.cu",
                          "cafe_tpu/ops/pallas_rowsum.py:100",
                          kern["rowsum"]["routed"]),
               "gather": ("cafe_tpu_torch/kernels/gather.cu",
                          "cafe_tpu/ops/pallas_gather.py:67",
                          kern["gather"]["decision4"]),
               "a2a": ("cafe_tpu_torch/kernels/a2a.cu",
                       "cafe_tpu/ops/pallas_a2a.py:126",
                       kern["a2a"]["n1"]["rows"])}
    lines = []
    for name, (src, replaces, rec) in sources.items():
        launches = {path: counts[name] for path, counts in by_path.items()}
        graphed = {path: counts[name] for path, counts in in_graphs.items()
                   if counts[name]}
        lines.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches,
            "launches_in_graphs": sum(graphed.values()),
            "launches_in_graphs_by_path": graphed,
            "max_abs_err": rec["max_abs_err"],
            "ms": rec["ms"], "graph_ms": rec.get("graph_ms"),
            "plain_ms": rec["plain_ms"],
            "bound_ms": rec["bound_ms"], "bound_by": rec["bound_by"],
            "library_ms": rec["library_ms"], "shape": rec["shape"]})
    emit({"kernels": lines})
    emit({"ok": True, "device": {"platform": "gpu",
                                 "kind": torch.cuda.get_device_name(0),
                                 "count": torch.cuda.device_count()}})
    return 0


if __name__ == "__main__":
    sys.exit(main())
