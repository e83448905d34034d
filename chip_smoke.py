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
   steps through build_all / train_step; K1 must launch once per step;
4. kernels_rowsum: K3 against its plain version at the headline table
   (27,136 x 16) with 53,248 lanes: the ids the trained CafePart routes
   a batch to, duplicate-heavy Zipf ids, and one row taking every kept
   lane (a run over 208 tiles) — within the f32 reordering bound of the
   longest run, bit-equal on dyadic payloads, and two launches bit-equal
   to each other; timed as phase 2, with each stage's device time (prep,
   sort, sum, fix-up) read by kernel name from a torch.profiler window;
5. headline_dense: the headline with --sparse_apply_impl dense; K1 and K3
   must each launch once per step;
6. parity: 3 headline steps on the card and on the CPU from one state
   (frequency scores, low threshold so ids promote), for the auto and the
   dense sparse apply: sketch and routing equal, loss / params / table
   within a stated tolerance;
7. sibling: the dim-128 config (cr 0.1, lr 1.0, CriteoTB towers on the
   Kaggle vocabularies; a 3.2M-row table) — K1 and K2 must launch;
8. profile: 5 headline steps (auto and dense) under torch.profiler —
   device busy time, idle share, kernels per step (tables in
   chiprun_out/); the landing must be one kernel a step (K1's
   land_max_kernel, no fill kernel);
9. cli: main_torch.main on a Criteo-Kaggle-shaped memmap in the
   reference's binary format (114,688 rows: 48 train and 8 test batches
   of 2048) with the headline flags, --sparse_apply_impl dense and an lr
   schedule: run A trains, evaluates twice and checkpoints (K1 and K3
   must launch 48 times); run B loads the best checkpoint and must
   reproduce run A's metrics there; run C measures the latency protocol;
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
   this process at full width, 3 windows x 20 steps: four report lines,
   K4 launched 10 + 3 x 20 times in decision 4, K1 once a step in
   decisions 1-3 and K2 once a step in decision 2; before them, the
   donate_off arm's multi-step must leave its input state unchanged;
15. ab_insert_land: tools/ab_insert_land_torch.py (level 1, the equal-state
   check of all four landing arms, level 2), 3 windows x 20 steps; only
   the pallas arm launches K1, once an insert;
16. roofline: cafe_tpu_torch.tools.roofline at its default shapes: K2
   launched by optimizer_apply, every frac_of_peak <= 1.05.
The tools' own prints go to chiprun_out/tools_*.txt.

Then the kernels line (every kernel's launches on the main path, error,
times, bound and, for K1 and K5, graph_ms) and, last, the device line.
Exits non-zero without a CUDA card or without the cafe_tpu_torch package
beside it.
"""

import contextlib
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
CLI_FLAGS = ["--dataset", "criteo", "--embedding_dim", "16",
             "--compress_method", "cafe", "--compress_rate", "0.001",
             "--cafe_sketch_threshold", "500", "--cafe_hash_rate", "0.5",
             "--mini_batch_size", "2048", "--learning_rate", "0.1",
             "--bf16", "true", "--sparse_apply_impl", "dense",
             "--test_mini_batch_size", "2048"]


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


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
    _, group_sizes = np.unique(ids[(ids >= 0) & (ids < n)],
                               return_counts=True)
    g_max = int(group_sizes.max())
    if g_max <= 1000:
        raise AssertionError(f"K2 oracle needs a group > 1000 lanes, "
                             f"got {g_max}")
    table0 = torch.rand((n, d), generator=torch.Generator().manual_seed(1))
    table0 = (table0 - 0.5).cuda()
    upd = torch.from_numpy(
        rng.normal(0, 0.01, (b, d)).astype(np.float32)).cuda()
    tids = torch.from_numpy(ids).cuda()
    got = scatter_add.scatter_add_(table0.clone(), tids, upd)
    want = scatter_add.scatter_add_plain_(table0.clone(), tids, upd)
    err = float((got - want).abs().max())
    # worst-case f32 reordering bound: each of the g_max adds of a group
    # can round by 2^-24 of the running sum, at most |row| + sum |upd|
    tol = g_max * 2.0 ** -24 * (0.5 + g_max * float(upd.abs().max()))
    if not err <= tol:
        raise AssertionError(f"K2 differs from its plain version: {err} > "
                             f"{tol}")
    # the same ids with dyadic payloads (multiples of 2^-10, every row's
    # running sum far below 2^14): f32 adds them exactly in any order, so
    # the kernel must match bit for bit, and a lost or doubled update
    # cannot hide under the reordering bound above
    table_q = torch.round(table0 * 1024) / 1024
    upd_q = torch.round(upd * 1024) / 1024
    got = scatter_add.scatter_add_(table_q.clone(), tids, upd_q)
    want = scatter_add.scatter_add_plain_(table_q, tids, upd_q)
    err_exact = float((got - want).abs().max())
    if err_exact != 0.0:
        raise AssertionError(f"K2 differs from its plain version on exact "
                             f"dyadic sums: {err_exact}")
    del got, want, table_q, upd_q
    keep = (tids >= 0) & (tids < n)
    lib_ids, lib_upd = tids[keep].long(), upd[keep].contiguous()
    uniq = len(group_sizes)
    bms, by = bound_ms(b * 4 + b * d * 4 + 2 * uniq * d * 4, b * d)
    work = table0.clone()
    row = {"shape": [n, d, b], "max_group": g_max, "distinct_rows": uniq,
           "max_abs_err": err, "tolerance": tol,
           "max_abs_err_dyadic": err_exact,
           "ms": time_ms(lambda: scatter_add.scatter_add_(work, tids, upd)),
           "host_ms": host_ms(
               lambda: scatter_add.scatter_add_(work, tids, upd)),
           "plain_ms": time_ms(
               lambda: scatter_add.scatter_add_plain_(work, tids, upd)),
           "library_ms": time_ms(
               lambda: work.index_add_(0, lib_ids, lib_upd)),
           "bound_ms": bms, "bound_by": by}
    del work, table0
    out["scatter_add"] = row
    emit({"phase": "kernels_scatter_add", **row})
    return out


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
    """Build on `device` (or on `mesh`), reset the kernel counts, run 2
    warm-up steps and `windows` timed windows of `steps` steps, each
    ended by the port's fence (a device synchronize); return (state,
    embed, phase record)."""
    _, embed, state, step, _ = build_all(cfg, data, device=device,
                                         mesh=mesh)
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


def phase_profile(build_all, cfg, data, batches, name, mesh=None):
    """Trace 5 steps of `cfg`; write the kernel table to chiprun_out/."""
    from torch.profiler import ProfilerActivity, profile
    _, _, state, step, _ = build_all(cfg, data, device="cuda", mesh=mesh)
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
    # the sketch insert's landing: K1's one kernel a step, no fill pass
    landing = sum(c for k, _, c in dev if "land_max_kernel" in k) / 5
    fills = [k for k, _, _ in dev if "fill_kernel" in k]
    if landing != 1 or fills:
        raise AssertionError(f"profile {name}: {landing} landing kernels a "
                             f"step (want 1), fill kernels {fills}")
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


def rowsum_case(rowsum, table, ids, upd):
    """K3 against its plain version on one input: a record with its
    times. Raises on a disagreement."""
    n, d = table.shape
    b = ids.shape[0]
    keep = (ids >= 0) & (ids < n)
    kept = ids[keep].long()
    _, run_sizes = torch.unique(kept, return_counts=True)
    g_max, uniq = int(run_sizes.max()), int(run_sizes.numel())
    got = rowsum.sparse_add_dense_(table.clone(), ids, upd)
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
    stages = stage_ms(lambda: rowsum.sparse_add_dense_(work, ids, upd),
                      ROWSUM_STAGES)
    if not all(v > 0 for v in stages.values()):
        raise AssertionError(f"K3: a stage without device time in the "
                             f"trace: {stages}")
    bms, by = bound_ms(b * 4 + b * d * 4 + 2 * uniq * d * 4, b * d)
    return {"shape": [n, d, b], "max_run": g_max, "distinct_rows": uniq,
            "dropped_lanes": int(b - kept.numel()),
            "tiles": -(-b // rowsum.TILE), "sort_bits": n.bit_length(),
            "max_abs_err": err, "tolerance": tol,
            "max_abs_err_dyadic": err_exact, "deterministic": True,
            "ms": time_ms(lambda: rowsum.sparse_add_dense_(work, ids, upd)),
            "kernel_ms": stages["sum_ms"] + stages["fixup_ms"], **stages,
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


def phase_cli(main_fn, make_criteo_arrays, kernels, device="cuda"):
    """Runs A (train + eval + checkpoints), B (inference from the best
    checkpoint) and C (latency protocol) of main_torch.main."""
    here = os.path.dirname(os.path.abspath(__file__))
    scratch = os.path.join(here, "build")
    os.makedirs(scratch, exist_ok=True)
    root = tempfile.mkdtemp(prefix="chip_smoke_cli_", dir=scratch)
    try:
        write_criteo_memmap(make_criteo_arrays, root, CLI_ROWS)
        base = CLI_FLAGS + ["--data_path", root]
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
            "--tensor_board_filename", tb_a], "cli_run_a.txt")
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
        if device == "cuda" and not (launches_a["land_max"]
                                     == launches_a["rowsum"] == 48):
            raise AssertionError(f"cli run A: launches {launches_a}, "
                                 f"K1 and K3 must launch 48 times")
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
            "cli_run_b.txt")
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
            "cli_run_c.txt")
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
                         batches_cpu, batches_gpu, mesh_gpu, mesh_cpu):
    """3 frequency-score steps from one state on the card in each
    exchange mode and on the CPU (gloo, pallas = K5's plain version):
    sketch, routing and promotions equal everywhere; tables, params and
    loss within the bf16-tower bound of phase_parity."""
    def cfg(mode):
        return headline_cfg(Config, cafe_use_freq=True,
                            cafe_sketch_threshold=2.0, mesh_shape=1,
                            shard_embeddings=True, shard_exchange=mode)
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
        for f in ("val", "cnt", "dic", "free", "free_top", "tot"):
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


AB_WINDOWS, AB_STEPS = 3, 20


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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from cafe_tpu_torch.bridge import from_reference, to_numpy
    from cafe_tpu_torch.config import Config
    import main_torch
    from cafe_tpu_torch.data import make_criteo_arrays, make_criteo_batches
    from cafe_tpu_torch.kernels import (KERNELS, a2a, build, gather, land,
                                        rowsum, scatter_add)
    from cafe_tpu_torch.parallel import make_mesh, maybe_init_distributed
    from cafe_tpu_torch.tools import roofline
    from cafe_tpu_torch.train import build_all, build_multi_step
    from cafe_tpu_torch.utils.timing import fence

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

    cli = phase_cli(main_torch.main, make_criteo_arrays, KERNELS)
    by_path["cli"] = cli["run_a"]["launches"]
    by_path["cli_throughput"] = cli["run_c"]["launches"]
    emit({"phase": "cli", **cli})

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
        lines.append({
            "name": name, "route": "cuda", "source": src,
            "replaces": replaces, "launches": sum(launches.values()),
            "launches_by_path": launches, "max_abs_err": rec["max_abs_err"],
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
