#!/usr/bin/env python3
"""K5 and the sharded headline step across the cards of one host, for the
PyTorch / CUDA port (cafe_tpu_torch; no jax).

    python3 tools/a2a_cards_torch.py [--world N] [--phases a2a,steps]

Starts one process per card (N = every visible card, at most 8), joined
by NCCL, and prints one JSON line per phase from rank 0:

1. a2a: the sharded headline's exchange legs at world size N (global
   batch 2048 over Criteo-Kaggle's 26 fields, so m = 53,248 / N lanes a
   rank and C = a2a_cap(m, N)): ids [N, C] int32 and rows [N, C, 16] f32.
   K5 (kernels/a2a.py) must equal its plain version (NCCL
   all_to_all_single) bit for bit on every rank. Both are timed with
   CUDA events over windows of 20 back-to-back calls, median of 5
   windows, each started after a barrier: `ms` queues the window behind
   a device sleep, so it is device time and not the host's enqueue;
   `eager_ms` starts at once (the host's launch cost shows where it is
   the longer). Beside them the least time: the larger of 2 x (N*C*row
   bytes) at 3.35 TB/s and the (N-1)/N of it that leaves the card at
   450 GB/s (NVLink, one direction). Then K5's breakdown, device time a
   call (median) read by kernel name from a torch.profiler window of 20
   calls:
   `send_ms` (a2a_send_kernel), `recv_ms` (a2a_recv_kernel: the wait
   for the peers' parts and the copy out of the receive slots), and
   `copy_out_ms`, the RECV kernel's time when every rank's SEND has
   finished before it starts (kernels/a2a.py `send`, a device
   synchronize and a barrier, then `receive`), so `wait_ms` = recv_ms -
   copy_out_ms. A tree whose a2a.py has no `send` / `receive` reports
   copy_out_ms and wait_ms as null;
   Beside them `graph_ms` and `plain_graph_ms`: 20 calls captured in one
   CUDA graph, replayed behind a device sleep (the call counter of K5's
   workspace lives on the card, so a replay runs its own epoch);
2. steps: the sharded headline (DLRM + CAFE, dim 16, cr 1e-3) and the
   sibling (dim 128, cr 0.1 over the Terabyte vocabularies), bf16
   towers, SGD, on the N-card mesh in the explicit, pallas and a2a
   exchanges, with the unique-compact legs (--shard_unique_frac 0.5)
   and with the insert every 8 ticks, at K = 1 and 8 steps a call: the
   graphed step (2 warm-up calls, a capture) and the eager one
   (capture=False) on one state, in 4 windows each of 5 calls taken in
   turns (e g g e ...), each ended by a device synchronize and a
   barrier: ms/step of each (median), K5 launches per step, the
   exchange's branch runs in the timed windows, peak memory, loss.
   Every configuration must graph on one host (the branches' bodies
   hold K5's device collectives, not NCCL's).

Then the card's name and power limit. Exits non-zero without at least
one CUDA card.
"""

from __future__ import annotations

import gc
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
HBM_BYTES_PER_S = 3.35e12     # H100 SXM data sheet
NVLINK_BYTES_PER_S = 450e9    # H100 SXM NVLink, one direction
BATCH, FIELDS, DIM = 2048, 26, 16


SLEEP_CYCLES = 20_000_000       # ~11 ms at 1.75 GHz: longer than 20 enqueues


def _window_ms(fn, mesh, calls=20, windows=5, behind_sleep=True) -> float:
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        if behind_sleep:
            torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return float(np.median(out))


def _graph_ms(fn, mesh, calls=20, windows=5) -> float:
    """Device ms a call of `calls` fn() calls captured in one CUDA graph,
    the graph replayed behind a device sleep (median of `windows`)."""
    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        for _ in range(calls):
            fn()
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        torch.cuda._sleep(SLEEP_CYCLES)
        start.record()
        graph.replay()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    del graph
    return float(np.median(out))


def _kernel_ms(fn, patterns, mesh, calls=20) -> dict:
    """Median device ms of each kernel-name pattern's launches in a
    profiler window of `calls` fn() calls, started after a barrier (the
    median keeps the first call's wait for the slowest rank out)."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    times = {name: [] for name in patterns}
    for e in prof.events():
        if e.device_type != torch.autograd.DeviceType.CUDA:
            continue
        for name, pattern in patterns.items():
            if pattern in e.name:
                times[name].append(e.time_range.elapsed_us() / 1e3)
    return {name: float(np.median(t)) if t else None
            for name, t in times.items()}


def breakdown(a2a, x, mesh) -> dict:
    """K5's send / recv device time a call back to back, and the RECV
    kernel's time alone when the peers' parts have all arrived."""
    names = {"send_ms": "a2a_send_kernel", "recv_ms": "a2a_recv_kernel"}
    rec = _kernel_ms(lambda: a2a.all_to_all(x, mesh), names, mesh)
    rec.update(copy_out_ms=None, wait_ms=None)
    if hasattr(a2a, "send") and hasattr(a2a, "receive"):
        def apart():
            pending = a2a.send(x, mesh)
            torch.cuda.synchronize()
            dist.barrier(group=mesh.group)
            a2a.receive(pending)
        alone = _kernel_ms(apart, names, mesh)
        rec["copy_out_ms"] = alone["recv_ms"]
        rec["send_alone_ms"] = alone["send_ms"]
        if rec["recv_ms"] is not None and alone["recv_ms"] is not None:
            rec["wait_ms"] = rec["recv_ms"] - alone["recv_ms"]
    every = [None] * mesh.size
    dist.all_gather_object(every, rec, group=mesh.group)
    rec["recv_ms_every_rank"] = [r["recv_ms"] for r in every]
    return rec


def phase_a2a(mesh):
    from cafe_tpu_torch.kernels import a2a
    from cafe_tpu_torch.parallel.exchange import a2a_cap
    n = mesh.size
    m = BATCH // n * FIELDS
    cap = a2a_cap(m, n)
    gen = torch.Generator().manual_seed(100 + mesh.rank)
    legs = {"ids": torch.randint(0, 2**31 - 1, (n, cap), dtype=torch.int32,
                                 generator=gen),
            "rows": torch.randn((n, cap, DIM), generator=gen)}
    rec = {"world": n, "lanes_per_rank": m, "cap": cap}
    for name, x in legs.items():
        x = x.to(mesh.device)
        got = a2a.all_to_all(x, mesh)
        want = a2a.all_to_all_plain(x, mesh)
        torch.cuda.synchronize()
        equal = torch.tensor([int(torch.equal(got, want))],
                             device=mesh.device)
        dist.all_reduce(equal, op=dist.ReduceOp.MIN, group=mesh.group)
        if not bool(equal.item()):
            raise AssertionError(f"K5 {name} leg differs from NCCL on some "
                                 f"rank at world size {n}")
        nbytes = x.numel() * x.element_size()
        t_hbm = 2 * nbytes / HBM_BYTES_PER_S
        t_link = nbytes * (n - 1) / n / NVLINK_BYTES_PER_S
        rec[name] = {"shape": list(x.shape), "bytes": nbytes,
                     "bit_equal_every_rank": True,
                     "ms": _window_ms(lambda: a2a.all_to_all(x, mesh), mesh),
                     "plain_ms": _window_ms(
                         lambda: a2a.all_to_all_plain(x, mesh), mesh),
                     "eager_ms": _window_ms(
                         lambda: a2a.all_to_all(x, mesh), mesh,
                         behind_sleep=False),
                     "plain_eager_ms": _window_ms(
                         lambda: a2a.all_to_all_plain(x, mesh), mesh,
                         behind_sleep=False),
                     "graph_ms": _graph_ms(
                         lambda: a2a.all_to_all(x, mesh), mesh),
                     "plain_graph_ms": _graph_ms(
                         lambda: a2a.all_to_all_plain(x, mesh), mesh),
                     "breakdown": breakdown(a2a, x, mesh),
                     "bound_ms": max(t_hbm, t_link) * 1e3,
                     "bound_by": "bytes (HBM)" if t_hbm >= t_link
                     else "bytes (NVLink)"}
    return rec


STEP_MODELS = {"headline": dict(dataset="criteo", embedding_dim=16,
                                 compress_rate=0.001, learning_rate=0.1),
               "sibling": dict(dataset="criteotb", embedding_dim=128,
                               compress_rate=0.1, learning_rate=1.0)}
# the step configurations: the exchanges, the unique-compact legs and
# the insert interval (their device branches hold collectives)
STEP_CONFIGS = {"explicit": {}, "pallas": {"shard_exchange": "pallas"},
                "a2a": {"shard_exchange": "a2a"},
                "unique": {"shard_unique_frac": 0.5},
                "interval8": {"cafe_insert_interval": 8}}
STEP_KS = (1, 8)
STEP_WINDOWS, STEP_CALLS = 4, 5


def _order(windows):
    """Eager and graphed windows in turns, each pair's order flipped."""
    return [m for w in range(windows)
            for m in (("eager", "graphed") if w % 2 == 0
                      else ("graphed", "eager"))]


def phase_steps(mesh):
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.data import make_criteo_batches
    from cafe_tpu_torch.kernels import a2a
    from cafe_tpu_torch.parallel import batch_slice
    from cafe_tpu_torch.parallel.exchange import exchange_branches
    from cafe_tpu_torch.train import build_all, build_multi_step
    from cafe_tpu_torch.train.capture import WARMUP_CALLS
    from cafe_tpu_torch.train.step import build_train_step
    data, batches = make_criteo_batches(batch=BATCH, n_batches=8,
                                        device="cpu")
    mine = [tuple(t.to(mesh.device) for t in batch_slice(mesh, d, s, lab))
            + (v,) for d, s, lab, v in batches]
    rec = {}
    for model_name, kw in STEP_MODELS.items():
        for mode, extra in STEP_CONFIGS.items():
            cfg = Config(model="dlrm", compress_method="cafe",
                         cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                         mini_batch_size=BATCH, bf16=True,
                         mesh_shape=mesh.size, shard_embeddings=True,
                         **extra, **kw)
            gc.collect()
            torch.cuda.empty_cache()
            model, embed, state, e_one, _ = build_all(cfg, data, mesh=mesh,
                                                      capture=False)
            g_one = build_train_step(model, embed, cfg, mesh)
            if not g_one.graphed:
                raise AssertionError(f"steps {model_name} {mode}: not "
                                     f"graphed: {g_one.capture_blockers}")
            for k in STEP_KS:
                steps = {"eager": e_one, "graphed": g_one}
                bats = mine
                if k > 1:
                    steps = {m: build_multi_step(s, k, donate=True,
                                                 mesh_size=mesh.size)
                             for m, s in steps.items()}
                    bats = [tuple(torch.cat([b[j] for b in mine[:k]])
                                  for j in range(3)) + (k * BATCH,)]
                n = 0

                def run(step, count):
                    nonlocal state, n
                    for _ in range(count):
                        state, m = step(state, *bats[n % len(bats)])
                        n += 1
                    torch.cuda.synchronize()
                    dist.barrier(group=mesh.group)
                    return m

                run(steps["graphed"], WARMUP_CALLS + 1)
                run(steps["eager"], 1)
                times = {m_name: [] for m_name in steps}
                k5 = {m_name: 0 for m_name in steps}
                torch.cuda.reset_peak_memory_stats()
                since = exchange_branches()
                for m_name in _order(STEP_WINDOWS):
                    before = a2a.KERNEL.launches
                    t0 = time.perf_counter()
                    m = run(steps[m_name], STEP_CALLS)
                    times[m_name].append((time.perf_counter() - t0) * 1e3
                                         / (STEP_CALLS * k))
                    k5[m_name] += a2a.KERNEL.launches - before
                calls = STEP_WINDOWS * STEP_CALLS * k
                med = {m_name: float(np.median(t))
                       for m_name, t in times.items()}
                rec[f"{model_name}_{mode}_k{k}"] = {
                    "eager_ms_per_step": med["eager"],
                    "graphed_ms_per_step": med["graphed"],
                    "speedup": med["eager"] / med["graphed"],
                    "window_ms": times, "loss": float(m["loss"]),
                    "a2a_launches_per_step": {
                        m_name: v / calls for m_name, v in k5.items()},
                    "branch_runs": exchange_branches(since),
                    "peak_allocated_gb":
                        torch.cuda.max_memory_allocated() / 2**30,
                    "graphed": True}
            del model, embed, state, e_one, g_one
    return rec


PHASES = {"a2a": phase_a2a, "steps": phase_steps}


def rank_main(rank, world, store, phases):
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, REPO)
    from cafe_tpu_torch.parallel import make_mesh
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = make_mesh(world, device="cuda")
    for name in phases:
        rec = PHASES[name](mesh)
        if rank == 0:
            print(json.dumps({"phase": name, **rec}), flush=True)
    mesh.close()
    dist.destroy_process_group()


def main() -> int:
    if not torch.cuda.is_available():
        print("a2a_cards_torch: needs CUDA cards", file=sys.stderr)
        return 1
    world = min(torch.cuda.device_count(), 8)
    if "--world" in sys.argv:
        world = int(sys.argv[sys.argv.index("--world") + 1])
    phases = list(PHASES)
    if "--phases" in sys.argv:
        phases = sys.argv[sys.argv.index("--phases") + 1].split(",")
        if not set(phases) <= set(PHASES):
            print(f"a2a_cards_torch: phases are {list(PHASES)}",
                  file=sys.stderr)
            return 2
    sys.path.insert(0, REPO)
    from cafe_tpu_torch.kernels import build
    build.build()              # once, before the ranks load the libraries
    ctx = torch.multiprocessing.get_context("spawn")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="a2a_cards_",
                            dir=os.path.join(REPO, "build"))
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, os.path.join(root, "store"),
                               phases))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=900)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    codes = [p.exitcode for p in procs]
    print(json.dumps({"world": world, "exit_codes": codes}), flush=True)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
