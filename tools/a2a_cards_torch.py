#!/usr/bin/env python3
"""K5 and the sharded headline step across the cards of one host, for the
PyTorch / CUDA port (cafe_tpu_torch; no jax).

    python3 tools/a2a_cards_torch.py [--world N]

Starts one process per card (N = every visible card, at most 8), joined
by NCCL, and prints one JSON line per phase from rank 0:

1. a2a: the sharded headline's exchange legs at world size N (global
   batch 2048 over Criteo-Kaggle's 26 fields, so m = 53,248 / N lanes a
   rank and C = a2a_cap(m, N)): ids [N, C] int32 and rows [N, C, 16] f32.
   K5 (kernels/a2a.py) must equal its plain version (NCCL
   all_to_all_single) bit for bit on every rank; both are timed with
   CUDA events over windows of back-to-back calls (median of 5 windows
   of 20, each window started after a barrier), beside the least time:
   the larger of 2 x (N*C*row bytes) at 3.35 TB/s and the (N-1)/N of it
   that leaves the card at 450 GB/s (NVLink, one direction);
2. steps: the sharded headline (DLRM + CAFE, dim 16, cr 1e-3, bf16
   towers, SGD) on the N-card mesh in each exchange mode: ms/step (host
   clock around 3 windows of 10 steps ended by a device synchronize and
   a barrier; median), K5 launches per step, loss.

Then the card's name and power limit. Exits non-zero without at least
one CUDA card.
"""

from __future__ import annotations

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


def _window_ms(fn, mesh, calls=20, windows=5) -> float:
    out = []
    for _ in range(windows):
        torch.cuda.synchronize()
        dist.barrier(group=mesh.group)
        start, end = (torch.cuda.Event(enable_timing=True),
                      torch.cuda.Event(enable_timing=True))
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        torch.cuda.synchronize()
        out.append(start.elapsed_time(end) / calls)
    return float(np.median(out))


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
                     "bound_ms": max(t_hbm, t_link) * 1e3,
                     "bound_by": "bytes (HBM)" if t_hbm >= t_link
                     else "bytes (NVLink)"}
    return rec


def phase_steps(mesh):
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.data import make_criteo_batches
    from cafe_tpu_torch.kernels import a2a
    from cafe_tpu_torch.parallel import batch_slice
    from cafe_tpu_torch.train import build_all
    data, batches = make_criteo_batches(batch=BATCH, n_batches=8,
                                        device="cpu")
    mine = [tuple(t.to(mesh.device) for t in batch_slice(mesh, d, s, lab))
            + (v,) for d, s, lab, v in batches]
    rec = {}
    for mode in ("pallas", "a2a", "explicit"):
        cfg = Config(dataset="criteo", model="dlrm", embedding_dim=DIM,
                     compress_method="cafe", compress_rate=0.001,
                     cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                     mini_batch_size=BATCH, learning_rate=0.1, bf16=True,
                     mesh_shape=mesh.size, shard_embeddings=True,
                     shard_exchange=mode)
        _, _, state, step, _ = build_all(cfg, data, mesh=mesh)
        for i in range(2):
            state, m = step(state, *mine[i])
        a2a.KERNEL.launches = 0
        win, k = [], 2
        for _ in range(3):
            torch.cuda.synchronize()
            dist.barrier(group=mesh.group)
            t0 = time.perf_counter()
            for _ in range(10):
                state, m = step(state, *mine[k % len(mine)])
                k += 1
            torch.cuda.synchronize()
            dist.barrier(group=mesh.group)
            win.append((time.perf_counter() - t0) * 1e3 / 10)
        rec[mode] = {"ms_per_step": float(np.median(win)),
                     "window_ms": win, "loss": float(m["loss"]),
                     "a2a_launches_per_step": a2a.KERNEL.launches / 30}
    return rec


def rank_main(rank, world, store):
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, REPO)
    from cafe_tpu_torch.parallel import make_mesh
    dist.init_process_group("nccl", init_method=f"file://{store}",
                            rank=rank, world_size=world)
    mesh = make_mesh(world, device="cuda")
    for name, fn in (("a2a", phase_a2a), ("steps", phase_steps)):
        rec = fn(mesh)
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
    sys.path.insert(0, REPO)
    from cafe_tpu_torch.kernels import build
    build.build()              # once, before the ranks load the libraries
    ctx = torch.multiprocessing.get_context("spawn")
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="a2a_cards_",
                            dir=os.path.join(REPO, "build"))
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, os.path.join(root, "store")))
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
