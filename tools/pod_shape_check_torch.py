#!/usr/bin/env python3
"""Pod-shape equivalence check, loss for loss, for the PyTorch / CUDA port
(cafe_tpu_torch; no jax). Port of tools/pod_shape_check.py.

The JAX tool starts main.py as 4 processes of 2 devices each on the
two-level (dcn, ici) mesh (dcn = the process boundary) with the
unique-compact exchange, and holds every printed loss within 1e-6 across
processes and within max(2e-3, 2e-3 * loss) of one process with 8
devices. In the port one process is one rank:

  --device cpu   8 processes of main_torch.py (gloo; one torch thread
                 each), a (4, 2) mesh through --mesh_inner 2
  --device cuda  4 processes on 4 cards (NCCL), a (2, 2) mesh; fewer
                 cards raise

each joined through --dist_num_processes / --dist_process_id /
--dist_coordinator on a free port. The JAX tool's one process with 8
devices has no counterpart (one process is one device here), so the
reference run is main_torch.py on one device with the same flags less
--shard_embeddings, --mesh_inner and --shard_unique_frac. Every rank's
printed losses lie within 1e-6 of rank 0's, rank 0's within the JAX
tool's bound of the one-device run's, and every iteration the one-device
run prints is printed by every rank. Exit code 1 on a mismatch, naming
the iteration and both losses. Every pipe is drained at once and every
child is killed on a failure, as in the JAX tool.

    python3 tools/pod_shape_check_torch.py [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import re
import socket
import subprocess
import sys
import tempfile
import threading
from typing import Dict, List

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tools/pod_shape_check.py:10-16, less its platform pin
FLAGS = ["--dataset", "synthetic", "--synthetic_rows", "8192",
         "--synthetic_fields", "4", "--synthetic_vocab", "20000",
         "--embedding_dim", "8", "--mini_batch_size", "128",
         "--test_mini_batch_size", "1024", "--nepochs", "1", "--print_freq",
         "16", "--test_freq", "0", "--compress_method", "cafe",
         "--compress_rate", "0.05", "--cafe_sketch_threshold", "5",
         "--shard_embeddings", "true", "--mesh_inner", "2",
         "--shard_unique_frac", "0.5"]
LOSS_RE = re.compile(r"it (\d+)/\d+ .*?, ([0-9.]+) ms/it, loss ([0-9.]+)")
MESH_ONLY = ("--shard_embeddings", "--mesh_inner", "--shard_unique_frac")
PROCESSES = {"cpu": 8, "cuda": 4}
RANK_TOL = 1e-6


class Mismatch(Exception):
    """The ranks' losses disagree with each other or with one device."""


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def single_flags(flags: List[str]) -> List[str]:
    """`flags` less the mesh's flags and their values."""
    out, skip = [], False
    for f in flags:
        if skip:
            skip = False
        elif f in MESH_ONLY:
            skip = True
        else:
            out.append(f)
    return out


def launch(argvs: List[List[str]], cwds: List[str], timeout: float
           ) -> List[str]:
    """main_torch.py once per argv, all at once, each with one torch
    thread; their outputs. Every pipe is drained concurrently (the ranks
    step together: reading them one by one can deadlock once a writer
    fills its pipe) and every child is killed on any failure."""
    env = {**os.environ, "OMP_NUM_THREADS": "1", "MKL_NUM_THREADS": "1"}
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "main_torch.py")] + argv,
        cwd=cwd, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
        text=True) for argv, cwd in zip(argvs, cwds)]
    outs = [""] * len(procs)

    def drain(i, p):
        outs[i] = p.communicate()[0]

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    try:
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=timeout)
        if any(t.is_alive() for t in threads):
            raise TimeoutError(f"{len(procs)} processes exceeded {timeout}s")
        for i, (p, out) in enumerate(zip(procs, outs)):
            if p.returncode != 0:
                raise RuntimeError(f"process {i} exited with "
                                   f"{p.returncode}:\n{out[-3000:]}")
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    return outs


def losses(out: str) -> Dict[int, float]:
    return {int(m.group(1)): float(m.group(3))
            for m in LOSS_RE.finditer(out)}


def compare(rank_outs: List[str], single_out: str) -> List[int]:
    """The JAX tool's checks (tools/pod_shape_check.py:50-54); the
    iterations checked. Raises Mismatch naming the iteration and both
    losses."""
    ls, lr = [losses(o) for o in rank_outs], losses(single_out)
    if not lr or not ls[0]:
        raise Mismatch(f"no loss lines: rank 0 printed {len(ls[0])}, one "
                       f"device {len(lr)}")
    for r, lx in enumerate(ls):
        missing = sorted(set(lr) - set(lx))
        extra = sorted(set(lx) - set(lr))
        if missing or extra:
            raise Mismatch(f"rank {r}: iterations {missing} of the "
                           f"one-device run missing, {extra} extra")
    for it in sorted(lr):
        for r, lx in enumerate(ls[1:], 1):
            if not abs(lx[it] - ls[0][it]) < RANK_TOL:
                raise Mismatch(f"it {it}: rank {r} loss {lx[it]} against "
                               f"rank 0's {ls[0][it]} (tolerance "
                               f"{RANK_TOL})")
        tol = max(2e-3, 2e-3 * lr[it])
        if not abs(ls[0][it] - lr[it]) < tol:
            raise Mismatch(f"it {it}: rank 0 loss {ls[0][it]} against one "
                           f"device's {lr[it]} (tolerance {tol})")
    return sorted(lr)


def run(device: str = "cuda", flags: List[str] = FLAGS, n: int = None,
        timeout: float = 1500.0) -> Dict:
    """The pod shape on `n` processes (default 8 on the CPU, 4 on cards)
    beside one device; raises Mismatch on a disagreement."""
    n = n or PROCESSES[device]
    if device == "cuda":
        cards = torch.cuda.device_count() if torch.cuda.is_available() \
            else 0
        if cards < n:
            raise RuntimeError(f"pod_shape_check: {n} processes need {n} "
                               f"CUDA cards (one NCCL rank each); found "
                               f"{cards}")
    plat = ["--force_platform", "cpu"] if device == "cpu" else []
    addr = f"localhost:{free_port()}"
    ranks = [flags + plat + ["--dist_num_processes", str(n),
                             "--dist_process_id", str(i),
                             "--dist_coordinator", addr] for i in range(n)]
    with tempfile.TemporaryDirectory() as tmp:
        cwds = [os.path.join(tmp, f"rank{i}") for i in range(n)] \
            + [os.path.join(tmp, "single")]
        for d in cwds:
            os.makedirs(d)
        outs = launch(ranks + [single_flags(flags) + plat], cwds, timeout)
    inner = int(flags[flags.index("--mesh_inner") + 1])
    iters = compare(outs[:n], outs[n])
    ls, lr = losses(outs[0]), losses(outs[n])
    return {"processes": n, "mesh": [n // inner, inner], "device": device,
            "iters": iters, "losses": [ls[i] for i in iters],
            "one_device_losses": [lr[i] for i in iters],
            "outputs": outs}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    try:
        res = run(args.device)
    except Mismatch as e:
        print(f"FAIL: {e}", file=sys.stderr)
        return 1
    d, i = res["mesh"]
    backend = "NCCL" if args.device == "cuda" else "gloo"
    gaps = [abs(a - b) for a, b in zip(res["losses"],
                                       res["one_device_losses"])]
    worst = max(range(len(gaps)), key=gaps.__getitem__)
    print(f"largest gap to one device: {gaps[worst]!r} at it "
          f"{res['iters'][worst]} ({res['losses'][worst]!r} against "
          f"{res['one_device_losses'][worst]!r})")
    print(f"{res['processes']}-process x 1-device ({d}x{i} dcn/ici, "
          f"mesh_inner {i}, unique-compact, {backend}) == single-process "
          f"1-device: OK")
    print("iters checked:", res["iters"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
