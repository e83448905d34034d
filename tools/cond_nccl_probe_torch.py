#!/usr/bin/env python3
"""Which NCCL collectives a CUDA graph of the port can hold, in the main
graph and inside a conditional body (utils/cond.cond), for the PyTorch /
CUDA port (cafe_tpu_torch; no jax).

    python3 tools/cond_nccl_probe_torch.py [--world N]

Starts N processes (default 1), one card each, joined by NCCL in a mesh
(parallel/mesh.make_mesh), and for each collective of the sharded
exchange (all_reduce, all_gather, reduce_scatter, all_to_all_single, and
K5 through kernels/a2a.py: its all-to-all and the device all-gather and
reduce-scatter that the mesh steps' branch bodies hold) x placement
("graph": in the captured graph; "body": inside the true body of a
`cond`) x capture mode ("global", "thread_local"):

1. one eager call (the communicator and K5's workspace exist before any
   capture);
2. the capture; every rank's outcome is shared over a gloo group, and
   the case goes on only if every rank captured;
3. REPLAYS replays with fresh inputs each and the predicate alternating
   (true, false, true, ...), each followed by a synchronize and one
   eager call of the same collective on the same input, which the
   replay must equal bit for bit (a false predicate: zeros).

Prints one JSON line a case from rank 0 ({"case", "captured",
"replays_equal", "error"}), the NCCL version and NCCL_GRAPH_MIXING_SUPPORT
as the environment sets it, then the card's name and power limit. Exit 0
when every rank ran every case to its end (a refused capture is a
result, not a failure); 1 without CUDA cards or when a rank failed.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import traceback

import torch
import torch.distributed as dist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REPLAYS = 4
ROWS, DIM = 4096, 16


def collectives(mesh):
    """{name: fn(x [n*ROWS, DIM] f32) -> tensor}, each one collective."""
    from cafe_tpu_torch.kernels import a2a
    from cafe_tpu_torch.parallel import exchange as ex
    n = mesh.size
    return {
        "all_reduce": lambda x: ex.psum(x, mesh),
        "all_gather": lambda x: ex.all_gather(x, mesh),
        "reduce_scatter": lambda x: ex.psum_scatter(x, mesh),
        "all_to_all_single": lambda x: a2a.all_to_all_plain(
            x.reshape(n, -1, DIM), mesh),
        "k5": lambda x: a2a.all_to_all(x.reshape(n, -1, DIM), mesh),
        "k5_all_gather": lambda x: a2a.all_gather(x, mesh),
        "k5_reduce_scatter": lambda x: a2a.psum_scatter(x, mesh),
    }


def _capture(fn, x, pred, placement, mode, dev, shape):
    from cafe_tpu_torch.utils import cond as _cond
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    with _cond.capturing(graph, dev) as cap, \
            torch.cuda.graph(graph, stream=stream, capture_error_mode=mode):
        if placement == "graph":
            out = fn(x)
        else:
            out = _cond.cond(pred, fn, lambda t: t.new_zeros(shape), (x,),
                             name="probe")
    return graph, out, cap


def run_case(mesh, ctrl, name, fn, placement, mode):
    dev = mesh.device
    gen = torch.Generator(device=dev)
    gen.manual_seed(1000 * mesh.rank + 7)
    x = torch.randn(mesh.size * ROWS, DIM, device=dev, generator=gen)
    pred = torch.ones((), dtype=torch.bool, device=dev)
    rec = {"case": f"{name}/{placement}/{mode}", "captured": False,
           "replays_equal": None, "error": None}
    shape = fn(x).shape
    torch.cuda.synchronize()
    graph = out = None
    try:
        graph, out, _ = _capture(fn, x, pred, placement, mode, dev, shape)
        torch.cuda.synchronize()
        ok = 1
    except Exception as e:     # the refusal is the probe's result
        rec["error"] = f"{type(e).__name__}: {e}"[:600]
        ok = 0
        try:
            torch.cuda.synchronize()
        except Exception as e2:
            rec["error"] += f" | then: {e2}"[:300]
    flags = torch.tensor([ok])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=ctrl)
    rec["captured"] = bool(flags.item())
    if not rec["captured"]:
        return rec
    equal = True
    for i in range(REPLAYS):
        take = i % 2 == 0 or placement == "graph"
        x.copy_(torch.randn(x.shape, device=dev, generator=gen))
        pred.fill_(take)
        graph.replay()
        torch.cuda.synchronize()
        got = out.clone()
        want = fn(x) if take else torch.zeros_like(got)
        torch.cuda.synchronize()
        equal &= bool(torch.equal(got, want))
    flags = torch.tensor([int(equal)])
    dist.all_reduce(flags, op=dist.ReduceOp.MIN, group=ctrl)
    rec["replays_equal"] = bool(flags.item())
    del graph, out
    return rec


def rank_main(rank, world, store, out_dir):
    os.environ["LOCAL_RANK"] = str(rank)
    sys.path.insert(0, REPO)
    try:
        from cafe_tpu_torch.parallel import make_mesh
        dist.init_process_group("nccl", init_method=f"file://{store}",
                                rank=rank, world_size=world)
        mesh = make_mesh(world, device="cuda")
        ctrl = dist.new_group(list(range(world)), backend="gloo")
        recs = []
        for name, fn in collectives(mesh).items():
            for placement in ("graph", "body"):
                for mode in ("global", "thread_local"):
                    rec = run_case(mesh, ctrl, name, fn, placement, mode)
                    recs.append(rec)
                    if rank == 0:
                        print(json.dumps(rec), flush=True)
        dist.barrier(group=ctrl)
        mesh.close()
        dist.destroy_process_group()
    except BaseException:
        with open(os.path.join(out_dir, f"error_{rank}.txt"), "w") as f:
            f.write(traceback.format_exc())
        raise


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[1])
    ap.add_argument("--world", type=int, default=1,
                    help="ranks, one card each")
    world = ap.parse_args(argv).world
    if not torch.cuda.is_available():
        print("cond_nccl_probe_torch: needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, REPO)
    from cafe_tpu_torch.kernels import build
    build.build()
    print(json.dumps({"world": world, "torch": torch.__version__,
                      "cuda": torch.version.cuda,
                      "nccl": ".".join(map(str, torch.cuda.nccl.version())),
                      "NCCL_GRAPH_MIXING_SUPPORT":
                          os.environ.get("NCCL_GRAPH_MIXING_SUPPORT")}),
          flush=True)
    os.makedirs(os.path.join(REPO, "build"), exist_ok=True)
    root = tempfile.mkdtemp(prefix="cond_probe_",
                            dir=os.path.join(REPO, "build"))
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=rank_main,
                         args=(r, world, os.path.join(root, "store"), root))
             for r in range(world)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(timeout=600)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for err in sorted(os.listdir(root)):
            if err.startswith("error_"):
                with open(os.path.join(root, err)) as f:
                    print(f.read(), file=sys.stderr)
        shutil.rmtree(root, ignore_errors=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip(), flush=True)
    codes = [p.exitcode for p in procs]
    print(json.dumps({"world": world, "exit_codes": codes}), flush=True)
    return 0 if all(c == 0 for c in codes) else 1


if __name__ == "__main__":
    sys.exit(main())
