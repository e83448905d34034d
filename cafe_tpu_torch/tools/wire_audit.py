"""Wire-traffic audit CLI (port of cafe_tpu/tools/wire_audit.py): run one
train step of YOUR sharded configuration on a mesh, print every
collective with its payload and mesh axis, and pass or fail the O(batch)
contract.

torch has no compiled program to read, so the audit records the calls
themselves: every collective of the sharded step goes through the
wrappers of parallel/exchange.py, which note (op, axis, result bytes)
while `record_collectives` is open; the table is rank 0's. The axis is
"data" for the mesh's flat group and "ici" / "dcn" for the two levels of
a --mesh_inner mesh. Only the branch a step takes is recorded (the JAX
audit sees both branches of a lax.cond). The step is built eager
(capture=False): the wrappers note a collective on the host when it is
called, and a replayed CUDA graph calls none of them, so a graphed step
would record only its capture.

Usage (gloo ranks on the CPU, one process each; no port is opened):
  python -m cafe_tpu_torch.tools.wire_audit --devices 4 \\
      --force_platform cpu --compress_method cafe --compress_rate 0.05 \\
      --synthetic_vocab 262144 --mini_batch_size 512
  python -m cafe_tpu_torch.tools.wire_audit --devices 4 --mesh_inner 2 \\
      --shard_unique_frac 0.25 --force_platform cpu ...
Without --force_platform cpu the ranks are NCCL ranks, one card each.
At --devices 1 (or inside an existing process group) the step runs in
this process: a mesh of one prices the payloads, it moves no bytes.

Exit code 1 if any collective passes the bound max(8*m*(dim+4)*4,
2*dense_bytes) (m = batch lanes), as the JAX tool's.
"""

from __future__ import annotations

import contextlib
import json
import os
import sys
import tempfile
from typing import Dict, List, Optional

import torch
import torch.distributed as dist

TOP = 20


def audit(cfg, mesh) -> Dict:
    """One train step of `cfg` (eager: a replay records nothing) on this
    rank's share of `mesh`,
    from build_all's own state and the first global batch, with every
    collective recorded. Returns this rank's report."""
    from ..data import batch_iterator
    from ..parallel import global_batches
    from ..parallel.exchange import record_collectives
    from ..parallel.sharding import global_like
    from ..train import build_all, get_dataset
    from ..train.step import _leaves
    from ..utils.timing import fence
    from .hlo_traffic import collective_stats
    train = get_dataset(cfg, "train")
    _, embed, state, step, _ = build_all(cfg, train, mesh=mesh,
                                         capture=False)
    first = next(iter(batch_iterator(train, cfg.mini_batch_size,
                                     drop_last=True)))
    dense, sparse, label, valid = next(iter(global_batches(mesh, [first])))
    with record_collectives() as rec:
        state, m = step(state, dense, sparse, label, valid)
        fence(m["loss"])
    like = global_like(state, mesh, embed)
    table_bytes = max([t.numel() * t.element_size()
                       for t in _leaves(like.embed)
                       if isinstance(t, torch.Tensor) and t.dim() == 2]
                      or [0])
    part0_rows = max([t.shape[0] for t in like.embed["part0"].values()
                      if isinstance(t, torch.Tensor) and t.dim() == 2]
                     or [0])
    lanes = cfg.mini_batch_size * train.num_sparse
    dense_bytes = 4 * sum(t.numel() for t in _leaves(state.params))
    bound = max(8 * lanes * (cfg.embedding_dim + 4) * 4, 2 * dense_bytes)
    stats = collective_stats(rec)
    return {"collectives": [list(c) for c in rec],
            "total": stats["total"], "table_bytes": table_bytes,
            "bound": bound, "by_axis": stats["by_axis"],
            "dense_bytes": dense_bytes, "lanes": lanes,
            "over": sum(c.bytes > bound for c in rec),
            "loss": float(m["loss"]), "world": mesh.size,
            "mesh_shape": list(mesh.shape), "part0_rows": part0_rows,
            "hotn": max((getattr(p, "hotn", 0) for p in embed.parts),
                        default=0)}


def report(res: Dict, out=None) -> int:
    """Print the audit's table and verdict (to `out`, default stdout);
    0 on pass, 1 on fail."""
    p = lambda *a: print(*a, file=out or sys.stdout)  # noqa: E731
    stats: List = res["collectives"]
    if not stats:
        p("NO collectives found: nothing is sharded")
        return 1
    p(f"\n{'op':<16}{'bytes':>12}  axis")
    for op, axis, nb in sorted(stats, key=lambda c: -c[2])[:TOP]:
        p(f"{op:<16}{nb:>12}  {axis}")
    if len(stats) > TOP:
        p(f"... {len(stats) - TOP} more")
    p(f"\ntotal collective bytes/step: {res['total']:,} (rank 0 of "
      f"{res['world']}, mesh {tuple(res['mesh_shape'])})")
    p(f"largest table: {res['table_bytes']:,} B; O(batch) per-op bound: "
      f"{res['bound']:,} B")
    p(f"per-axis bytes: {res['by_axis']}")
    if res["over"]:
        big = [c for c in stats if c[2] > res["bound"]]
        p(f"\nFAIL: {len(big)} collective(s) exceed the O(batch) bound "
          f"(table-sized movement):")
        for op, axis, nb in big[:5]:
            p(f"  {op} ({axis}): {nb:,} B")
        return 1
    p("\nPASS: no collective approaches table size")
    return 0


def _device(cfg) -> str:
    return "cpu" if cfg.force_platform == "cpu" else "cuda"


def _rank(rank: int, world: int, store: str, argvs: List[List[str]]
          ) -> None:
    """One spawned rank: join the group (mesh.init_file_group), audit each
    argv on a mesh of its own; rank 0 writes the reports."""
    from ..config import parse_args
    from ..parallel import make_mesh
    from ..parallel.mesh import init_file_group
    torch.set_num_threads(1)
    cfgs = [parse_args(argv) for argv in argvs]
    device = _device(cfgs[0])
    if device == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
    init_file_group("nccl" if device == "cuda" else "gloo", store, rank,
                    world)
    try:
        out = []
        for cfg in cfgs:
            mesh = make_mesh(world, cfg.mesh_inner, device)
            try:
                # the build's prints are not the report: stderr
                with contextlib.redirect_stdout(sys.stderr):
                    out.append(audit(cfg, mesh))
            finally:
                mesh.close()
        if rank == 0:
            with open(os.path.join(store, "report.json"), "w") as f:
                json.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_audit(argv: List[str], devices: int) -> Dict:
    """The audit of `argv` (main_torch.py's flags) on `devices` ranks:
    spawned processes, or this process at one rank or inside an existing
    process group of that size."""
    return run_audits([argv], devices)[0]


def run_audits(argvs: List[List[str]], devices: int) -> List[Dict]:
    """run_audit of each argv, in one set of ranks (every argv on the same
    device: --force_platform cpu in all or none)."""
    from ..config import parse_args
    from ..parallel import make_mesh, maybe_init_distributed
    argvs = [["--dataset", "synthetic", "--shard_embeddings", "true"]
             + list(argv) + ["--mesh_shape", str(devices)]
             for argv in argvs]
    cfgs = [parse_args(argv) for argv in argvs]
    if len({_device(cfg) for cfg in cfgs}) != 1:
        raise ValueError("run_audits: the argvs name different devices")
    if devices == 1 or dist.is_initialized():
        own = maybe_init_distributed(cfgs[0], _device(cfgs[0]))
        try:
            out = []
            for cfg in cfgs:
                mesh = make_mesh(devices, cfg.mesh_inner, _device(cfg))
                try:
                    out.append(audit(cfg, mesh))
                finally:
                    mesh.close()
            return out
        finally:
            if own:
                dist.destroy_process_group()
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as store:
        procs = [ctx.Process(target=_rank, args=(r, devices, store, argvs))
                 for r in range(devices)]
        for p in procs:
            p.start()
        for p in procs:
            p.join()
        codes = [p.exitcode for p in procs]
        if any(codes):
            raise RuntimeError(f"audit ranks exited with {codes}")
        with open(os.path.join(store, "report.json")) as f:
            return json.load(f)


def main(argv: Optional[List[str]] = None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    devices = 4
    if "--devices" in argv:
        i = argv.index("--devices")
        devices = int(argv[i + 1])
        del argv[i:i + 2]
    return report(run_audit(argv, devices))


if __name__ == "__main__":
    sys.exit(main())
