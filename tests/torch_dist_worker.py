"""Rank entry points for the port's multi-process tests (no jax here, so
that the spawned ranks never import it).

`run_ranks(fn, world, tmp_path, *args)` starts `world` processes with the
spawn method; each joins a process group through a `file://` store under
`tmp_path` (no port to clash between test workers), pins torch to one
thread, makes the mesh and returns fn(mesh, *args) to the parent through
a pickle file. Backend gloo on the CPU; `device="cuda"` gives each rank
its own card and NCCL (tests/test_torch_sharded_cuda.py);
`device="cuda:0"` puts every rank on card 0 with a gloo group (NCCL
refuses two ranks on one card), for K5's CUDA-IPC check on one card.
"""

from __future__ import annotations

import os
import pickle
import traceback
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def run_ranks(fn, world: int, tmp_path, *args, device: str = "cpu",
              timeout: float = 300.0) -> list:
    """fn(mesh, *args) on each of `world` ranks; their results in rank
    order. Raises with the failing rank's traceback."""
    tag = uuid.uuid4().hex[:8]
    out = Path(tmp_path) / f"ranks_{tag}"
    out.mkdir(parents=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, str(out), device, fn, args))
             for r in range(world)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout)
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join()
    errors = sorted(out.glob("error_*.txt"))
    if errors:
        raise AssertionError(errors[0].read_text())
    codes = [p.exitcode for p in procs]
    if any(c != 0 for c in codes):
        raise AssertionError(f"ranks exited with {codes}")
    results = []
    for r in range(world):
        with open(out / f"result_{r}.pkl", "rb") as f:
            results.append(pickle.load(f))
    return results


def _entry(rank, world, out, device, fn, args):
    torch.set_num_threads(1)
    from cafe_tpu_torch.parallel import Mesh, make_mesh
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
    try:
        dist.init_process_group(backend, init_method=f"file://{out}/store",
                                rank=rank, world_size=world)
        if device == "cuda:0":
            torch.cuda.set_device(0)
            mesh = Mesh(size=world, rank=rank, device=torch.device(device),
                        group=dist.new_group(list(range(world)),
                                             backend="gloo"))
        else:
            mesh = make_mesh(world, device=device)
        res = fn(mesh, *args)
        mesh.close()
        dist.barrier()
        dist.destroy_process_group()
        with open(os.path.join(out, f"result_{rank}.pkl"), "wb") as f:
            pickle.dump(res, f)
    except BaseException:
        with open(os.path.join(out, f"error_{rank}.txt"), "w") as f:
            f.write(f"rank {rank}:\n{traceback.format_exc()}")
        raise


# ---------------------------------------------------------------------------
# rank functions (module level: the spawn method pickles them by name)

def rank_slice(mesh, n_rows: int) -> slice:
    per = n_rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def a2a_plain(mesh, xs_global):
    """K5's wrapper on CPU tensors: this rank's [n, ...] chunk of
    `xs_global` [n*n, ...]; the launches stay 0 (no kernel on the CPU)."""
    from cafe_tpu_torch.kernels import a2a
    xs = torch.from_numpy(xs_global[rank_slice(mesh, xs_global.shape[0])])
    before = a2a.KERNEL.launches
    out = a2a.all_to_all(xs, mesh)
    return {"out": out.numpy(), "launches": a2a.KERNEL.launches - before,
            "plain": a2a.all_to_all_plain(xs, mesh).numpy()}


def exchanges(mesh, table, idx, grad, lr, optimizer, slack):
    """Every flat exchange on this rank's shard and batch slice."""
    from cafe_tpu_torch.ops.sparse import init_slots
    from cafe_tpu_torch.parallel import exchange as ex
    dev = mesh.device
    tbl = torch.from_numpy(table[rank_slice(mesh, table.shape[0])]).to(dev)
    i_l = torch.from_numpy(idx[rank_slice(mesh, idx.shape[0])]).to(dev)
    g_l = torch.from_numpy(grad[rank_slice(mesh, grad.shape[0])]).to(dev)
    res = {"fetch": ex.sharded_fetch(mesh, tbl, i_l).cpu().numpy(),
           "lookup": ex.owner_lookup_1d(
               tbl[:, 0].contiguous(), ex.all_gather(i_l.reshape(-1), mesh),
               mesh).cpu().numpy()}
    for impl in ("lax", "pallas"):
        res[f"fetch_a2a_{impl}"] = ex.sharded_fetch_a2a(
            mesh, tbl, i_l, slack=slack, impl=impl).cpu().numpy()
    for name, fn in (("apply", lambda t, s: ex.sharded_apply(
            mesh, t, s, i_l, g_l, lr, optimizer)),
            ("apply_a2a_lax", lambda t, s: ex.sharded_apply_a2a(
                mesh, t, s, i_l, g_l, lr, optimizer, slack=slack)),
            ("apply_a2a_pallas", lambda t, s: ex.sharded_apply_a2a(
                mesh, t, s, i_l, g_l, lr, optimizer, slack=slack,
                impl="pallas"))):
        t = tbl.clone()
        t, s = fn(t, init_slots(t, optimizer))
        res[name] = (t.cpu().numpy(),
                     {k: v.cpu().numpy() for k, v in s.items()})
    return res


def _to_numpy(tree):
    from cafe_tpu_torch.bridge import to_numpy
    return to_numpy(tree)


def _on(mesh, *arrays):
    """This rank's slices of host batch arrays, on the mesh's device."""
    from cafe_tpu_torch.parallel import batch_slice
    return tuple(None if x is None else x.to(mesh.device)
                 for x in batch_slice(mesh, *(
                     None if a is None else torch.from_numpy(a)
                     for a in arrays)))


def train_steps(mesh, cfg_kw, ref_state, batches, modes):
    """For each exchange mode: the layer built on the mesh, this rank's
    state cut from the bridged global `ref_state` (None: build_all's own
    state), the batches' slices stepped; returns per mode the metrics of
    every step, the global state after them (rank 0) and the routing and
    eval scores of the first batch."""
    from cafe_tpu_torch.bridge import from_reference_sharded
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.parallel import unshard_state
    from cafe_tpu_torch.parallel.exchange import all_gather
    from cafe_tpu_torch.train import build_all, get_dataset
    out = {}
    for mode in modes:
        cfg = Config(**dict(cfg_kw, shard_exchange=mode))
        _, embed, own, step, eval_step = build_all(
            cfg, get_dataset(cfg, "train"), mesh=mesh)
        init_embed = _to_numpy(unshard_state(own, mesh, embed).embed)
        state = own if ref_state is None else \
            from_reference_sharded(ref_state, mesh, embed)
        metrics = []
        for dense, sparse, label, valid in batches:
            state, m = step(state, *_on(mesh, dense, sparse, label), valid)
            metrics.append({k: float(v) for k, v in m.items()})
        d, s, _ = _on(mesh, *batches[0][:3])
        _, aux = embed.gather(state.embed, s)
        routing = {k: all_gather(v[1], mesh).cpu().numpy()
                   for k, v in aux.items() if isinstance(v, tuple)}
        hot = {k: all_gather(v[-1], mesh).cpu().numpy()
               for k, v in aux.items() if isinstance(v, tuple)}
        scores = all_gather(eval_step(state, d, s), mesh).cpu().numpy()
        full = _to_numpy(unshard_state(state, mesh, embed))
        out[mode] = {"metrics": metrics, "state": full if mesh.rank == 0
                     else None, "init_embed": init_embed,
                     "routing": routing, "hot": hot,
                     "scores": scores,
                     "parts": [(type(p).__name__, p.mesh is not None)
                               for p in embed.parts]}
    return out


def mesh_errors(mesh):
    """make_mesh's refusals, as the strings of what they raised."""
    from cafe_tpu_torch.parallel import make_mesh
    got = {}
    for name, kw in (("inner", dict(n_devices=mesh.size, inner=2,
                                    device="cpu")),
                     ("size", dict(n_devices=mesh.size + 1, device="cpu"))):
        try:
            make_mesh(**kw)
            got[name] = None
        except (NotImplementedError, ValueError) as e:
            got[name] = f"{type(e).__name__}: {e}"
    return got


def kernel_a2a_epochs(mesh, chunk, dim, epochs, seed):
    """K5 on the card over `epochs` successive calls of an ids leg
    [n, chunk] int32 and a rows leg [n, chunk, dim] f32, each rank's
    input made from (seed, epoch, rank); returns the outputs and the
    launch count."""
    from cafe_tpu_torch.kernels import a2a
    n, outs = mesh.size, []
    before = a2a.KERNEL.launches
    for e in range(epochs):
        ids, rows = inputs_a2a(n, chunk, dim, seed + e, mesh.rank)
        got_i = a2a.all_to_all(torch.from_numpy(ids).to(mesh.device), mesh)
        got_r = a2a.all_to_all(torch.from_numpy(rows).to(mesh.device), mesh)
        outs.append((got_i.cpu().numpy(), got_r.cpu().numpy()))
    torch.cuda.synchronize()
    return {"outs": outs, "launches": a2a.KERNEL.launches - before}


def inputs_a2a(n, chunk, dim, seed, rank):
    """Rank `rank`'s seeded all-to-all inputs (ids, rows)."""
    rng = np.random.default_rng([seed, rank])
    ids = rng.integers(0, 2**31 - 1, (n, chunk), dtype=np.int64)
    rows = rng.standard_normal((n, chunk, dim), dtype=np.float32)
    return ids.astype(np.int32), rows


def expected_a2a(n, chunk, dim, seed, rank):
    """What rank `rank` must receive: chunk `rank` of every rank's
    input."""
    ins = [inputs_a2a(n, chunk, dim, seed, s) for s in range(n)]
    return (np.stack([i[0][rank] for i in ins]),
            np.stack([i[1][rank] for i in ins]))


def exchange_cases(mesh, cases):
    """`exchanges` for each (table, idx, grad, lr, optimizer, slack)."""
    return [exchanges(mesh, *case) for case in cases]


def cli_reference(mesh, argv):
    """What main_torch.py prints for `argv` (one epoch, every iteration
    printed, one eval at the end), computed by driving build_all's step
    and loop.inference directly on this mesh."""
    from cafe_tpu_torch.config import parse_args
    from cafe_tpu_torch.data.datasets import process_batch_iterator
    from cafe_tpu_torch.train import build_all, get_dataset, inference
    cfg = parse_args(argv)
    train = get_dataset(cfg, "train")
    _, _, state, step, eval_step = build_all(cfg, train, mesh=mesh)
    losses = []
    for dense, sparse, label, valid in process_batch_iterator(
            train, cfg.mini_batch_size, mesh.rank, mesh.size):
        state, m = step(state, *(torch.from_numpy(x)
                                 for x in (dense, sparse, label)), valid)
        losses.append(float(m["loss"]))
    metrics, _ = inference(cfg, eval_step, state, get_dataset(cfg, "test"),
                           mesh=mesh)
    return losses, (metrics["accuracy"], metrics["roc_auc"])
