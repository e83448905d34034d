"""Rank entry points for the port's multi-process tests (no jax here, so
that the spawned ranks never import it).

`run_ranks(fn, world, tmp_path, *args)` starts `world` processes with the
spawn method; each joins a process group through a `file://` store under
`tmp_path` (no port to clash between test workers; a try that gloo's
connect drops is retried on a fresh store: mesh.init_file_group), pins
torch to one thread, makes the mesh (`inner` > 0: the two-level one) and
returns fn(mesh, *args) to the parent through a pickle file. Backend gloo on the
CPU; `device="cuda"` gives each rank its own card and NCCL
(tests/test_torch_sharded_cuda.py);
`device="cuda:0"` puts every rank on card 0 with a gloo group (NCCL
refuses two ranks on one card), for K5's CUDA-IPC check on one card.
"""

from __future__ import annotations

import contextlib
import os
import pickle
import traceback
import uuid
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


def run_ranks(fn, world: int, tmp_path, *args, device: str = "cpu",
              timeout: float = 300.0, inner: int = 0) -> list:
    """fn(mesh, *args) on each of `world` ranks; their results in rank
    order. Raises with the failing rank's traceback."""
    tag = uuid.uuid4().hex[:8]
    out = Path(tmp_path) / f"ranks_{tag}"
    out.mkdir(parents=True)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_entry,
                         args=(r, world, str(out), device, fn, args,
                               inner))
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


def _entry(rank, world, out, device, fn, args, inner):
    torch.set_num_threads(1)
    from cafe_tpu_torch.parallel import Mesh, make_mesh
    from cafe_tpu_torch.parallel.mesh import init_file_group
    backend = "nccl" if device == "cuda" else "gloo"
    if device == "cuda":
        os.environ["LOCAL_RANK"] = str(rank)
    try:
        init_file_group(backend, out, rank, world)
        if device == "cuda:0":
            torch.cuda.set_device(0)
            mesh = Mesh(size=world, rank=rank, device=torch.device(device),
                        group=dist.new_group(list(range(world)),
                                             backend="gloo"))
        else:
            mesh = make_mesh(world, inner, device=device)
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


def train_steps(mesh, cfg_kw, ref_state, batches, modes, capture=True):
    """For each exchange mode: the layer built on the mesh, this rank's
    state cut from the bridged global `ref_state` (None: build_all's own
    state), the batches' slices stepped; returns per mode the metrics of
    every step, the global state after them (rank 0), the routing, every
    aux tensor and the eval scores of the first batch, the branches the
    exchange legs took and the eager runs of every device branch.
    `capture` False builds the eager steps (on the card the default
    ones replay CUDA graphs)."""
    from cafe_tpu_torch.bridge import from_reference_sharded
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.parallel import unshard_state
    from cafe_tpu_torch.parallel import exchange as ex
    from cafe_tpu_torch.train import build_all, get_dataset
    from cafe_tpu_torch.utils.cond import branch_runs
    out = {}
    for mode in modes:
        cfg = Config(**dict(cfg_kw, shard_exchange=mode))
        _, embed, own, step, eval_step = build_all(
            cfg, get_dataset(cfg, "train"), mesh=mesh, capture=capture)
        init_embed = _to_numpy(unshard_state(own, mesh, embed).embed)
        state = own if ref_state is None else \
            from_reference_sharded(ref_state, mesh, embed)
        since = ex.exchange_branches()
        conds_before = branch_runs()["eager"]
        metrics, records, bodies = [], [], []
        for dense, sparse, label, valid in batches:
            with ex.record_collectives() as rec:
                state, m = step(state, *_on(mesh, dense, sparse, label),
                                valid)
            metrics.append({k: float(v) for k, v in m.items()})
            records.append([tuple(r) for r in rec])
            bodies.append([(r.op, r.axis, r.bytes, r.transport)
                           for r in rec if r.in_body])
        branches = ex.exchange_branches(since)
        conds = {name: [a - b for a, b in zip(
            runs, conds_before.get(name, (0, 0)))]
            for name, runs in branch_runs()["eager"].items()}
        d, s, _ = _on(mesh, *batches[0][:3])
        _, aux = embed.gather(state.embed, s)

        def joined(x):
            return ex.all_gather(x, mesh).cpu().numpy()

        routing = {k: joined(v[1]) for k, v in aux.items()
                   if isinstance(v, tuple)}
        hot = {k: joined(v[-1]) for k, v in aux.items()
               if isinstance(v, tuple)}
        scores = joined(eval_step(state, d, s))
        full = _to_numpy(unshard_state(state, mesh, embed))
        out[mode] = {"metrics": metrics, "state": full if mesh.rank == 0
                     else None, "init_embed": init_embed,
                     "routing": routing, "hot": hot,
                     "aux": {k: [joined(x) for x in (
                         v if isinstance(v, tuple) else (v,))]
                         for k, v in aux.items()},
                     "scores": scores, "branches": branches,
                     "graphed": [step.graphed, eval_step.graphed],
                     "blockers": [b.split(" (")[0] for b in getattr(
                         step, "capture_blockers", ())
                         if b.startswith("a mesh")],
                     "conds": {k: v for k, v in conds.items() if any(v)},
                     "records": records, "bodies": bodies,
                     "auto_keys": [sorted(p.auto_keys)
                                   for p in embed.parts],
                     "local_shapes": {k: {n: tuple(v.shape) for n, v in
                                          part.items()
                                          if isinstance(v, torch.Tensor)}
                                      for k, part in state.embed.items()},
                     "parts": [(type(p).__name__, p.mesh is not None)
                               for p in embed.parts]}
    return out


def calls(mesh, todo):
    """Each (name of a function of this module, args) of `todo` called
    with the mesh, in one set of ranks; their results in order."""
    return [globals()[name](mesh, *args) for name, args in todo]


def train_runs(mesh, runs):
    """train_steps for each (cfg_kw, ref_state, batches, modes) of
    `runs`, in one set of ranks."""
    return [train_steps(mesh, *run) for run in runs]


@contextlib.contextmanager
def recording_collectives(sizes):
    """Records (name, bytes) of every all-gather, reduce-scatter and
    all-reduce the exchange makes (the larger of the call's tensors)
    into the list `sizes` while the context is open."""
    from cafe_tpu_torch.parallel import exchange as ex

    def recording(fn, name):
        def wrapped(*args, **kwargs):
            ts = [a for a in args if isinstance(a, torch.Tensor)]
            sizes.append((name, max(t.numel() * t.element_size()
                                    for t in ts)))
            return fn(*args, **kwargs)
        return wrapped

    prims = {"_all_gather_single": ex._all_gather_single,
             "_reduce_scatter_single": ex._reduce_scatter_single}
    all_reduce = dist.all_reduce
    for name, fn in prims.items():
        setattr(ex, name, recording(fn, name))
    dist.all_reduce = recording(all_reduce, "all_reduce")
    try:
        yield sizes
    finally:
        for name, fn in prims.items():
            setattr(ex, name, fn)
        dist.all_reduce = all_reduce


def unique_exchanges(mesh, cases):
    """For each (table, idx, grad, lr, optimizer, frac): the explicit
    fetch and apply at unique fraction `frac` and at 0 on this rank's
    shard and batch slice, with the branches the compact legs took and
    the (name, bytes) of every collective of each call."""
    from cafe_tpu_torch.ops.sparse import init_slots
    from cafe_tpu_torch.parallel import exchange as ex
    out = []
    for table, idx, grad, lr, optimizer, frac in cases:
        tbl = torch.from_numpy(table[rank_slice(mesh, table.shape[0])])
        i_l = torch.from_numpy(idx[rank_slice(mesh, idx.shape[0])])
        g_l = torch.from_numpy(grad[rank_slice(mesh, grad.shape[0])])
        res = {}
        for tag, f in (("compact", frac), ("full", 0.0)):
            since = ex.exchange_branches()
            sizes = []
            with recording_collectives(sizes):
                fetched = ex.sharded_fetch(mesh, tbl, i_l, f)
            t = tbl.clone()
            apply_sizes = []
            with recording_collectives(apply_sizes):
                t, s = ex.sharded_apply(mesh, t, init_slots(t, optimizer),
                                        i_l, g_l, lr, optimizer, f)
            res[tag] = {"fetch": fetched.numpy(), "table": t.numpy(),
                        "slots": {k: v.numpy() for k, v in s.items()},
                        "branches": ex.exchange_branches(since),
                        "fetch_sizes": sizes, "apply_sizes": apply_sizes}
        out.append(res)
    return out


def branch_exchanges(mesh, cases):
    """For each (leg, table, idx, grad, lr, optimizer, knob): the leg's
    fetch and apply on this rank's shard and batch slice, leg "unique"
    the explicit exchange at unique fraction `knob`, leg "a2a" the
    all-to-all exchange at slack `knob`; with the branches they took
    (exchange.exchange_branches)."""
    from cafe_tpu_torch.ops.sparse import init_slots
    from cafe_tpu_torch.parallel import exchange as ex
    out = []
    for leg, table, idx, grad, lr, optimizer, knob in cases:
        tbl = torch.from_numpy(table[rank_slice(mesh, table.shape[0])])
        i_l = torch.from_numpy(idx[rank_slice(mesh, idx.shape[0])])
        g_l = torch.from_numpy(grad[rank_slice(mesh, grad.shape[0])])
        since = ex.exchange_branches()
        t = tbl.clone()
        if leg == "unique":
            fetched = ex.sharded_fetch(mesh, tbl, i_l, knob)
            t, s = ex.sharded_apply(mesh, t, init_slots(t, optimizer), i_l,
                                    g_l, lr, optimizer, knob)
        else:
            fetched = ex.sharded_fetch_a2a(mesh, tbl, i_l, slack=knob)
            t, s = ex.sharded_apply_a2a(mesh, t, init_slots(t, optimizer),
                                        i_l, g_l, lr, optimizer, slack=knob)
        out.append({"fetch": fetched.numpy(), "table": t.numpy(),
                    "slots": {k: v.numpy() for k, v in s.items()},
                    "branches": ex.exchange_branches(since)})
    return out


def device_collectives(mesh, seed):
    """The device all-gather and reduce-scatter (kernels/a2a.py), their
    plain versions, and the process group's (parallel/exchange.py, the
    group and the device transport) on this rank's seeded int32 and
    one-owner inputs (lane l non-zero on rank l % n only): {case: [the
    four results]}, and the records the exchange's wrappers made as
    (op, axis, bytes, transport)."""
    from cafe_tpu_torch.kernels import a2a
    from cafe_tpu_torch.parallel import exchange as ex
    n, r = mesh.size, mesh.rank
    rng = np.random.default_rng([seed, r])
    owner = (np.arange(n * 24) % n == r)[:, None]
    inputs = {
        "int32": rng.integers(-2**31, 2**31 - 1, (n * 24, 3),
                              dtype=np.int64).astype(np.int32),
        "f32": rng.standard_normal((n * 24, 8)).astype(np.float32)}
    out = {}
    with ex.record_collectives() as rec:
        for dt, x in inputs.items():
            x = torch.from_numpy(x)
            out[f"gather_{dt}"] = [
                a2a.all_gather(x, mesh), a2a.all_gather_plain(x, mesh),
                ex.all_gather(x, mesh),
                ex.all_gather(x, mesh, transport="device")]
            one = torch.where(torch.from_numpy(owner), x,
                              torch.zeros_like(x))
            out[f"scatter_{dt}"] = [
                a2a.psum_scatter(one, mesh),
                a2a.psum_scatter_plain(one, mesh),
                ex.psum_scatter(one, mesh),
                ex.psum_scatter(one, mesh, transport="device")]
    return {"out": {k: [t.numpy() for t in v] for k, v in out.items()},
            "records": [(c.op, c.axis, c.bytes, c.transport)
                        for c in rec]}


def body_exchanges(mesh, cases, warm=False):
    """For each (leg, table, idx, grad, lr, optimizer, knob, impl): the
    leg's fetch and apply on this rank's shard and batch slice, as
    branch_exchanges runs them, the all-to-all legs through `impl`
    ('lax', or 'pallas': K5's plain version on the CPU); with the
    branches they took and the collectives recorded inside a branch's
    body as (op, axis, bytes, transport). `warm`: as a GraphedStep's
    warm-up calls run them (utils/cond.warming: each branch not taken
    also runs, on clones)."""
    from cafe_tpu_torch.ops.sparse import init_slots
    from cafe_tpu_torch.parallel import exchange as ex
    from cafe_tpu_torch.utils.cond import warming
    if warm:
        with warming():
            return body_exchanges(mesh, cases)
    out = []
    for leg, table, idx, grad, lr, optimizer, knob, impl in cases:
        tbl = torch.from_numpy(table[rank_slice(mesh, table.shape[0])])
        i_l = torch.from_numpy(idx[rank_slice(mesh, idx.shape[0])])
        g_l = torch.from_numpy(grad[rank_slice(mesh, grad.shape[0])])
        since = ex.exchange_branches()
        t = tbl.clone()
        with ex.record_collectives() as rec:
            if leg == "unique":
                fetched = ex.sharded_fetch(mesh, tbl, i_l, knob)
                t, _ = ex.sharded_apply(mesh, t, init_slots(t, optimizer),
                                        i_l, g_l, lr, optimizer, knob)
            else:
                fetched = ex.sharded_fetch_a2a(mesh, tbl, i_l, slack=knob,
                                               impl=impl)
                t, _ = ex.sharded_apply_a2a(
                    mesh, t, init_slots(t, optimizer), i_l, g_l, lr,
                    optimizer, slack=knob, impl=impl)
        out.append({"fetch": fetched.numpy(), "table": t.numpy(),
                    "branches": ex.exchange_branches(since),
                    "records": [(c.op, c.axis, c.bytes) for c in rec],
                    "bodies": [(c.op, c.axis, c.bytes, c.transport)
                               for c in rec if c.in_body]})
    return out


def step_blockers(mesh, cfg_kws, inner):
    """{name: [the train step's capture_blockers, the eval step's, the
    train step's on ranks that report two host names]} of each config
    built on this mesh, and {name: the train step's blockers} on a
    two-level mesh of the same ranks (make_mesh(n, inner))."""
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.parallel import make_mesh
    from cafe_tpu_torch.train import build_all, get_dataset
    from cafe_tpu_torch.train.step import build_eval_step, capture_blockers
    out, two = {}, {}
    hosts = mesh.hosts
    for name, kw in cfg_kws.items():
        cfg = Config(**kw)
        model, embed, _, _, _ = build_all(cfg, get_dataset(cfg, "train"),
                                          mesh=mesh, capture=False)
        mesh.hosts = tuple(f"host{r * 2 // mesh.size}"
                           for r in range(mesh.size))
        spread = capture_blockers(cfg, embed, mesh)
        mesh.hosts = hosts
        out[name] = [capture_blockers(cfg, embed, mesh),
                     build_eval_step(model, embed).capture_blockers, spread]
    mesh2 = make_mesh(mesh.size, inner, device="cpu")
    try:
        for name, kw in cfg_kws.items():
            cfg = Config(**dict(kw, mesh_inner=inner))
            _, embed, _, _, _ = build_all(cfg, get_dataset(cfg, "train"),
                                          mesh=mesh2, capture=False)
            two[name] = capture_blockers(cfg, embed, mesh2)
    finally:
        mesh2.close()
    return {"flat": out, "hosts": list(hosts), "two_level": two}


def _gaps(a, b):
    """(max |a - b| / max(1, max |b|) over the float leaves of two state
    trees, the paths of integer leaves that differ)."""
    from cafe_tpu_torch.utils.cond import _leaves
    gap, bad = 0.0, []
    for (path, x), (_, y) in zip(_leaves(a), _leaves(b)):
        if not x.is_floating_point():
            if not torch.equal(x, y):
                bad.append(path)
        elif x.numel():
            x, y = x.detach(), y.detach()
            gap = max(gap, float((x - y).abs().max()
                                 / y.abs().max().clamp_min(1.0)))
    return gap, bad


def _graph_runs(since):
    """{cond name: [false, true]} runs in graph replays since `since`
    (a branch_runs() return)."""
    from cafe_tpu_torch.utils.cond import branch_runs
    now = branch_runs()["graph"]
    return {name: [a - b for a, b in zip(v, since["graph"].get(name,
                                                              (0, 0)))]
            for name, v in now.items()
            if v != list(since["graph"].get(name, (0, 0)))}


def graph_vs_eager(mesh, cfg_kw, batches):
    """The default train step (a CUDA graph on the card) against
    capture=False's from one state: warm-up calls and the capture on the
    first batch, then one call a batch of `batches`, each against an
    eager step on a clone of the state it started from. Returns whether
    it graphed, its blockers, the largest float gap a call, the integer
    leaves that differed and the branch runs in graph replays."""
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.train import build_all, get_dataset
    from cafe_tpu_torch.train.capture import WARMUP_CALLS
    from cafe_tpu_torch.train.step import build_train_step, clone_state
    from cafe_tpu_torch.utils.cond import branch_runs
    cfg = Config(**cfg_kw)
    model, embed, state, e_step, _ = build_all(
        cfg, get_dataset(cfg, "train"), mesh=mesh, capture=False)
    g_step = build_train_step(model, embed, cfg, mesh)
    on = [_on(mesh, d, s, lab) + (v,) for d, s, lab, v in batches]
    for _ in range(WARMUP_CALLS + 1):
        state, _ = g_step(state, *on[0])
    since = branch_runs()
    gaps, bad = [], []
    for b in on:
        ex, _ = e_step(clone_state(state), *b)
        state, m = g_step(state, *b)
        gap, wrong = _gaps(state, ex)
        gaps.append(gap)
        bad += wrong
    return {"graphed": g_step.graphed,
            "blockers": list(g_step.capture_blockers), "gaps": gaps,
            "bad": bad, "loss": float(m["loss"]),
            "graph_runs": _graph_runs(since)}


def exchange_graph_vs_eager(mesh, table, batches, slack, impl):
    """The a2a legs (fetch, then apply at lr 0.1, SGD) as one step on this
    rank's shard, replayed as a CUDA graph on the card (GraphedStep; the
    eager step on the CPU) against the eager step from one state: warm-up
    calls and the capture on the first (idx, grad) batch, then one call
    a batch. Returns the fetches' and tables' largest gaps a call and
    the branch runs in graph replays."""
    from cafe_tpu_torch.ops.sparse import init_slots
    from cafe_tpu_torch.parallel import exchange as ex
    from cafe_tpu_torch.train.capture import WARMUP_CALLS, GraphedStep
    from cafe_tpu_torch.train.step import clone_state
    from cafe_tpu_torch.utils.cond import branch_runs

    def step(st, idx, grad):
        rows = ex.sharded_fetch_a2a(mesh, st["table"], idx, slack=slack,
                                    impl=impl)
        t, sl = ex.sharded_apply_a2a(mesh, st["table"], st["slots"], idx,
                                     grad, 0.1, "sgd", slack=slack,
                                     impl=impl)
        return {"table": t, "slots": sl}, rows

    tbl = torch.from_numpy(table[rank_slice(mesh, table.shape[0])]).to(
        mesh.device)
    state = {"table": tbl, "slots": init_slots(tbl, "sgd")}
    g_step = GraphedStep(step, carry=True) \
        if mesh.device.type == "cuda" else step
    on = [tuple(torch.from_numpy(x[rank_slice(mesh, x.shape[0])]).to(
        mesh.device) for x in b) for b in batches]
    for _ in range(WARMUP_CALLS + 1):
        state, _ = g_step(state, *on[0])
    since = branch_runs()
    fetch_gaps, table_gaps = [], []
    for b in on:
        ex_state, ex_rows = step(clone_state(state), *b)
        state, rows = g_step(state, *b)
        fetch_gaps.append(float((rows - ex_rows).abs().max()))
        table_gaps.append(_gaps(state, ex_state)[0])
    return {"graphed": getattr(g_step, "graphed", False),
            "fetch_gaps": fetch_gaps, "table_gaps": table_gaps,
            "graph_runs": _graph_runs(since),
            "eager_runs": {k: v for k, v in branch_runs()["eager"].items()
                           if k in ("fetch_a2a", "apply_a2a")}}


def with_constants(mesh, module, values, name, *args):
    """`name` (a function of this module) called with the mesh and
    `args` while the attributes `values` of `module` are set (e.g. a
    part's step constants); they are restored after."""
    import importlib
    mod = importlib.import_module(module)
    old = {k: getattr(mod, k) for k in values}
    for k, v in values.items():
        setattr(mod, k, v)
    try:
        return globals()[name](mesh, *args)
    finally:
        for k, v in old.items():
            setattr(mod, k, v)


def mesh_errors(mesh):
    """make_mesh's refusals, as the strings of what they raised."""
    from cafe_tpu_torch.parallel import make_mesh
    got = {}
    for name, kw in (("inner", dict(n_devices=mesh.size,
                                    inner=mesh.size + 1, device="cpu")),
                     ("size", dict(n_devices=mesh.size + 1, device="cpu"))):
        try:
            make_mesh(**kw)
            got[name] = None
        except (NotImplementedError, ValueError) as e:
            got[name] = f"{type(e).__name__}: {e}"
    return got


def mesh_layout(mesh):
    """The mesh's axes, shape and this rank's row (ici) and column (dcn)
    members, each read back through an all-gather of the ranks over that
    group; and what a mesh_inner that does not divide the world raises."""
    from cafe_tpu_torch.parallel import exchange as ex
    me = torch.tensor([mesh.rank])
    got = {"axis_names": mesh.axis_names, "shape": mesh.shape,
           "ici": ex.all_gather(me, mesh, "ici").tolist(),
           "dcn": ex.all_gather(me, mesh, "dcn").tolist()}
    got["bad_inner"] = mesh_errors(mesh)["inner"]
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


def kernel_a2a_graph(mesh, chunk, dim, replays, seed):
    """K5 captured in a CUDA graph (a rows leg [n, chunk, dim] f32 on a
    static input), then `replays` rounds of: the static input refilled
    with round e's seeded rows, one replay, one eager call on round e's
    other rows (seed + 1000 + e) on the same workspace. Returns per
    round (replayed output, eager output) and the launch counts."""
    from cafe_tpu_torch.kernels import a2a
    n, dev = mesh.size, mesh.device

    def rows(s):
        return torch.from_numpy(inputs_a2a(n, chunk, dim, s,
                                           mesh.rank)[1]).to(dev)

    x = rows(seed - 1)
    a2a.all_to_all(x, mesh)               # the workspace, before capture
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream(dev)
    stream.wait_stream(torch.cuda.current_stream(dev))
    before = a2a.KERNEL.launches
    with torch.cuda.graph(graph, stream=stream,
                          capture_error_mode="thread_local"):
        out = a2a.all_to_all(x, mesh)
    captured = a2a.KERNEL.launches - before
    outs = []
    for e in range(replays):
        x.copy_(rows(seed + e))
        graph.replay()
        got = out.clone()
        eager = a2a.all_to_all(rows(seed + 1000 + e), mesh)
        outs.append((got.cpu().numpy(), eager.cpu().numpy()))
    torch.cuda.synchronize()
    return {"outs": outs, "launches_at_capture": captured}


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


def quantized_serving(mesh, cfg_kw, batches, eval_batch, bits_list):
    """The layer built on the mesh from build_all's own state, the
    batches' slices stepped, then for each of `bits_list` the quantized
    eval step (eager on a mesh) on this rank's slice of `eval_batch`,
    with the size of every collective it made (the larger of its input
    and output, in bytes) recorded by wrapping the exchange's
    primitives. Returns the all-gathered scores and dequantized rows
    ("raw<bits>") per bits, the float eval's scores, the sizes, the
    parts' layout and (rank 0) the global state after the steps."""
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.parallel import exchange as ex
    from cafe_tpu_torch.parallel import unshard_state
    from cafe_tpu_torch.train import (build_all, build_quantized_eval_step,
                                      get_dataset)
    cfg = Config(**cfg_kw)
    model, embed, state, step, eval_step = build_all(
        cfg, get_dataset(cfg, "train"), mesh=mesh)
    for dense, sparse, label, valid in batches:
        state, _ = step(state, *_on(mesh, dense, sparse, label), valid)
    d, s = _on(mesh, *eval_batch)
    sizes = []
    out = {"float": ex.all_gather(eval_step(state, d, s), mesh).numpy(),
           "sizes": {}, "graphed": {}}
    for bits in bits_list:
        q = build_quantized_eval_step(model, embed, state, bits)
        sizes.clear()
        with recording_collectives(sizes):
            p = q(state, d, s)
        out["sizes"][bits] = list(sizes)
        out["graphed"][bits] = q.graphed
        out[bits] = ex.all_gather(p, mesh).numpy()
        with torch.no_grad():
            raws = embed.gather_quantized(state.embed, q.qtables, s)
        out[f"raw{bits}"] = {k: ex.all_gather(v, mesh).numpy()
                             for k, v in raws.items()}
    full = _to_numpy(unshard_state(state, mesh, embed))
    out["state"] = full if mesh.rank == 0 else None
    out["parts"] = [(type(p).__name__, p.mesh is not None)
                    for p in embed.parts]
    return out


def serve_runs(mesh, runs):
    """quantized_serving for each (cfg_kw, batches, eval_batch, bits_list)
    of `runs`, in one set of ranks."""
    return [quantized_serving(mesh, *run) for run in runs]


# ------------------------------------------------- mesh checkpoints (6.4)

def _run_cli(argv):
    """loop.run on this mesh's ranks (the group exists: run() makes its
    own mesh on it); rank 0's prints and run()'s result."""
    import contextlib
    import io
    from cafe_tpu_torch.config import parse_args
    from cafe_tpu_torch.train import run
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        res = run(parse_args(argv))
    return buf.getvalue(), res


def cli_text(mesh, argv):
    """What main_torch.py prints for `argv` on this mesh (rank 0)."""
    return _run_cli(argv)[0]


def save_resume_runs(mesh, argv, root, ks):
    """For each k of `ks`: run A trains with rolling saves every 4 its at
    --steps_per_dispatch k; run B resumes from A's other rolling slot
    (the mid-run one) and saves at the end. Returns their prints and the
    slot B resumed from."""
    out = {}
    for k in ks:
        base = argv + ["--steps_per_dispatch", str(k), "--save_freq", "4"]
        a = os.path.join(root, f"k{k}", "a")
        text_a, _ = _run_cli(base + ["--save_model", a])
        latest = os.path.realpath(a + ".latest")
        other = a + (".rb" if latest.endswith(".ra") else ".ra")
        text_b, _ = _run_cli(base + ["--save_model",
                                     os.path.join(root, f"k{k}", "b"),
                                     "--load_model", other])
        out[k] = {"a": text_a, "b": text_b, "latest": latest,
                  "resumed_from": other}
    return out


def dispatch_trajectories(mesh, cfg_kw, k):
    """The mesh's step at k = 1 and k (build_multi_step over
    loop.train_batches) from build_all's one state, through one epoch:
    the global state after every k steps (rank 0) and the metrics."""
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.parallel import unshard_state
    from cafe_tpu_torch.train import build_all, build_multi_step
    from cafe_tpu_torch.train.loop import get_dataset, train_batches
    cfg = Config(**cfg_kw)
    data = get_dataset(cfg, "train")
    out = {}
    for kk in (1, k):
        _, embed, state, step, _ = build_all(cfg, data, mesh=mesh)
        if kk > 1:
            step = build_multi_step(step, kk, donate=True,
                                    mesh_size=mesh.size)
        states, metrics, valids = [], [], []
        for i, (dense, sparse, label, valid) in enumerate(train_batches(
                data, cfg.mini_batch_size, kk, 0, mesh)):
            state, m = step(state, *(None if x is None
                                     else torch.from_numpy(x)
                                     for x in (dense, sparse, label)),
                            valid)
            metrics.append({n: float(v) for n, v in m.items()})
            valids.append(valid)
            if (i + 1) * kk % k == 0:
                full = _to_numpy(unshard_state(state, mesh, embed))
                states.append(full if mesh.rank == 0 else None)
        out[kk] = {"states": states, "metrics": metrics, "valids": valids}
    return out


def dispatch_past_the_end(mesh, cfg_kw, k, device="cpu"):
    """One epoch at k steps a dispatch (build_multi_step over
    loop.train_batches), whose last block runs past the data's end, and
    the step at k = 1 over the same global batches built here from the
    rows: a partial batch is padded with its own first row on the mesh
    (as at k = 1) and with its block's first row on one device (as
    batch_iterator pads a [k*B] block); the block's batches past the end
    are that row repeated, valid 0. On the mesh (or on one device with
    `mesh` None): the global states after both (rank 0), the dispatches'
    valids and the number of empty sub-steps."""
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.data.datasets import batch_iterator
    from cafe_tpu_torch.parallel import batch_slice, unshard_state
    from cafe_tpu_torch.train import build_all, build_multi_step
    from cafe_tpu_torch.train.loop import get_dataset, train_batches
    cfg = Config(**cfg_kw)
    data = get_dataset(cfg, "train")
    b = cfg.mini_batch_size
    size = 1 if mesh is None else mesh.size
    where = dict(device=device) if mesh is None else dict(mesh=mesh)

    def tensors(*arrays):
        return tuple(None if x is None else torch.from_numpy(x)
                     for x in arrays)

    def saved(state, embed):
        if mesh is None:
            return _to_numpy(state)
        full = _to_numpy(unshard_state(state, mesh, embed))
        return full if mesh.rank == 0 else None

    out = {"valids": [], "empty_steps": 0}
    _, embed, state, step, _ = build_all(cfg, data, **where)
    multi = build_multi_step(step, k, donate=True, mesh_size=size)
    for dense, sparse, label, valid in train_batches(data, b, k, 0, mesh):
        state, _ = multi(state, *tensors(dense, sparse, label), valid)
        out["valids"].append(valid)
    out["k"] = saved(state, embed)

    _, embed, state, step, _ = build_all(cfg, data, **where)
    rows = len(data)
    every = next(iter(batch_iterator(data, rows)))[:3]
    for j in range(-(-rows // (k * b)) * k):
        lo, block = j * b, j // k * k * b
        pad = lo if mesh is not None and lo < rows else block
        idx = np.minimum(np.arange(lo, lo + b), rows - 1)
        idx = np.where(np.arange(lo, lo + b) < rows, idx, pad)
        batch = tuple(None if a is None else a[idx] for a in every)
        if mesh is not None:
            batch = batch_slice(mesh, *batch)
        valid = int(np.clip(rows - lo, 0, b))
        out["empty_steps"] += valid == 0
        state, _ = step(state, *tensors(*batch), valid)
    out["one"] = saved(state, embed)
    return out


def latency_calls(mesh, argv):
    """loop.inference's latency protocol on the mesh with a counted eval
    step: (this rank's call count, ms per call)."""
    from cafe_tpu_torch.config import parse_args
    from cafe_tpu_torch.train import build_all, get_dataset, inference
    cfg = parse_args(argv)
    _, _, state, _, eval_step = build_all(cfg, get_dataset(cfg, "train"),
                                          mesh=mesh)
    calls = [0]

    def counted(*args):
        calls[0] += 1
        return eval_step(*args)

    _, ms = inference(cfg, counted, state, get_dataset(cfg, "test"),
                      throughput=True, mesh=mesh)
    return calls[0], ms


def mesh_steps_saved(mesh, cfg_kw, ref_state, batches, path):
    """The bridged global `ref_state` cut to this rank, the batches'
    slices stepped, then saved under the mesh (every rank calls the
    save). Returns the step's metrics."""
    from cafe_tpu_torch.bridge import from_reference_sharded
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.train import build_all, get_dataset
    from cafe_tpu_torch.train.checkpoint import save_checkpoint
    cfg = Config(**cfg_kw)
    _, embed, _, step, _ = build_all(cfg, get_dataset(cfg, "train"),
                                     mesh=mesh)
    state = from_reference_sharded(ref_state, mesh, embed)
    metrics = []
    for dense, sparse, label, valid in batches:
        state, m = step(state, *_on(mesh, dense, sparse, label), valid)
        metrics.append({k: float(v) for k, v in m.items()})
    save_checkpoint(path, state, {"iter": len(batches)}, mesh, embed)
    return metrics


def saved_runs(mesh, runs):
    """mesh_steps_saved for each (cfg_kw, ref_state, batches, path) of
    `runs`, in one set of ranks."""
    return [mesh_steps_saved(mesh, *run) for run in runs]


def load_error(mesh, argv, path):
    """What loading `path` on this mesh raises (its string), else None."""
    from cafe_tpu_torch.config import parse_args
    from cafe_tpu_torch.train import build_all, get_dataset
    from cafe_tpu_torch.train.checkpoint import load_checkpoint
    cfg = parse_args(argv)
    _, embed, state, _, _ = build_all(cfg, get_dataset(cfg, "train"),
                                      mesh=mesh)
    try:
        load_checkpoint(path, state, mesh, embed)
    except ValueError as e:
        return str(e)
    return None


# ------------------------------------------------ multi-node pieces (6.7)

def node_runs(mesh, argvs, per_node):
    """main_torch.py's run for each argv of `argvs`, this rank posing as
    local rank rank % per_node of node rank // per_node (LOCAL_RANK, as
    a multi-node torchrun sets it); rank 0's prints."""
    os.environ["LOCAL_RANK"] = str(mesh.rank % per_node)
    os.environ["LOCAL_WORLD_SIZE"] = str(per_node)
    try:
        return [_run_cli(argv)[0] for argv in argvs]
    finally:
        del os.environ["LOCAL_RANK"], os.environ["LOCAL_WORLD_SIZE"]


def multihost_pieces(mesh, table, ids, upd, lr, batch):
    """parallel/embedding_parallel's three functions on this rank's shard
    of `table` and slice of `ids` / `upd`, all-gathered back; and
    parallel/multihost's global_batches (the slice it cuts from a global
    batch, the error of one that does not divide) and gather_to_host."""
    from cafe_tpu_torch.parallel import embedding_parallel as ep
    from cafe_tpu_torch.parallel import exchange as ex
    from cafe_tpu_torch.parallel import gather_to_host, global_batches
    sl = rank_slice(mesh, table.shape[0])
    il = torch.from_numpy(ids[rank_slice(mesh, ids.shape[0])])
    ul = torch.from_numpy(upd[rank_slice(mesh, upd.shape[0])])
    t = torch.from_numpy(table[sl].copy())
    out = {"gather": ex.all_gather(ep.sharded_gather(mesh, t, il),
                                   mesh).numpy(),
           "scatter_add": ex.all_gather(ep.sharded_scatter_add(
               mesh, t.clone(), il, ul), mesh).numpy()}
    rows, new = ep.sharded_embedding_lookup_and_update(
        mesh, t.clone(), il, lambda r: 2.0 * r, lr)
    out["lookup_rows"] = ex.all_gather(rows, mesh).numpy()
    out["lookup_table"] = ex.all_gather(new, mesh).numpy()
    got = next(iter(global_batches(mesh, [batch])))
    out["slice"] = [None if x is None else x.numpy() for x in got[:3]]
    out["valid"] = got[3]
    odd = tuple(None if x is None else x[:-1] for x in batch[:3]) \
        + (batch[3],)
    try:
        next(iter(global_batches(mesh, [odd])))
        out["odd"] = None
    except ValueError as e:
        out["odd"] = str(e)
    out["gathered"] = gather_to_host(got[2], mesh)
    return out


def collective_totals(mesh, argvs):
    """For each argv (main_torch.py's flags), one sharded train step's
    recorded collectives (tools/wire_audit.audit): this rank's total
    result bytes, by op, the towers' bytes and the batch lanes."""
    from cafe_tpu_torch.config import parse_args
    from cafe_tpu_torch.tools.wire_audit import audit
    out = []
    for argv in argvs:
        res = audit(parse_args(list(argv) + ["--mesh_shape",
                                             str(mesh.size)]), mesh)
        out.append({k: res[k] for k in ("total", "dense_bytes", "lanes",
                                         "collectives")})
    return out


def cli_rank(mesh, argv):
    """main_torch.main(argv) on this rank: the process group exists, so
    main_torch joins it (tools/smoke_matrix_sharded_torch.sh)."""
    import main_torch
    main_torch.main(list(argv))
    return True


def main(argv=None) -> int:
    """`python tests/torch_dist_worker.py --world N -- <main_torch.py
    flags>`: main_torch.py on N gloo ranks of the CPU, started as the
    tests start theirs (run_ranks: spawned processes, a file:// store in
    a temporary directory). Exits 1 if a rank fails."""
    import argparse
    import sys
    import tempfile
    ap = argparse.ArgumentParser(description=main.__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, required=True)
    ap.add_argument("--timeout", type=float, default=400.0)
    ap.add_argument("flags", nargs=argparse.REMAINDER)
    args = ap.parse_args(argv)
    flags = args.flags[1:] if args.flags[:1] == ["--"] else args.flags
    repo = str(Path(__file__).resolve().parents[1])
    if repo not in sys.path:
        sys.path.insert(0, repo)
    import torch_dist_worker as worker        # pickled by module name
    with tempfile.TemporaryDirectory() as tmp:
        try:
            worker.run_ranks(worker.cli_rank, args.world, tmp, flags,
                             timeout=args.timeout)
        except AssertionError as e:
            print(e, file=sys.stderr)
            return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
