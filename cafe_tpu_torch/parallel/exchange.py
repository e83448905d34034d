"""The sharded embedding exchange on torch.distributed (port of
cafe_tpu/parallel/exchange.py).

Tables are row-sharded over the mesh, batches sharded over the same
ranks, and per step only O(batch) bytes cross the wire:

  forward   all-gather the flattened int32 row ids -> owner-compute
            gather (each rank reads the rows it owns, zeros elsewhere)
            -> reduce-scatter returns each rank its batch slice's rows;
  backward  duplicate row ids combine locally (coalesce) -> all-gather
            (ids, grads) -> owner-compute sparse apply.

The request-routed all-to-all legs (`sharded_fetch_a2a`,
`sharded_apply_a2a`) ship each owner only the ids it must answer and the
rows or grads of those ids; `impl='pallas'` runs them through kernel K5
(kernels/a2a.py, the peer-write all-to-all), `impl='lax'` through
`dist.all_to_all_single`.

With a unique fraction (--shard_unique_frac) the explicit legs ship a
capacity-bounded buffer of the batch's DISTINCT ids (and their summed
grads) instead of every lane; when any rank's distinct count overflows
the capacity, every rank takes the full-size path. The a2a and pallas
legs take the full explicit path the same way when a peer's request
buffer overflows. Each such choice is a device branch (utils/cond.cond:
a conditional node of a CUDA graph, the JAX package's lax.cond) on a
predicate that a MAX all-reduce makes the same on every rank
(`any_rank`); `exchange_branches` counts the branches each leg took.

No process-group collective runs inside a branch's body on a flat mesh
of one host, so the card can capture every branch into a CUDA graph at
any world size (it refuses NCCL's work in a conditional body on more
than one rank):

* the leg a normal step takes (the compact leg, the routed all-to-all)
  runs its collectives BEFORE the branch, at its fixed sizes, on its
  usual transport (the process group; K5 for the pallas legs); the
  branch that picks it holds only local work. On an overflow step its
  results are thrown away: the values are the JAX package's, and only
  that step moves more bytes;
* the rare leg (every overflow branch's full explicit path, and the
  sharded insert every interval-th tick, embeddings/cafe.py) runs its
  collectives inside the body as DEVICE collectives
  (kernels/a2a.all_gather / psum_scatter, carried by K5): `transport`
  "device" in `all_gather` / `psum_scatter`, the helpers taking the
  transport as an argument (`body_transport` picks it for a mesh).
  K5 reaches only one host's cards (CUDA IPC), and the hierarchical
  legs run over the row and column groups, so on a mesh across hosts
  or a two-level mesh the bodies keep the process group's collectives
  (train/step.capture_blockers keeps those steps eager on more than one
  rank). The MAX all-reduce of each predicate stays outside the bodies.

On a two-level ("dcn", "ici") mesh the explicit legs are HIERARCHICAL:
ids (and grads) combine over "ici", this rank's host, before anything
crosses "dcn", so only the host's combined (or compacted) set crosses
the outer links. Row ownership stays the flat one. The a2a and pallas
legs fall back to the explicit path there, as in the JAX package.

Each function here is the body of the JAX package's `shard_map`: it takes
this rank's shard of the table and this rank's slice of the batch. Every
collective goes through the wrappers below (`all_gather`, `psum`,
`psum_scatter`, `broadcast`, `any_rank`, `_a2a`), which name the mesh's
flat group or one level of a two-level mesh (`axis` "ici" / "dcn"), and
which record each call while `record_collectives` is open
(tools/wire_audit.py, the port's counterpart of the JAX package's HLO
traffic audit), the device collectives under the op and axis of the
collective they stand for, with the same bytes.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Optional

import torch
import torch.distributed as dist

from ..kernels import a2a as _a2a_kernel
from ..ops.sparse import (apply_rows, coalesce, coalesce_compact,
                          unique_compact)
from ..utils.cond import branch_runs, cond, copy_into, in_body

# sentinel row index far above any real table; survives the owner's
# `- lo` shift still out of range, so scatters drop these lanes
DROP_ROW = 2**30

_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


class _Record(NamedTuple):
    op: str
    axis: str
    bytes: int


class Collective(_Record):
    """One recorded collective: the op, the axis it ran over ("data" =
    the mesh's flat group, "ici", "dcn") and its result's bytes on this
    rank (the JAX audit's measure: an all-gather's gathered buffer).
    Two more facts ride as attributes, outside the tuple (a record
    unpacks as (op, axis, bytes)): `transport`, "group" for the process
    group's collective (NCCL on the card, gloo on the CPU) or "device"
    for K5's device collectives (kernels/a2a.py, the module docstring),
    and `in_body`, whether it ran inside a device branch's body
    (utils/cond.in_body)."""
    transport = "group"
    in_body = False


# the open recorder's list, else None (no cost when no recorder is open)
_RECORD: Optional[List[Collective]] = None


@contextlib.contextmanager
def record_collectives():
    """Record every collective this module makes while the context is
    open; yields the list of Collective records. Shapes only: no host
    sync is added."""
    global _RECORD
    prev, _RECORD = _RECORD, []
    try:
        yield _RECORD
    finally:
        _RECORD = prev


def _note(op: str, axis: Optional[str], out: torch.Tensor,
          transport: str = "group") -> None:
    if _RECORD is not None:
        rec = Collective(op, axis or "data",
                         out.numel() * out.element_size())
        rec.transport, rec.in_body = transport, in_body()
        _RECORD.append(rec)


def mesh_axes(mesh) -> tuple:
    """The mesh's exchange axes: ("data",) flat, ("dcn", "ici")
    two-level. Tables and batches shard over all of them jointly."""
    return tuple(mesh.axis_names)


def _group(mesh, axis: Optional[str]):
    """(process group, its size) of `axis`: None = the flat group."""
    if axis is None:
        return mesh.group, mesh.size
    if axis not in mesh_axes(mesh):
        # a group of None would be torch's default (world) group
        raise ValueError(f"axis {axis!r} is not one of the mesh's "
                         f"{mesh_axes(mesh)}")
    if axis == "ici":
        return mesh.ici_group, mesh.inner
    return mesh.dcn_group, mesh.size // mesh.inner


TRANSPORTS = ("group", "device")


def _device_transport(transport: str, axis: Optional[str]) -> bool:
    if transport not in TRANSPORTS:
        raise ValueError(f"unknown transport {transport!r}: one of "
                         f"{TRANSPORTS}")
    if transport == "device" and axis is not None:
        raise ValueError(f"the device collectives run over the mesh's flat "
                         f"group, not axis {axis!r}")
    return transport == "device"


def body_transport(mesh) -> str:
    """The transport of the collectives inside a device branch's body on
    `mesh`: "device" (K5's all-gather and reduce-scatter) on a flat mesh
    whose ranks share one host, "group" (the process group's) on a
    two-level mesh, whose bodies run over its row and column groups, or
    across hosts, where K5 cannot reach (CUDA IPC maps one host's
    cards). `mesh.hosts` holds the ranks' host names (parallel/mesh.py;
    empty: one host)."""
    if mesh.inner or len(set(mesh.hosts)) > 1:
        return "group"
    return "device"


def all_gather(x: torch.Tensor, mesh, axis: Optional[str] = None,
               transport: str = "group") -> torch.Tensor:
    """Tiled all-gather along dim 0 (jax.lax.all_gather(tiled=True)) over
    the flat group or one level (`axis`) of a two-level mesh; `transport`
    "device" runs it on K5 (kernels/a2a.all_gather, the flat group
    only)."""
    if _device_transport(transport, axis):
        out = _a2a_kernel.all_gather(x, mesh)
    else:
        group, n = _group(mesh, axis)
        out = torch.empty((n * x.shape[0],) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _all_gather_single(out, x.contiguous(), group=group)
    _note("all-gather", axis, out, transport)
    return out


def psum(x: torch.Tensor, mesh, axis: Optional[str] = None) -> torch.Tensor:
    """Sum over the mesh or one level of it (a new tensor)."""
    y = x.clone()
    dist.all_reduce(y, group=_group(mesh, axis)[0])
    _note("all-reduce", axis, y)
    return y


def psum_scatter(x: torch.Tensor, mesh, axis: Optional[str] = None,
                 transport: str = "group") -> torch.Tensor:
    """Sum over the mesh (or one level), position p of the group keeping
    rows [p*k, (p+1)*k) of dim 0; `transport` "device" runs it on K5
    (kernels/a2a.psum_scatter, the flat group only: exact where each
    lane has one non-zero contribution, as every caller's has)."""
    if _device_transport(transport, axis):
        out = _a2a_kernel.psum_scatter(x, mesh)
    else:
        group, n = _group(mesh, axis)
        out = torch.empty((x.shape[0] // n,) + tuple(x.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _reduce_scatter_single(out, x.contiguous(), group=group)
    _note("reduce-scatter", axis, out, transport)
    return out


def broadcast(x: torch.Tensor, mesh) -> torch.Tensor:
    """Rank 0's values of `x` on every rank of the mesh, in place."""
    dist.broadcast(x, src=0, group=mesh.group)
    _note("broadcast", None, x)
    return x


def any_rank(flag: torch.Tensor, mesh) -> torch.Tensor:
    """True on every rank when `flag` is true on any: a MAX all-reduce
    over the flat group, returned as a bool scalar on the device. It is
    the JAX package's replicated pmax predicate of a lax.cond: every
    rank holds the same value, so every rank takes the same branch of
    the `cond` it feeds (utils/cond.cond: a conditional node in a CUDA
    graph, one host read eagerly). That is what keeps the collectives
    inside the branches paired: ranks on different branches would hang.
    Make it outside the branches, on every rank."""
    t = flag.reshape(1).to(torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    _note("all-reduce", None, t)
    return t[0] > 0


# the exchange's branches: cond name -> (the leg its false side runs,
# its true side's), each true side the full-size explicit path; CAFE's
# hierarchical id legs (embeddings/cafe.py) on a two-level mesh too
BRANCHES = {"fetch_unique": ("fetch_compact", "fetch_full"),
            "apply_unique": ("apply_compact", "apply_full"),
            "fetch_a2a": ("fetch_a2a", "fetch_a2a_full"),
            "apply_a2a": ("apply_a2a", "apply_a2a_full"),
            "route_unique": ("route_compact", "route_full"),
            "insert_unique": ("insert_compact", "insert_full")}


def exchange_branches(since: Optional[dict] = None) -> dict:
    """{leg: runs} of the exchange's branches (BRANCHES), eager calls and
    graph replays together (the warm-up's spare runs left out), minus
    `since` (an earlier return); legs that did not run are left out."""
    runs = branch_runs()
    out = {}
    for name, legs in BRANCHES.items():
        for where in ("eager", "graph"):
            for leg, n in zip(legs, runs[where].get(name, (0, 0))):
                out[leg] = out.get(leg, 0) + n
    since = since or {}
    return {leg: n - since.get(leg, 0) for leg, n in out.items()
            if n - since.get(leg, 0)}


def owner_rows_with(fetch, rows_l: int, all_idx: torch.Tensor,
                    mesh) -> torch.Tensor:
    """`_owner_rows` with a caller-supplied local row fetch:
    fetch(local_idx [M] int64) -> [M, D]; lanes owned elsewhere come back
    zero (ready for a psum / reduce-scatter)."""
    loc = all_idx.long() - mesh.rank * rows_l
    mine = (loc >= 0) & (loc < rows_l)
    vals = fetch(loc.clamp(0, rows_l - 1))
    return torch.where(mine[:, None], vals, torch.zeros_like(vals))


def _owner_rows(tbl: torch.Tensor, all_idx: torch.Tensor,
                mesh) -> torch.Tensor:
    """Rows of `tbl` (this rank's shard) for global row ids `all_idx`;
    zeros for rows owned elsewhere."""
    return owner_rows_with(lambda i: tbl[i], tbl.shape[0], all_idx, mesh)


def _local_idx(rows_l: int, all_idx: torch.Tensor, mesh) -> torch.Tensor:
    """Global row ids -> local int32 indices; out-of-shard lanes ->
    rows_l (the scatter drop index)."""
    loc = all_idx.long() - mesh.rank * rows_l
    return torch.where((loc >= 0) & (loc < rows_l), loc,
                       rows_l).to(torch.int32)


def owner_lookup_1d(arr_l: torch.Tensor, all_idx: torch.Tensor,
                    mesh) -> torch.Tensor:
    """Range-sharded 1-D array lookup: each rank answers the lanes whose
    global index falls in its shard; every lane has exactly one owner, so
    a psum of the masked answers publishes the exact values."""
    rows_l = arr_l.shape[0]
    loc = all_idx.long() - mesh.rank * rows_l
    mine = (loc >= 0) & (loc < rows_l)
    vals = arr_l[loc.clamp(0, rows_l - 1)]
    return psum(torch.where(mine, vals, torch.zeros_like(vals)), mesh)


def owner_lookup_cyclic(arr_l: torch.Tensor, all_idx: torch.Tensor,
                        mesh) -> torch.Tensor:
    """CYCLIC-sharded 1-D lookup (owner = idx % n, local position = idx
    // n: AdaPart's dic / grad_norm layout): one owner per lane, so a
    psum publishes the exact values."""
    n, rows_l = mesh.size, arr_l.shape[0]
    all_idx = all_idx.long()
    mine = all_idx % n == mesh.rank
    vals = arr_l[torch.where(mine, all_idx // n, 0).clamp(0, rows_l - 1)]
    return psum(torch.where(mine, vals, torch.zeros_like(vals)), mesh)


def unique_cap(m: int, frac: float) -> int:
    """Per-device unique-id capacity for a flattened batch of m lanes:
    ceil(m*frac) rounded up to 64 lanes; 0 (== off) when frac is 0 or the
    cap wouldn't actually shrink the exchange. (A copy of the JAX
    package's, so the two gates agree.)"""
    if frac <= 0.0:
        return 0
    c = ((int(m * frac) + 63) // 64) * 64
    return c if 0 < c < m else 0


def _fetch_full(mesh, tbl: torch.Tensor, flat: torch.Tensor,
                transport: str = "group") -> torch.Tensor:
    """The full explicit fetch of `flat`'s rows over the flat group, on
    `transport` (all_gather's)."""
    all_idx = all_gather(flat, mesh, transport=transport)
    return psum_scatter(_owner_rows(tbl, all_idx, mesh), mesh,
                        transport=transport)


def sharded_fetch(mesh, table: torch.Tensor, idx: torch.Tensor,
                  unique_frac: float = 0.0) -> torch.Tensor:
    """This rank's row shard [R/n, D] x this rank's global row ids
    [b, F] -> [b, F, D].

    unique_frac > 0 turns on the UNIQUE-COMPACT exchange: the distinct
    row ids compact into a C-lane buffer (C = unique_cap), the exchange
    ships C rows instead of b*F, and a local expand restores the lanes.
    If any rank overflows C, every rank takes the full-size path (inside
    the branch, on body_transport). On a two-level mesh the exchange is
    hierarchical (_fetch_hier)."""
    if mesh.inner:
        return _fetch_hier(mesh, table, idx, unique_frac)
    b, fld = idx.shape
    flat = idx.reshape(b * fld)
    capacity = unique_cap(b * fld, unique_frac)
    if capacity:
        uids, inv, nu = unique_compact(flat, capacity, DROP_ROW)
        urows = _fetch_full(mesh, table, uids)               # [C, D]
        rare = body_transport(mesh)

        def compact(flat_, urows_, inv_):
            return urows_[inv_.clamp(0, capacity - 1).long()]

        def full(flat_, urows_, inv_):
            return _fetch_full(mesh, table, flat_, rare)

        rows = cond(any_rank(nu > capacity, mesh), full, compact,
                    (flat, urows, inv), name="fetch_unique")
        return rows.reshape(b, fld, -1)
    return _fetch_full(mesh, table, flat).reshape(b, fld, -1)


def _host_fetch(mesh, tbl: torch.Tensor, ids_x: torch.Tensor
                ) -> torch.Tensor:
    """The outer leg of the hierarchical fetch. `ids_x` is the
    host-combined id buffer that every rank of the host holds: all-gather
    it over "dcn", answer the rows this rank owns (flat ownership), sum
    the host's partial answers over "ici", then reduce-scatter over "dcn"
    back to one chunk a host, the same on every rank of the host."""
    dcn_ids = all_gather(ids_x, mesh, "dcn")
    rows = psum(_owner_rows(tbl, dcn_ids, mesh), mesh, "ici")
    return psum_scatter(rows, mesh, "dcn")


def _fetch_hier(mesh, table: torch.Tensor, idx: torch.Tensor,
                unique_frac: float) -> torch.Tensor:
    """The hierarchical fetch: the host's ids [m_host] all-gathered over
    "ici" first, so only they (or, compact, their C distinct ids, C =
    unique_cap(m_host)) cross "dcn"; this rank's m lanes are the slice at
    ici_index * m of the host's answer. The overflow test runs over the
    whole mesh, so every rank takes the same branch; the compact leg
    runs before it, the full one inside it (on the row and column
    groups: body_transport is "group" here)."""
    b, fld = idx.shape
    m = b * fld
    ici_ids = all_gather(idx.reshape(m), mesh, "ici")     # [m_host]
    me = slice(mesh.ici_index * m, (mesh.ici_index + 1) * m)
    capacity = unique_cap(ici_ids.shape[0], unique_frac)
    if capacity:
        uids, inv, nu = unique_compact(ici_ids, capacity, DROP_ROW)
        urows = _host_fetch(mesh, table, uids)               # [C, D]

        def compact(ici_, urows_, inv_):
            return urows_[inv_[me].clamp(0, capacity - 1).long()]

        def full(ici_, urows_, inv_):
            return _host_fetch(mesh, table, ici_)[me]

        rows = cond(any_rank(nu > capacity, mesh), full, compact,
                    (ici_ids, urows, inv), name="fetch_unique")
        return rows.reshape(b, fld, -1)
    return _host_fetch(mesh, table, ici_ids)[me].reshape(b, fld, -1)


def a2a_cap(m: int, n: int, slack: float = 1.5) -> int:
    """Per-peer request capacity for the all-to-all exchange: a uniform
    owner hash puts ~m/n lanes on each peer; `slack` absorbs skew
    (overflow falls back to the full explicit path). Multiple of 128."""
    c = int(m / n * slack) + 1
    c = ((c + 127) // 128) * 128
    return min(c, ((m + 127) // 128) * 128)


def route_to_owners(flat: torch.Tensor, rows_l: int, n: int, cap: int):
    """Partition a rank's m global row ids by owner shard (range
    sharding: owner = id // rows_l) into a [n, cap] request buffer.

    Returns (reqs [n, cap] int32 with DROP_ROW padding, owner [m] int32,
    slot [m] int32, overflow [] bool). (owner[i], slot[i]) locates lane
    i's answer in the returned [n, cap, D] row buffer. Lanes with ids >=
    n*rows_l (DROP_ROW padding) are not shipped. One stable sort and
    scans, exactly as the JAX package computes it."""
    m = flat.shape[0]
    dev = flat.device
    flat = flat.to(torch.int32)
    valid = flat < rows_l * n
    okey = torch.where(valid, torch.div(flat, rows_l, rounding_mode="floor"),
                       n).to(torch.int32)
    order = torch.argsort(okey, stable=True)
    so = okey[order]
    idx = torch.arange(m, dtype=torch.int32, device=dev)
    head = torch.ones(m, dtype=torch.bool, device=dev)
    head[1:] = so[1:] != so[:-1]
    start = torch.cummax(torch.where(head, idx, 0), 0).values
    slot_sorted = idx - start
    ok = (so < n) & (slot_sorted < cap)
    pos = torch.where(ok, so * cap + slot_sorted, n * cap).long()
    reqs = torch.full((n * cap + 1,), DROP_ROW, dtype=torch.int32,
                      device=dev)
    reqs[pos] = flat[order]      # in-range positions are distinct
    slot = torch.empty(m, dtype=torch.int32, device=dev)
    slot[order] = slot_sorted
    overflow = ((so < n) & (slot_sorted >= cap)).any()
    return reqs[: n * cap].reshape(n, cap), okey, slot, overflow


def _a2a(xs: torch.Tensor, mesh, impl: str) -> torch.Tensor:
    """One all-to-all over the mesh: xs [n, ...] chunk j to peer j ->
    [n, ...] chunk s from peer s. impl: 'lax' (dist.all_to_all_single) or
    'pallas' (kernel K5, kernels/a2a.py)."""
    if impl == "pallas":
        out = _a2a_kernel.all_to_all(xs, mesh)
    elif impl == "lax":
        out = _a2a_kernel.all_to_all_plain(xs, mesh)
    else:
        raise ValueError(f"unknown all-to-all impl {impl!r}")
    _note("all-to-all", None, out)
    return out


def sharded_fetch_a2a(mesh, table: torch.Tensor, idx: torch.Tensor,
                      slack: float = 1.5, impl: str = "lax") -> torch.Tensor:
    """Request-routed all-to-all forward: each rank sends each owner only
    the ids it needs and receives only those rows (~m*4 + m*D*4*(n-1)/n
    bytes a rank, against sharded_fetch's ~m*D*4*(n-1)). Skew beyond the
    per-peer capacity takes the full explicit path on every rank (inside
    the branch, on body_transport), and so does a two-level mesh (the
    explicit path's hierarchical legs). Both all-to-all rounds and the
    owner's lookup between them run before the branch."""
    if mesh.inner:
        return sharded_fetch(mesh, table, idx)
    n = mesh.size
    b, fld = idx.shape
    m = b * fld
    flat = idx.reshape(m)
    rows_l = table.shape[0]
    cap = a2a_cap(m, n, slack)
    reqs, owner, slot, overflow = route_to_owners(flat, rows_l, n, cap)
    got = _a2a(reqs, mesh, impl)                      # [n, cap] ids I own
    loc = _local_idx(rows_l, got.reshape(-1), mesh).long()
    rows = table[loc.clamp(0, rows_l - 1)]
    rows = torch.where((loc < rows_l)[:, None], rows, torch.zeros_like(rows))
    back = _a2a(rows.reshape(n, cap, -1), mesh, impl)
    rare = body_transport(mesh)

    def routed(flat_, back_, owner_, slot_):
        # lanes past a peer's capacity (a warm-up's spare run of this
        # branch on an overflow step) read inside the buffer
        mine = back_.reshape(n * cap, -1)[
            (owner_.clamp(0, n - 1) * cap + slot_.clamp(0, cap - 1)).long()]
        return torch.where((owner_ < n)[:, None], mine,
                           torch.zeros_like(mine))

    def full(flat_, back_, owner_, slot_):
        return _fetch_full(mesh, table, flat_, rare)

    out = cond(any_rank(overflow, mesh), full, routed,
               (flat, back, owner, slot), name="fetch_a2a")
    return out.reshape(b, fld, -1)


def _apply_full(mesh, table, slots, fi, fg, lr, optimizer, apply_impl,
                axis=None, transport="group"):
    """All-gather the (id, grad) pairs over the mesh (or, for the
    hierarchical apply, over "dcn"), on `transport`, and let the owners
    apply them."""
    ai = all_gather(fi, mesh, axis, transport)
    ag = all_gather(fg, mesh, axis, transport)
    return apply_rows(table, slots, _local_idx(table.shape[0], ai, mesh),
                      ag, lr, optimizer, apply_impl)


def sharded_apply_a2a(mesh, table: torch.Tensor, slots, idx: torch.Tensor,
                      grad: torch.Tensor, lr, optimizer: str,
                      slack: float = 1.5, impl: str = "lax",
                      apply_impl: str = "auto"):
    """Owner-routed all-to-all backward: duplicates coalesce locally,
    then each (id, grad row) ships only to its owner (both all-to-alls
    before the branch, the owner's apply inside it). Overflow takes the
    explicit path on every rank, and so does a two-level mesh. Updates
    the shard in place; returns (table, slots)."""
    if mesh.inner:
        return sharded_apply(mesh, table, slots, idx, grad, lr, optimizer,
                             apply_impl=apply_impl)
    n = mesh.size
    m = idx.numel()
    g = grad.reshape(m, -1)
    rows_l = table.shape[0]
    cap = a2a_cap(m, n, slack)
    fi, fg = coalesce(idx.reshape(m), g, drop_sentinel=DROP_ROW)
    reqs, owner, slot, overflow = route_to_owners(fi, rows_l, n, cap)
    # grads ride the same (owner, slot) routing as the ids; lanes past a
    # peer's capacity (an overflow step, whose routed leg is thrown away)
    # go to the spare row
    pos = torch.where((owner < n) & (slot < cap),
                      owner.clamp(0, n - 1) * cap + slot, n * cap).long()
    gbuf = torch.zeros((n * cap + 1, fg.shape[1]), dtype=fg.dtype,
                       device=fg.device)
    gbuf[pos] = fg               # in-range positions are distinct
    ids_in = _a2a(reqs, mesh, impl).reshape(-1)
    g_in = _a2a(gbuf[: n * cap].reshape(n, cap, -1), mesh,
                impl).reshape(n * cap, -1)
    rare = body_transport(mesh)

    def routed(table_, slots_, fi_, fg_, ids_in_, g_in_):
        # a branch writes its result into its operands: the apply works
        # in place, and copy_into copies what it returned anew (Adam's t)
        copy_into((table_, slots_), apply_rows(
            table_, slots_, _local_idx(rows_l, ids_in_, mesh), g_in_, lr,
            optimizer, apply_impl))

    def full(table_, slots_, fi_, fg_, *_):
        copy_into((table_, slots_), _apply_full(
            mesh, table_, slots_, fi_, fg_, lr, optimizer, apply_impl,
            transport=rare))

    cond(any_rank(overflow, mesh), full, routed,
         (table, slots, fi, fg, ids_in, g_in), name="apply_a2a")
    return table, slots


def sharded_apply(mesh, table: torch.Tensor, slots, idx: torch.Tensor,
                  grad: torch.Tensor, lr, optimizer: str,
                  unique_frac: float = 0.0, apply_impl: str = "auto"):
    """Owner-compute sparse update: (idx [b, F] global rows, grad
    [b, F, D]) of this rank's batch slice; duplicates coalesce locally
    before the all-gather. `slots` as ops.sparse.init_slots makes them
    (row slots are sharded with the table). unique_frac > 0 ships the
    coalesced (id, grad) pairs in C-lane buffers (their all-gathers
    before the branch), with the full-size path inside it when any rank
    overflows (see sharded_fetch). On a two-level mesh the (id, grad)
    pairs combine over "ici" before they cross "dcn". Updates the shard
    in place; returns (table, slots)."""
    m = idx.numel()
    flat, g = idx.reshape(m), grad.reshape(m, -1)
    axis = None
    if mesh.inner:
        # the host's lanes, combined below before anything crosses dcn
        flat, g = all_gather(flat, mesh, "ici"), all_gather(g, mesh, "ici")
        axis = "dcn"
    capacity = unique_cap(flat.shape[0], unique_frac)
    if capacity:
        cidx, cgrad, nu = coalesce_compact(flat, g, capacity, DROP_ROW)
        ai = all_gather(cidx, mesh, axis)
        ag = all_gather(cgrad, mesh, axis)
        rare = body_transport(mesh)

        def compact(table_, slots_, flat_, g_, ai_, ag_):
            copy_into((table_, slots_), apply_rows(
                table_, slots_, _local_idx(table_.shape[0], ai_, mesh),
                ag_, lr, optimizer, apply_impl))

        def full(table_, slots_, flat_, g_, ai_, ag_):
            fi, fg = coalesce(flat_, g_, drop_sentinel=DROP_ROW)
            copy_into((table_, slots_), _apply_full(
                mesh, table_, slots_, fi, fg, lr, optimizer, apply_impl,
                axis, rare))

        cond(any_rank(nu > capacity, mesh), full, compact,
             (table, slots, flat, g, ai, ag), name="apply_unique")
        return table, slots
    fi, fg = coalesce(flat, g, drop_sentinel=DROP_ROW)
    return _apply_full(mesh, table, slots, fi, fg, lr, optimizer,
                       apply_impl, axis)
