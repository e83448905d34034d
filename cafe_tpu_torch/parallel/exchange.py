"""The sharded embedding exchange on torch.distributed (port of the flat
parts of cafe_tpu/parallel/exchange.py).

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

Each function here is the body of the JAX package's `shard_map`: it takes
this rank's shard of the table and this rank's slice of the batch, and
every collective names the mesh's group. The two-level mesh and the
unique-compact buffers are not ported (ROADMAP queue Q8).
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..kernels import a2a as _a2a_kernel
from ..ops.sparse import apply_rows, coalesce

# sentinel row index far above any real table; survives the owner's
# `- lo` shift still out of range, so scatters drop these lanes
DROP_ROW = 2**30

_all_gather_single = getattr(dist, "all_gather_single", None) \
    or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) \
    or dist.reduce_scatter_tensor


def all_gather(x: torch.Tensor, mesh) -> torch.Tensor:
    """Tiled all-gather along dim 0 (jax.lax.all_gather(tiled=True))."""
    out = torch.empty((mesh.size * x.shape[0],) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _all_gather_single(out, x.contiguous(), group=mesh.group)
    return out


def psum(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the mesh (a new tensor)."""
    y = x.clone()
    dist.all_reduce(y, group=mesh.group)
    return y


def psum_scatter(x: torch.Tensor, mesh) -> torch.Tensor:
    """Sum over the mesh, rank r keeping rows [r*k, (r+1)*k) of dim 0."""
    out = torch.empty((x.shape[0] // mesh.size,) + tuple(x.shape[1:]),
                      dtype=x.dtype, device=x.device)
    _reduce_scatter_single(out, x.contiguous(), group=mesh.group)
    return out


def any_rank(flag: torch.Tensor, mesh) -> bool:
    """True on every rank when `flag` is true on any: a MAX all-reduce and
    ONE host read. It replaces the JAX package's lax.cond on a replicated
    pmax. Every rank must take the same branch, or the collectives of the
    two branches would pair up wrongly and hang, so the flag is read back
    to the host: one sync per exchange (removing it is later perf work)."""
    t = flag.reshape(1).to(torch.int32)
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=mesh.group)
    return bool(t.item())


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


def unique_cap(m: int, frac: float) -> int:
    """Per-device unique-id capacity for a flattened batch of m lanes:
    ceil(m*frac) rounded up to 64 lanes; 0 (== off) when frac is 0 or the
    cap wouldn't actually shrink the exchange. (A copy of the JAX
    package's, so the two gates agree.)"""
    if frac <= 0.0:
        return 0
    c = ((int(m * frac) + 63) // 64) * 64
    return c if 0 < c < m else 0


def _no_unique_compact(unique_frac: float) -> None:
    if unique_frac > 0.0:
        raise NotImplementedError(
            "shard_unique_frac > 0: the unique-compact exchange is not "
            "ported yet (ROADMAP queue Q8)")


def _fetch_full(mesh, tbl: torch.Tensor, flat: torch.Tensor) -> torch.Tensor:
    all_idx = all_gather(flat, mesh)
    return psum_scatter(_owner_rows(tbl, all_idx, mesh), mesh)


def sharded_fetch(mesh, table: torch.Tensor, idx: torch.Tensor,
                  unique_frac: float = 0.0) -> torch.Tensor:
    """This rank's row shard [R/n, D] x this rank's global row ids
    [b, F] -> [b, F, D]."""
    _no_unique_compact(unique_frac)
    b, fld = idx.shape
    return _fetch_full(mesh, table, idx.reshape(b * fld)).reshape(b, fld, -1)


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
        return _a2a_kernel.all_to_all(xs, mesh)
    if impl == "lax":
        return _a2a_kernel.all_to_all_plain(xs, mesh)
    raise ValueError(f"unknown all-to-all impl {impl!r}")


def sharded_fetch_a2a(mesh, table: torch.Tensor, idx: torch.Tensor,
                      slack: float = 1.5, impl: str = "lax") -> torch.Tensor:
    """Request-routed all-to-all forward: each rank sends each owner only
    the ids it needs and receives only those rows (~m*4 + m*D*4*(n-1)/n
    bytes a rank, against sharded_fetch's ~m*D*4*(n-1)). Skew beyond the
    per-peer capacity takes the full explicit path on every rank."""
    n = mesh.size
    b, fld = idx.shape
    m = b * fld
    flat = idx.reshape(m)
    rows_l = table.shape[0]
    cap = a2a_cap(m, n, slack)
    reqs, owner, slot, overflow = route_to_owners(flat, rows_l, n, cap)
    if any_rank(overflow, mesh):
        return _fetch_full(mesh, table, flat).reshape(b, fld, -1)
    got = _a2a(reqs, mesh, impl)                     # [n, cap] ids I own
    loc = _local_idx(rows_l, got.reshape(-1), mesh).long()
    rows = table[loc.clamp(0, rows_l - 1)]
    rows = torch.where((loc < rows_l)[:, None], rows, torch.zeros_like(rows))
    back = _a2a(rows.reshape(n, cap, -1), mesh, impl)
    mine = back.reshape(n * cap, -1)[
        (owner.clamp(0, n - 1) * cap + slot).long()]
    out = torch.where((owner < n)[:, None], mine, torch.zeros_like(mine))
    return out.reshape(b, fld, -1)


def _apply_full(mesh, table, slots, fi, fg, lr, optimizer, apply_impl):
    ai = all_gather(fi, mesh)
    ag = all_gather(fg, mesh)
    return apply_rows(table, slots, _local_idx(table.shape[0], ai, mesh),
                      ag, lr, optimizer, apply_impl)


def sharded_apply_a2a(mesh, table: torch.Tensor, slots, idx: torch.Tensor,
                      grad: torch.Tensor, lr, optimizer: str,
                      slack: float = 1.5, impl: str = "lax",
                      apply_impl: str = "auto"):
    """Owner-routed all-to-all backward: duplicates coalesce locally,
    then each (id, grad row) ships only to its owner. Overflow takes the
    explicit path on every rank. Updates the shard in place; returns
    (table, slots)."""
    n = mesh.size
    m = idx.numel()
    g = grad.reshape(m, -1)
    rows_l = table.shape[0]
    cap = a2a_cap(m, n, slack)
    fi, fg = coalesce(idx.reshape(m), g, drop_sentinel=DROP_ROW)
    reqs, owner, slot, overflow = route_to_owners(fi, rows_l, n, cap)
    if any_rank(overflow, mesh):
        return _apply_full(mesh, table, slots, fi, fg, lr, optimizer,
                           apply_impl)
    # grads ride the same (owner, slot) routing as the ids
    pos = torch.where(owner < n, owner.clamp(0, n - 1) * cap + slot,
                      n * cap).long()
    gbuf = torch.zeros((n * cap + 1, g.shape[1]), dtype=g.dtype,
                       device=g.device)
    gbuf[pos] = fg          # in-range positions are distinct
    ids_in = _a2a(reqs, mesh, impl).reshape(-1)
    g_in = _a2a(gbuf[: n * cap].reshape(n, cap, -1), mesh,
                impl).reshape(n * cap, -1)
    return apply_rows(table, slots, _local_idx(rows_l, ids_in, mesh), g_in,
                      lr, optimizer, apply_impl)


def sharded_apply(mesh, table: torch.Tensor, slots, idx: torch.Tensor,
                  grad: torch.Tensor, lr, optimizer: str,
                  unique_frac: float = 0.0, apply_impl: str = "auto"):
    """Owner-compute sparse update: (idx [b, F] global rows, grad
    [b, F, D]) of this rank's batch slice; duplicates coalesce locally
    before the all-gather. `slots` as ops.sparse.init_slots makes them
    (row slots are sharded with the table). Updates the shard in place;
    returns (table, slots)."""
    _no_unique_compact(unique_frac)
    m = idx.numel()
    fi, fg = coalesce(idx.reshape(m), grad.reshape(m, -1),
                      drop_sentinel=DROP_ROW)
    return _apply_full(mesh, table, slots, fi, fg, lr, optimizer,
                       apply_impl)
