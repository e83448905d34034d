"""Process groups and the mesh (port of cafe_tpu/parallel/mesh.py).

The flat mesh has one axis, "data", which serves double duty as in the
JAX package: dense towers are data-parallel over it while embedding
tables and sketch buckets are row-sharded over the same ranks. Where the
JAX package has one process with many devices, the port has one process
per device: rank r owns device r of the mesh, its row shard of every
sharded table and its slice of every batch.

The two-level mesh (`inner` > 0) lays the same ranks out as a
("dcn", "ici") grid of shape (n // inner, inner): rank r sits at
(r // inner, r % inner), so consecutive ranks share a host, as
consecutive `jax.devices()` do. Row ownership and batch slices stay the
flat ones (the JAX package's flat-tuple semantics); only the
hierarchical exchange legs (parallel/exchange.py) run on the row
(`ici_group`: this rank's host) and the column (`dcn_group`: the ranks
of the same position on every host).

Backends: NCCL for a mesh on the card, gloo for a mesh on the CPU (the
tests). The backend follows the mesh's device; nothing switches between
them on its own.
"""

from __future__ import annotations

import itertools
import os
import socket
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

AXIS = "data"
TWO_LEVEL = ("dcn", "ici")


@dataclass
class Mesh:
    """This rank's view of a mesh of `size` ranks: flat ("data",), or
    with `inner` > 0 the two-level ("dcn", "ici") grid of shape
    (size // inner, inner).

    `group` is the mesh's own flat process group: every collective of the
    sharded path names it, except the hierarchical legs, which take
    `ici_group` (this rank's row) and `dcn_group` (its column).
    `a2a_workspaces` holds the peer-write all-to-all's shared buffers
    (kernels/a2a.py), one per chunk size, owned here so that they live
    and die with the mesh. `hosts` holds every rank's host name, gathered
    once when the mesh is made (empty: taken as one host); K5 reaches
    only one host's cards (parallel/exchange.body_transport)."""

    size: int
    rank: int
    device: torch.device
    group: object
    inner: int = 0
    ici_group: object = None
    dcn_group: object = None
    # the groups this rank made but is not in (released by close())
    other_groups: list = field(default_factory=list, repr=False)
    a2a_workspaces: dict = field(default_factory=dict, repr=False)
    hosts: tuple = ()

    @property
    def axis_names(self) -> tuple:
        return TWO_LEVEL if self.inner else (AXIS,)

    @property
    def shape(self) -> tuple:
        """The grid: (size,) flat, (size // inner, inner) two-level."""
        if self.inner:
            return (self.size // self.inner, self.inner)
        return (self.size,)

    @property
    def ici_index(self) -> int:
        """This rank's position within its host's row."""
        return self.rank % self.inner if self.inner else 0

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def close(self) -> None:
        """Release the all-to-all workspaces and the mesh's process groups
        (collective: every rank of the mesh calls it)."""
        if self.a2a_workspaces:
            dist.barrier(group=self.group)
            for ws in self.a2a_workspaces.values():
                ws.close()
            self.a2a_workspaces.clear()
        groups = [g for g in (self.ici_group, self.dcn_group, self.group)
                  if g is not None] + self.other_groups
        self.group = self.ici_group = self.dcn_group = None
        self.other_groups = []
        for g in groups:
            if g is not dist.GroupMember.NON_GROUP_MEMBER:
                dist.destroy_process_group(g)


def _backend(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def torchrun_world_size() -> Optional[int]:
    """WORLD_SIZE as torchrun sets it, else None."""
    if "WORLD_SIZE" in os.environ and "RANK" in os.environ:
        return int(os.environ["WORLD_SIZE"])
    return None


def maybe_init_distributed(cfg, device="cuda") -> bool:
    """Join the default process group unless one exists. Returns True when
    this call created it (the caller then destroys it at the end).

    * under `torchrun` (RANK / WORLD_SIZE / MASTER_ADDR in the
      environment): that rendezvous;
    * else with --dist_num_processes > 1: tcp://--dist_coordinator,
      rank --dist_process_id;
    * else a group of one in this process (an in-memory store, no port).
    """
    if dist.is_initialized():
        return False
    backend = _backend(resolve_device(device))
    n = int(getattr(cfg, "dist_num_processes", 1) or 1)
    if torchrun_world_size() is not None:
        dist.init_process_group(backend, init_method="env://")
    elif n > 1:
        addr = cfg.dist_coordinator or "localhost:12321"
        dist.init_process_group(backend, init_method=f"tcp://{addr}",
                                world_size=n,
                                rank=int(cfg.dist_process_id))
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return True


INIT_TRIES = 3
# what gloo's full-mesh connect raises when a peer drops a socket while
# the group forms (seen under many concurrent test processes)
RETRIED_INIT_ERROR = "Connection closed by peer"


def _agreed(make, undo, control, key: str, rank: int, world: int,
            what: str):
    """make(attempt) with the agreed retry: a try that fails with gloo's
    "Connection closed by peer" is retried, at most INIT_TRIES times;
    any other error raises. Every rank posts each try's outcome to the
    `control` store under `key` and waits for all of them, so the ranks
    leave a failed try together (a rank whose try did succeed undoes
    it: undo(result)) and no rank goes on alone. Returns make's
    result."""
    for attempt in range(INIT_TRIES):
        error = result = None
        try:
            result = make(attempt)
        except RuntimeError as e:
            error = e
        retry = error is not None and RETRIED_INIT_ERROR in str(error)
        control.set(f"{key}{attempt}/{rank}", "ok" if error is None
                    else "retry" if retry else "fail")
        states = {control.get(f"{key}{attempt}/{r}").decode()
                  for r in range(world)}
        if states == {"ok"}:
            return result
        if error is None:
            undo(result)
        elif not retry:
            raise error
        if "fail" in states or attempt == INIT_TRIES - 1:
            raise RuntimeError(f"rank {rank}: {what} did not form (try "
                               f"{attempt + 1}: {sorted(states)})"
                               ) from error


def init_file_group(backend: str, directory: str, rank: int,
                    world: int) -> None:
    """Join the default process group through a file:// store under
    `directory` (no port to clash), with the agreed retry (_agreed): a
    try that fails with "Connection closed by peer" is retried on a
    fresh store."""
    control = dist.FileStore(os.path.join(directory, "init_control"), world)
    _agreed(lambda attempt: dist.init_process_group(
        backend, init_method=f"file://{directory}/store_{attempt}",
        rank=rank, world_size=world),
        lambda _: dist.destroy_process_group(), control, "", rank, world,
        "the process group")


def new_group_agreed(ranks, backend: str, control, key: str, rank: int,
                     world: int):
    """dist.new_group(ranks, backend) on every rank of the default group
    (`rank` of `world`), with init_file_group's agreed retry over the
    `control` store under `key`: "Connection closed by peer" while the
    group connects is retried with a new group (each try takes the next
    group name on every rank), any other error raises."""
    return _agreed(lambda _: dist.new_group(ranks, backend=backend),
                   lambda g: None if g is dist.GroupMember.NON_GROUP_MEMBER
                   else dist.destroy_process_group(g),
                   control, key, rank, world, f"the group of ranks {ranks}")


# make_mesh calls so far: each mesh's keys on the control store
_MESHES = itertools.count()


def _local_device(device="cuda") -> torch.device:
    """This rank's device: cuda:LOCAL_RANK on the card (LOCAL_RANK from
    torchrun, else the rank modulo the visible cards), or the CPU."""
    dev = resolve_device(device)
    if dev.type != "cuda" or dev.index is not None:
        return dev
    if "LOCAL_RANK" in os.environ:
        idx = int(os.environ["LOCAL_RANK"])
    else:
        idx = dist.get_rank() % torch.cuda.device_count()
    return torch.device("cuda", idx)


def make_mesh(n_devices: Optional[int] = None, inner: int = 0,
              device="cuda") -> Mesh:
    """The mesh over all ranks of the default group (which must exist:
    maybe_init_distributed): flat ("data",), or with `inner` > 0 the
    two-level ("dcn", "ici") mesh of shape (n // inner, inner), which
    raises when `inner` does not divide n. `n_devices` must equal the
    world size, as a JAX mesh under multi-process execution must cover
    every process's devices. Collectives run on new groups of the mesh's
    backend (NCCL on the card, gloo on the CPU).

    Every rank creates every row and column group, in the same order,
    including those it is not in: both backends hang or fail otherwise.
    Each group forms with the agreed retry (new_group_agreed, on the
    default group's store), and the ranks' host names are gathered into
    `hosts`."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "maybe_init_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    inner = int(inner or 0)
    if inner and (inner < 0 or n % inner):
        raise ValueError(f"mesh_inner {inner} does not divide {n} devices")
    if n != world:
        raise ValueError(f"requested a {n}-device mesh but the process "
                         f"group has {world} ranks (one device each); "
                         f"launch {n} processes")
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    backend = _backend(dev)
    rank = dist.get_rank()
    control = dist.distributed_c10d._get_default_store()
    tag = f"make_mesh/{next(_MESHES)}/"
    groups = itertools.count()

    def new_group(ranks):
        return new_group_agreed(ranks, backend, control,
                                f"{tag}{next(groups)}/", rank, world)

    mesh = Mesh(size=n, rank=rank, device=dev, inner=inner,
                group=new_group(list(range(n))))
    if inner:
        rows = [list(range(h * inner, (h + 1) * inner))
                for h in range(n // inner)]
        cols = [list(range(c, n, inner)) for c in range(inner)]
        for kind, ranks in [("ici", r) for r in rows] + \
                [("dcn", c) for c in cols]:
            g = new_group(ranks)
            if rank in ranks:
                setattr(mesh, f"{kind}_group", g)
            else:
                mesh.other_groups.append(g)
    hosts = [None] * n
    dist.all_gather_object(hosts, socket.gethostname(), group=mesh.group)
    mesh.hosts = tuple(hosts)
    return mesh
