"""Process groups and the 1-D mesh (port of cafe_tpu/parallel/mesh.py).

One mesh axis, "data", serves double duty as in the JAX package: dense
towers are data-parallel over it while embedding tables and sketch
buckets are row-sharded over the same ranks. Where the JAX package has one
process with many devices, the port has one process per device: rank r
owns device r of the mesh, its row shard of every sharded table and its
slice of every batch.

Backends: NCCL for a mesh on the card, gloo for a mesh on the CPU (the
tests). The backend follows the mesh's device; nothing switches between
them on its own.
"""

from __future__ import annotations

import os
from dataclasses import dataclass, field
from typing import Optional

import torch
import torch.distributed as dist

from ..device import resolve_device

AXIS = "data"


@dataclass
class Mesh:
    """This rank's view of a flat ("data",) mesh of `size` ranks.

    `group` is the mesh's own process group: every collective of the
    sharded path names it. `a2a_workspaces` holds the peer-write
    all-to-all's shared buffers (kernels/a2a.py), one per chunk size,
    owned here so that they live and die with the mesh."""

    size: int
    rank: int
    device: torch.device
    group: object
    axis_names: tuple = (AXIS,)
    a2a_workspaces: dict = field(default_factory=dict, repr=False)

    @property
    def backend(self) -> str:
        return dist.get_backend(self.group)

    def close(self) -> None:
        """Release the all-to-all workspaces (collective: every rank of
        the mesh calls it)."""
        if self.a2a_workspaces:
            dist.barrier(group=self.group)
            for ws in self.a2a_workspaces.values():
                ws.close()
            self.a2a_workspaces.clear()


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
    """The flat ("data",) mesh over all ranks of the default group (which
    must exist: maybe_init_distributed). `n_devices` must equal the world
    size, as a JAX mesh under multi-process execution must cover every
    process's devices. Collectives run on a new group of the mesh's
    backend (NCCL on the card, gloo on the CPU)."""
    if inner:
        raise NotImplementedError(
            "mesh_inner > 0: the two-level (dcn, ici) mesh and its "
            "hierarchical exchange are not ported yet (ROADMAP queue Q8)")
    if not dist.is_initialized():
        raise RuntimeError("make_mesh: no process group; call "
                           "maybe_init_distributed first")
    world = dist.get_world_size()
    n = world if n_devices is None else int(n_devices)
    if n != world:
        raise ValueError(f"requested a {n}-device mesh but the process "
                         f"group has {world} ranks (one device each); "
                         f"launch {n} processes")
    dev = _local_device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    group = dist.new_group(list(range(n)), backend=_backend(dev))
    return Mesh(size=n, rank=dist.get_rank(), device=dev, group=group)
