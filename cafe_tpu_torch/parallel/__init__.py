"""Sharded training on torch.distributed (port of cafe_tpu/parallel/):
one process per device, NCCL on the card, gloo on the CPU; the flat mesh
and the two-level (dcn, ici) mesh."""

from .mesh import Mesh, make_mesh, maybe_init_distributed
from .multihost import gather_to_host, global_batches
from .sharding import batch_slice, shard_state, unshard_state

__all__ = ["Mesh", "make_mesh", "maybe_init_distributed", "batch_slice",
           "shard_state", "unshard_state", "global_batches",
           "gather_to_host"]
