"""Sharded training on torch.distributed (port of cafe_tpu/parallel/, the
flat 1-D mesh): one process per device, NCCL on the card, gloo on the
CPU."""

from .mesh import Mesh, make_mesh, maybe_init_distributed
from .sharding import batch_slice, shard_state, unshard_state

__all__ = ["Mesh", "make_mesh", "maybe_init_distributed", "batch_slice",
           "shard_state", "unshard_state"]
