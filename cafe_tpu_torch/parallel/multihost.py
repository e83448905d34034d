"""Per-rank input feeding and host-side gathering for multi-node runs
(port of cafe_tpu/parallel/multihost.py).

Every rank iterates the SAME logical batch stream (the datasets are
identical files or identically seeded generators on every node) but
only reads and uploads ITS rows: rank r takes rows [r*B/n, (r+1)*B/n) of
each global batch, the slice the mesh assigns it, so no batch data moves
between ranks at input time.

A multi-node launch (`torchrun --nnodes N --nproc_per_node P ...`) numbers
the ranks node by node and sets LOCAL_RANK, which picks the rank's card
(parallel/mesh._local_device). With `--mesh_inner P` each "ici" row of
the two-level mesh is then one node's ranks, and "dcn" crosses the nodes.
"""

from __future__ import annotations

from typing import Iterator

import numpy as np
import torch

from ..data.loader import device_prefetch
from .exchange import all_gather
from .sharding import rows_of


def global_batches(mesh, batch_iter: Iterator, depth: int = 4,
                   local: bool = False) -> Iterator:
    """This rank's slice of each (dense, sparse, label, valid) batch as
    tensors on the mesh's device, `depth` uploads ahead of the consumer
    (data/loader.device_prefetch).

    local=False: the iterator yields GLOBAL batches (every rank built the
    whole batch; its slice is cut here), which must divide by the mesh.
    local=True: the iterator already yields this rank's rows
    (data.process_batch_iterator), the per-rank I/O path."""
    def cut(batches):
        for dense, sparse, label, valid in batches:
            rows = sparse.shape[0]
            if rows % mesh.size:
                raise ValueError(f"global batch {rows} must divide by "
                                 f"{mesh.size} ranks")
            sl = rows_of(mesh, rows)
            yield (None if dense is None else dense[sl], sparse[sl],
                   label[sl], valid)

    return device_prefetch(batch_iter if local else cut(batch_iter),
                           mesh.device, depth)


def gather_to_host(x: torch.Tensor, mesh=None) -> np.ndarray:
    """The mesh's all-gathered `x` (rank-major along dim 0) as numpy on
    every rank: eval scores under a mesh. Without a mesh, `x` itself. A
    copy, never a view: an eval step may write its next scores into the
    tensor it returned."""
    if mesh is not None and mesh.size > 1:
        x = all_gather(x, mesh)
    return np.array(x.detach().cpu())
