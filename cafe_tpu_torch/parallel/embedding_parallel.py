"""The explicit embedding exchange of one table, in its plainest form
(port of cafe_tpu/parallel/embedding_parallel.py, the JAX package's
demonstration module; parallel/exchange.py is the production exchange,
with dedup, the optimizers and the shard-local sketch).

A table row-sharded over the mesh, ids sharded by batch; per call:

  1. all-gather the int32 ids over the mesh,
  2. each rank reads the rows it owns, zeros elsewhere,
  3. a reduce-scatter returns each rank exactly its ids' rows;

and the update is owner-compute: the (ids, updates) pairs are
all-gathered and each rank adds those of the rows it owns.

Each function takes this rank's shard of the table and this rank's ids,
as the JAX package's shard_map bodies do.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from .exchange import _local_idx, _owner_rows, all_gather, psum_scatter


def sharded_gather(mesh, table: torch.Tensor,
                   ids: torch.Tensor) -> torch.Tensor:
    """This rank's shard [N/n, D] x this rank's global row ids [m] ->
    their rows [m, D]."""
    return psum_scatter(_owner_rows(table, all_gather(ids, mesh), mesh),
                        mesh)


def sharded_scatter_add(mesh, table: torch.Tensor, ids: torch.Tensor,
                        updates: torch.Tensor) -> torch.Tensor:
    """table[ids] += updates over the mesh, in place: every rank adds the
    all-gathered updates of the rows it owns (duplicates sum, as on one
    device). Returns this rank's shard."""
    rows_l = table.shape[0]
    loc = _local_idx(rows_l, all_gather(ids, mesh), mesh).long()
    upd = all_gather(updates, mesh)
    # lanes owned elsewhere add zeros to a row of the shard
    upd = torch.where((loc < rows_l)[:, None], upd, torch.zeros_like(upd))
    return table.index_add_(0, loc.clamp_max(rows_l - 1), upd)


def sharded_embedding_lookup_and_update(
        mesh, table: torch.Tensor, ids: torch.Tensor,
        grads_fn: Callable[[torch.Tensor], torch.Tensor],
        lr: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Lookup -> the caller's row grads from the returned rows ->
    owner-compute SGD. Returns (rows, the updated shard)."""
    rows = sharded_gather(mesh, table, ids)
    g = grads_fn(rows)
    return rows, sharded_scatter_add(mesh, table, ids, -lr * g)
