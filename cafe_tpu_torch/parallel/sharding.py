"""Which state leaves are row-sharded, and the rank's slices of the state
and the batch (port of cafe_tpu/parallel/sharding.py).

The JAX package annotates the global state with NamedShardings and lets
XLA place it; here each rank holds its slices outright. The leaf rules
are the JAX package's `state_shardings` rules:

  * every embedding table / optimizer slot [rows, dim] of a part that
    runs the explicit exchange -> this rank's rows, except QR's
    remainder table `r` and its slots, which a sharded QRPart keeps whole
    on every rank (the JAX package annotates `r` row-sharded but updates
    it as one global array, which is the same values);
  * AdaEmbed's dic / grad_norm and Off's hot_dict ([N] int32 / f32) ->
    this rank's slice (Ada's is cyclic-permuted, so the slice is the
    rank's ids);
  * sketch bucket arrays val/cnt/dic [n*S_l, C] and the free stacks
    [n*S_l] -> this rank's buckets;
  * the per-shard scalar lanes free_top / tot ([n]) -> this rank's lane
    ([1]; sketch/sharded.shard_local_view squeezes it);
  * everything else (dense towers, optimizer state of the towers, tick,
    step, AdaEmbed's step and key, every leaf of a part that stays
    replicated) -> a full copy.

A part that does not run the exchange (Part.mesh is None) stays
replicated as a whole: the JAX package leaves such a part to XLA's
partitioner, which gives the same values as a replicated table updated
with the global batch (embeddings/base.EmbeddingLayer does that).

The `auto` layout (--shard_exchange auto; a part's `auto_keys`): the row
tables and their optimizer slots (the _ROW_SHARDED_2D names) with >= 512
rows that divide by n are row-sharded, as the JAX package's
`state_shardings` shards them; everything else, the sketch included,
stays whole on every rank. The JAX package also shards the sketch there,
but its partitioner keeps the single-device values; a whole sketch fed
the global batch gives them by construction (the port has no
partitioner, and a bucket-sharded sketch would need one allocation order
across the ranks' free stacks). Only the placement differs.

Which leaves a part shards is the part's own: the explicit rule above
for a part that runs the exchange, `auto_keys` under auto; shard_state,
unshard_state and global_like read it from each part of the layer.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

from .exchange import all_gather

_ROW_TABLES = {"table", "hash", "high", "q", "hot", "cold", "weight"}
_ROW_SHARDED_2D = {t + sfx for t in _ROW_TABLES
                   for sfx in ("", "_acc", "_m", "_v")}
_ROW_SHARDED_1D = {"dic", "grad_norm", "hot_dict"}
_SKETCH_2D = {"val", "cnt", "val1", "cnt1", "dic1",
              "val2", "cnt2", "dic2", "ts2"}
_SCALAR_LANES = ("free_top", "tot", "threshold", "real_n", "decay_acc",
                 "step")

_MIN_ROWS = 512  # everything is ROW_ALIGN(512)-padded; smaller = scalarish


def leaf_is_sharded(name: str, shape, n: int) -> bool:
    """The JAX package's rule for a leaf of a part that runs the explicit
    exchange, on the leaf's GLOBAL shape."""
    if not shape:
        return False
    if name in _SCALAR_LANES and len(shape) == 1 and shape[0] == n:
        return True
    if shape[0] % n:
        return False
    if len(shape) == 2 and name in _SKETCH_2D and shape[0] >= n:
        return True
    if len(shape) == 1 and name == "free" and shape[0] >= n:
        return True
    if len(shape) == 2 and shape[0] >= _MIN_ROWS and (
            name in _ROW_SHARDED_2D or name == "dic"):
        return True
    return len(shape) == 1 and shape[0] >= _MIN_ROWS \
        and name in _ROW_SHARDED_1D


def auto_leaf_is_sharded(name: str, shape, n: int) -> bool:
    """The auto layout's rule, on a leaf's GLOBAL shape."""
    return len(shape) == 2 and name in _ROW_SHARDED_2D \
        and shape[0] >= _MIN_ROWS and shape[0] % n == 0


def _map_named(fn: Callable, node, name: str = ""):
    if isinstance(node, dict):
        return {k: _map_named(fn, v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_named(fn, v, name) for v in node]
    if node is None:
        return None
    return fn(name, node)


def _sharded(part, name: str, global_shape, n: int) -> bool:
    """Whether leaf `name` of `part` is row-sharded (its layout)."""
    if part.mesh is not None:
        return leaf_is_sharded(name, global_shape, n)
    return name in part.auto_keys


def _map_embed(state, embed_layer, fn):
    """state with fn(part, name, leaf) applied to the leaves of every part
    that shards any (the explicit exchange or auto); other fields and
    parts unchanged."""
    embed = {key: (_map_named(lambda nm, x, p=p: fn(p, nm, x), sub)
                   if p.mesh is not None or p.auto_keys else sub)
             for (key, sub), p in zip(state.embed.items(),
                                      embed_layer.parts)}
    return state._replace(embed=embed)


def rows_of(mesh, rows: int) -> slice:
    """This rank's slice of `rows` rows (or batch lanes)."""
    per = rows // mesh.size
    return slice(mesh.rank * per, (mesh.rank + 1) * per)


def shard_state(state: Any, mesh, embed_layer) -> Any:
    """This rank's state from a global TrainState (a copy of every sharded
    leaf's slice; replicated leaves are shared, not copied)."""
    def cut(part, name, x):
        if _sharded(part, name, tuple(x.shape), mesh.size):
            return x[rows_of(mesh, x.shape[0])].clone()
        return x
    return _map_embed(state, embed_layer, cut)


def _joined(part, name: str, x, n: int):
    """The global shape of a rank's leaf `x` if it is a shard of a
    sharded leaf, else None. Under the explicit rule a sharded leaf is
    told apart by its global shape (local rows x mesh size), which is
    exact for the leaves the ported parts hold."""
    if not x.dim():
        return None
    shape = (x.shape[0] * n,) + tuple(x.shape[1:])
    return shape if _sharded(part, name, shape, n) else None


def unshard_state(state: Any, mesh, embed_layer) -> Any:
    """The global TrainState from every rank's shards (collective: every
    rank calls it and gets the whole state)."""
    def join(part, name, x):
        return x if _joined(part, name, x, mesh.size) is None \
            else all_gather(x, mesh)
    return _map_embed(state, embed_layer, join)


def global_like(state: Any, mesh, embed_layer) -> Any:
    """unshard_state's result as shapes only, without communication:
    every sharded leaf becomes an empty tensor on the meta device with
    its global shape and dtype; other leaves stay as they are."""
    def grow(part, name, x):
        shape = _joined(part, name, x, mesh.size)
        return x if shape is None else torch.empty(shape, dtype=x.dtype,
                                                   device="meta")
    return _map_embed(state, embed_layer, grow)


def batch_slice(mesh, *arrays):
    """This rank's contiguous slice of each global batch array (None stays
    None)."""
    return tuple(None if a is None else a[rows_of(mesh, a.shape[0])]
                 for a in arrays)
