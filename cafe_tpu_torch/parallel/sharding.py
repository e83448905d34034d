"""Which state leaves are row-sharded, and the rank's slices of the state
and the batch (port of cafe_tpu/parallel/sharding.py).

The JAX package annotates the global state with NamedShardings and lets
XLA place it; here each rank holds its slices outright. The leaf rules
are the JAX package's `state_shardings` rules:

  * every embedding table / optimizer slot [rows, dim] of a part that
    runs the explicit exchange -> this rank's rows;
  * sketch bucket arrays val/cnt/dic [n*S_l, C] and the free stacks
    [n*S_l] -> this rank's buckets;
  * the per-shard scalar lanes free_top / tot ([n]) -> this rank's lane
    ([1]; sketch/sharded.shard_local_view squeezes it);
  * everything else (dense towers, optimizer state of the towers, tick,
    step, every leaf of a part that stays replicated) -> a full copy.

A part that does not run the exchange (Part.mesh is None) stays
replicated as a whole: the JAX package leaves such a part to XLA's
partitioner, which gives the same values as a replicated table updated
with the global batch (embeddings/base.EmbeddingLayer does that).
"""

from __future__ import annotations

from typing import Any, Callable

from .exchange import all_gather

_ROW_TABLES = {"table", "hash", "high", "q", "r", "hot", "cold", "weight"}
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


def _map_named(fn: Callable, node, name: str = ""):
    if isinstance(node, dict):
        return {k: _map_named(fn, v, k) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_map_named(fn, v, name) for v in node]
    if node is None:
        return None
    return fn(name, node)


def _map_embed(state, embed_layer, fn):
    """state with fn(name, leaf) applied to the leaves of every part that
    runs the exchange; other fields and parts unchanged."""
    embed = {key: (_map_named(fn, sub) if p.mesh is not None else sub)
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
    def cut(name, x):
        if leaf_is_sharded(name, tuple(x.shape), mesh.size):
            return x[rows_of(mesh, x.shape[0])].clone()
        return x
    return _map_embed(state, embed_layer, cut)


def unshard_state(state: Any, mesh, embed_layer) -> Any:
    """The global TrainState from every rank's shards (collective: every
    rank calls it and gets the whole state). A sharded leaf is told apart
    by its global shape (local rows x mesh size), which is exact for the
    leaves the ported parts hold."""
    def join(name, x):
        if x.dim() and leaf_is_sharded(
                name, (x.shape[0] * mesh.size,) + tuple(x.shape[1:]),
                mesh.size):
            return all_gather(x, mesh)
        return x
    return _map_embed(state, embed_layer, join)


def batch_slice(mesh, *arrays):
    """This rank's contiguous slice of each global batch array (None stays
    None)."""
    return tuple(None if a is None else a[rows_of(mesh, a.shape[0])]
                 for a in arrays)
