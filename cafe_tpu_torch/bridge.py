"""State bridge between the JAX package's TrainState and the port's.

The JAX package draws its dense params from `jax.random`, which torch
cannot reproduce; runs that must match it (the parity tests) build the
state there and carry it over here. The bridge never imports jax: it
walks the reference state's structure (NamedTuples, dicts, lists, None)
and converts every array leaf through numpy.

The port's state mirrors the reference one-to-one: params
{"bot": [{"w", "b"}, ...], "top": [...]}, each embedding part's dict
("table", the sketch's fields as a dict under "sketch", "tick"),
embed_dense, opt and step.

A sharded JAX state is one global state; under a mesh each port rank
holds its slices (parallel/sharding.py). `from_reference_sharded` cuts
rank r's state from the global arrays, and `to_reference_sharded`
gathers the ranks' shards back into the JAX layout.
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
from .parallel.sharding import shard_state, unshard_state
from .train.step import TrainState


def _fields(node):
    """A NamedTuple's fields as a dict; other nodes unchanged."""
    return node._asdict() if hasattr(node, "_asdict") else node


def to_torch(node, device="cuda"):
    """Any reference subtree (NamedTuples, dicts, lists, array leaves) as
    dicts / lists of tensors on `device` (every leaf copied)."""
    dev = resolve_device(device)
    node = _fields(node)
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: to_torch(v, dev) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_torch(v, dev) for v in node]
    return torch.from_numpy(np.array(node)).to(dev)


def from_reference(ref_state, device="cuda") -> TrainState:
    """The port's TrainState from a JAX TrainState, or from a dict of its
    fields with numpy leaves (copies every leaf)."""
    fields = _fields(ref_state)
    return TrainState(*(to_torch(fields[f], device)
                        for f in TrainState._fields))


def from_reference_sharded(ref_state, mesh, embed_layer) -> TrainState:
    """Rank `mesh.rank`'s port state (on the mesh's device) from a JAX
    TrainState of GLOBAL arrays, or a dict of its fields as numpy (a
    sharded JAX state fetched to the host is one)."""
    return shard_state(from_reference(ref_state, mesh.device), mesh,
                       embed_layer)


def to_reference_sharded(state, mesh, embed_layer, like):
    """The ranks' shards gathered into the structure of `like` (a JAX
    state or subtree), as numpy. Collective: every rank calls it."""
    return to_reference(unshard_state(state, mesh, embed_layer), like)


def to_numpy(node):
    """Nested dicts / lists of numpy arrays from any port state (a
    TrainState becomes a dict of its fields)."""
    node = _fields(node)
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: to_numpy(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [to_numpy(v) for v in node]
    return np.array(node.detach().cpu())   # a copy: steps update in place


def to_reference(state, like):
    """`state` (the port's) in the structure of `like` (a JAX state or
    any subtree of one): NamedTuples rebuilt with their own types, numpy
    leaves cast to `like`'s dtypes."""
    state = _fields(state)
    if like is None:
        return None
    if hasattr(like, "_asdict"):
        return type(like)(**{k: to_reference(state[k], v)
                             for k, v in like._asdict().items()})
    if isinstance(like, dict):
        return {k: to_reference(state[k], v) for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(to_reference(s, v) for s, v in zip(state, like))
    return state.detach().cpu().numpy().astype(np.asarray(like).dtype)
