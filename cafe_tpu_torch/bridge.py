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
"""

from __future__ import annotations

import numpy as np
import torch

from .device import resolve_device
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
    """The port's TrainState from a JAX TrainState (copies every leaf)."""
    return TrainState(*(to_torch(getattr(ref_state, f), device)
                        for f in TrainState._fields))


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
