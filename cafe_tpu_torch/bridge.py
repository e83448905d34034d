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

AdaEmbed's sample key. The JAX AdaPart keeps a `jax.random` key (two
uint32 words, split every step); the port keeps a fixed int64 seed and
seeds each churn check's sample from (seed, step) (embeddings/ada.py).
The bridge packs the key's words into that seed, hi << 32 | lo, and back:
`PRNGKey(s)` is [0, s], so a fresh JAX state crosses as seed s, the very
value the port's own init draws. The samples still differ between the
packages (torch cannot run jax.random); the tests pin them.

A sharded JAX state is one global state; under a mesh each port rank
holds its slices (parallel/sharding.py). `from_reference_sharded` cuts
rank r's state from the global arrays, and `to_reference_sharded`
gathers the ranks' shards back into the JAX layout. Both packages store
a sharded AdaEmbed's dic and importance cyclic-permuted in the global
state, so they cross as they are; QR's remainder table crosses whole.
The same two functions carry a JAX state sharded under
--shard_exchange auto (the single-device layout; the port cuts only
its row tables) and one of a two-level mesh (the flat mesh's layout).

The graph recommenders' states (models/graphrec/) cross whole through
`to_torch` and `to_reference`: LightGCN.init's part dict and PinSAGE's
{"embed", "conv*", "opt"} (the sketch a dict here and a SketchState
there, Adam's slots a list here and a tuple there).
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


def _is_prng_key(name, value) -> bool:
    return (name == "key" and getattr(value, "dtype", None) == np.uint32
            and tuple(value.shape) == (2,))


def _key_to_seed(key) -> int:
    """A jax.random key's two uint32 words as one int64 seed."""
    hi, lo = (int(x) for x in np.asarray(key, dtype=np.uint32))
    return np.int64(np.uint64((hi << 32) | lo))


def _seed_to_key(seed) -> np.ndarray:
    """_key_to_seed's inverse: the two uint32 words."""
    u = int(np.uint64(np.int64(seed)))
    return np.array([u >> 32, u & 0xFFFFFFFF], dtype=np.uint32)


def to_torch(node, device="cuda"):
    """Any reference subtree (NamedTuples, dicts, lists, array leaves) as
    dicts / lists of tensors on `device` (every leaf copied; an AdaEmbed
    key becomes its int64 seed)."""
    dev = resolve_device(device)
    node = _fields(node)
    if node is None:
        return None
    if isinstance(node, dict):
        return {k: (torch.tensor(_key_to_seed(v), dtype=torch.int64,
                                 device=dev) if _is_prng_key(k, v)
                    else to_torch(v, dev)) for k, v in node.items()}
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
    node = node.detach()
    # a copy (steps update in place): the device's copy to the host is one
    return node.cpu().numpy() if node.device.type != "cpu" \
        else node.numpy().copy()


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
        return {k: (_seed_to_key(state[k].item()) if _is_prng_key(k, v)
                    else to_reference(state[k], v))
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        return type(like)(to_reference(s, v) for s, v in zip(state, like))
    return state.detach().cpu().numpy().astype(np.asarray(like).dtype)
