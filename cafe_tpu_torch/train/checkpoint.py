"""Checkpoint / resume (port of cafe_tpu/train/checkpoint.py).

The JAX package saves with orbax; the port writes one `torch.save` file
of CPU copies of the whole state: dense params, every embedding part's
tables, the sketch (val/cnt/dic/free/free_top/tot), its tick, the
optimizer slots and the step. The file is written to a temporary name and
moved into place with `os.replace`, so a reader sees the old file or the
new one, never half of one. The `.meta.json` sidecar, the rolling
`.ra`/`.rb` slots and the atomic `.latest` symlink flip follow the JAX
package.

Under a mesh (`mesh`, `embed` given) the file holds the GLOBAL state, as
the JAX package's orbax save of a sharded state does: every rank gathers
it (parallel/sharding.unshard_state, a collective), rank 0 alone writes
the file, its sidecar and the `.latest` flip, and every rank then waits
at a barrier on the mesh's group, so no rank reads a slot before it is
whole. A load maps the global file into memory on every rank (one copy
in the host's page cache, not one per rank), checks it against the
global shapes, cuts the rank's slices (shard_state) on the host and moves
only those to the rank's device. The sidecar records the world size the
file was saved at (`mesh_size`, 0: one device without a mesh), the
two-level mesh's `mesh_inner` (0: flat) and the state's `layout`
("explicit", or "auto": --shard_exchange auto, whose global state is the
single-device one). The sketch's per-shard lanes (free_top, tot, ...)
cannot be re-cut for another size, so a load at another world size,
mesh_inner or layout raises, naming both.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict, Tuple

import torch
import torch.distributed as dist

from ..parallel.sharding import global_like, shard_state, unshard_state
from .step import TrainState


def _atomic_json(path: str, data: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


def _to(node, device, copy=False):
    if isinstance(node, torch.Tensor):
        return node.detach().to(device, copy=copy)
    if isinstance(node, dict):
        return {k: _to(v, device, copy) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to(v, device, copy) for v in node]
    return node


def _where(n: int) -> str:
    return f"world size {n}" if n else "one device without a mesh"


def _barrier(mesh) -> None:
    if mesh is not None:
        dist.barrier(group=mesh.group)


def save_tree(path: str, tree: Dict, extra: Dict) -> None:
    """Any state dict (nested dicts / lists of tensors, ints) as one
    torch.save file of CPU copies, moved into place whole, and its
    `.meta.json` sidecar (the graph recommenders' epoch checkpoints)."""
    path = osp.abspath(path)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to(tree, "cpu"), tmp)
    os.replace(tmp, path)
    _atomic_json(path + ".meta.json", extra)


def checkpoint_meta(path: str) -> Dict:
    """The `.meta.json` sidecar of `path` (symlinks resolved), {} if it
    has none."""
    path = os.path.realpath(osp.abspath(path))
    if osp.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            return json.load(f)
    return {}


def load_tree(path: str, like: Dict, device) -> Tuple[Dict, Dict]:
    """save_tree's file restored in the structure of `like` (keys,
    shapes and dtypes must match) onto `device`, and its sidecar."""
    path = os.path.realpath(osp.abspath(path))
    saved = torch.load(path, map_location="cpu", weights_only=True)
    return _restore(saved, like, "", device), checkpoint_meta(path)


def _layout(mesh, embed) -> Dict:
    """The sidecar's record of where the state was saved."""
    if mesh is None:
        return {"mesh_size": 0}
    auto = any(p.auto_mesh is not None for p in embed.parts)
    return {"mesh_size": mesh.size, "mesh_inner": mesh.inner,
            "layout": "auto" if auto else "explicit"}


def _write(path: str, state: TrainState, extra: Dict, mesh, embed) -> None:
    save_tree(path, _to_tree(state), {**extra, **_layout(mesh, embed)})


def _global(state: TrainState, mesh, embed) -> TrainState:
    return state if mesh is None else unshard_state(state, mesh, embed)


def save_checkpoint(path: str, state: TrainState, extra: Dict, mesh=None,
                    embed=None) -> None:
    """Write `state` to `path` (+ `.meta.json`). Under a mesh every rank
    calls it (module docstring); `embed` is the mesh's embedding layer."""
    state = _global(state, mesh, embed)
    if mesh is None or mesh.rank == 0:
        _write(path, state, extra, mesh, embed)
    _barrier(mesh)


def save_rolling(path: str, state: TrainState, extra: Dict, mesh=None,
                 embed=None) -> None:
    """Crash-safe rolling save for preemption recovery: writes alternate
    slots <path>.ra / <path>.rb and atomically flips the <path>.latest
    symlink only AFTER the slot (checkpoint + meta) is fully on disk —
    the previous slot stays valid through the entire save, so a kill at
    any instant leaves a loadable `.latest`. Under a mesh every rank
    calls it; rank 0 writes and flips."""
    path = osp.abspath(path)
    latest = path + ".latest"
    cur = os.path.realpath(latest) if osp.islink(latest) else ""
    slot = path + (".rb" if cur.endswith(".ra") else ".ra")
    state = _global(state, mesh, embed)
    if mesh is None or mesh.rank == 0:
        _write(slot, state, extra, mesh, embed)
        tmp_link = latest + ".lnk"
        if osp.lexists(tmp_link):
            os.remove(tmp_link)
        os.symlink(osp.basename(slot), tmp_link)
        os.replace(tmp_link, latest)
    _barrier(mesh)


def _restore(saved, like, where: str, device):
    """`saved` in the structure of `like` (tensors, or meta tensors that
    stand for their shapes), each tensor moved to `device`; raises on any
    key, length, shape or dtype mismatch."""
    if isinstance(like, dict):
        keys = sorted(saved) if isinstance(saved, dict) \
            else type(saved).__name__
        if keys != sorted(like):
            raise ValueError(f"checkpoint {where}: keys {keys} differ from "
                             f"the state's {sorted(like)}")
        return {k: _restore(saved[k], v, f"{where}/{k}", device)
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint {where}: a list of {len(like)} "
                             f"expected")
        return [_restore(s, v, f"{where}[{i}]", device)
                for i, (s, v) in enumerate(zip(saved, like))]
    if like is None:
        if saved is not None:
            raise ValueError(f"checkpoint {where}: None expected")
        return None
    if not isinstance(saved, torch.Tensor) or saved.shape != like.shape \
            or saved.dtype != like.dtype:
        got = (tuple(saved.shape), saved.dtype) \
            if isinstance(saved, torch.Tensor) else type(saved).__name__
        raise ValueError(f"checkpoint {where}: {got} does not match the "
                         f"state's {(tuple(like.shape), like.dtype)}")
    return saved.to(device)


def load_checkpoint(path: str, state: TrainState, mesh=None, embed=None
                    ) -> Tuple[TrainState, Dict]:
    """Restore into the structure of `state` (keys, shapes and dtypes
    must match; tensors land on `state`'s device). Symlinks (e.g. a
    rolling `.latest`) are resolved first so the meta sidecar is found
    next to the real slot. Under a mesh (`mesh`, `embed`: every rank
    calls it) the file is the global state of a mesh of the same size
    and each rank keeps its slices. Without a mesh a mesh run's file
    loads into a state of its layout (`enable_sharded_layout` of the
    CAFE and AdaEmbed parts: serving only). Returns the state and the sidecar's `extra`."""
    path = os.path.realpath(osp.abspath(path))
    meta = checkpoint_meta(path)
    # files without the keys were saved flat in the explicit layout
    where = {"mesh_size": 0, "mesh_inner": 0, "layout": "explicit"}
    where.update({k: meta.pop(k) for k in list(where) if k in meta})
    got = int(where["mesh_size"])
    want = 0 if mesh is None else mesh.size
    mismatch = (f"checkpoint {path} was saved at {_where(got)} and is "
                f"loaded at {_where(want)}")
    if mesh is not None and got != want:
        raise ValueError(f"{mismatch}: the sketch's per-shard lanes cannot "
                         f"be re-cut for another world size")
    if mesh is not None:
        here = _layout(mesh, embed)
        for k in ("mesh_inner", "layout"):
            if where[k] != here[k]:
                raise ValueError(f"checkpoint {path} was saved at {k} "
                                 f"{where[k]!r} and is loaded at {k} "
                                 f"{here[k]!r}")
    dev = state.step.device
    if mesh is None:
        saved = torch.load(path, map_location="cpu", weights_only=True)
        try:
            st = TrainState(**_restore(saved, _to_tree(state), "", dev))
        except ValueError as e:
            if got:
                raise ValueError(f"{mismatch}: serve it in its layout "
                                 f"(--inference_only): {e}") from e
            raise
        return st, meta
    # mapped, not read: the ranks of a host share one copy of the file
    saved = torch.load(path, map_location="cpu", weights_only=True,
                       mmap=True)
    like = global_like(state, mesh, embed)
    st = TrainState(**_restore(saved, _to_tree(like), "", "cpu"))
    st = shard_state(st, mesh, embed)
    return TrainState(**_to(_to_tree(st), dev, copy=True)), meta


def _to_tree(state: TrainState) -> Dict[str, Any]:
    return {
        "params": state.params,
        "embed": state.embed,
        "embed_dense": state.embed_dense,
        "opt": state.opt,
        "step": state.step,
    }
