"""Checkpoint / resume (port of cafe_tpu/train/checkpoint.py).

The JAX package saves with orbax; the port writes one `torch.save` file
of CPU copies of the whole state: dense params, every embedding part's
tables, the sketch (val/cnt/dic/free/free_top/tot), its tick, the
optimizer slots and the step. The file is written to a temporary name and
moved into place with `os.replace`, so a reader sees the old file or the
new one, never half of one. The `.meta.json` sidecar, the rolling
`.ra`/`.rb` slots and the atomic `.latest` symlink flip follow the JAX
package.
"""

from __future__ import annotations

import json
import os
import os.path as osp
from typing import Any, Dict, Tuple

import torch

from .step import TrainState


def _atomic_json(path: str, data: Dict) -> None:
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(data, f)
    os.replace(tmp, path)


def _to_cpu(node):
    if isinstance(node, torch.Tensor):
        return node.detach().cpu()
    if isinstance(node, dict):
        return {k: _to_cpu(v) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return [_to_cpu(v) for v in node]
    return node


def save_checkpoint(path: str, state: TrainState, extra: Dict) -> None:
    path = osp.abspath(path)
    os.makedirs(osp.dirname(path) or ".", exist_ok=True)
    tmp = path + ".tmp"
    torch.save(_to_cpu(_to_tree(state)), tmp)
    os.replace(tmp, path)
    _atomic_json(path + ".meta.json", extra)


def save_rolling(path: str, state: TrainState, extra: Dict) -> None:
    """Crash-safe rolling save for preemption recovery: writes alternate
    slots <path>.ra / <path>.rb and atomically flips the <path>.latest
    symlink only AFTER the slot (checkpoint + meta) is fully on disk —
    the previous slot stays valid through the entire save, so a kill at
    any instant leaves a loadable `.latest`."""
    path = osp.abspath(path)
    latest = path + ".latest"
    cur = os.path.realpath(latest) if osp.islink(latest) else ""
    slot = path + (".rb" if cur.endswith(".ra") else ".ra")
    save_checkpoint(slot, state, extra)
    tmp_link = latest + ".lnk"
    if osp.lexists(tmp_link):
        os.remove(tmp_link)
    os.symlink(osp.basename(slot), tmp_link)
    os.replace(tmp_link, latest)


def _restore(saved, like, where: str):
    """`saved` in the structure of `like`, each tensor on the device of
    its counterpart in `like`; raises on any key, length, shape or dtype
    mismatch."""
    if isinstance(like, dict):
        keys = sorted(saved) if isinstance(saved, dict) \
            else type(saved).__name__
        if keys != sorted(like):
            raise ValueError(f"checkpoint {where}: keys {keys} differ from "
                             f"the state's {sorted(like)}")
        return {k: _restore(saved[k], v, f"{where}/{k}")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        if not isinstance(saved, (list, tuple)) or len(saved) != len(like):
            raise ValueError(f"checkpoint {where}: a list of {len(like)} "
                             f"expected")
        return [_restore(s, v, f"{where}[{i}]")
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
    return saved.to(like.device)


def load_checkpoint(path: str, state: TrainState
                    ) -> Tuple[TrainState, Dict]:
    """Restore into the structure of `state` (keys, shapes and dtypes
    must match; tensors land on the devices of `state`'s). Symlinks (e.g.
    a rolling `.latest`) are resolved first so the meta sidecar is found
    next to the real slot."""
    path = os.path.realpath(osp.abspath(path))
    saved = torch.load(path, map_location="cpu", weights_only=True)
    st = _restore(saved, _to_tree(state), "")
    extra: Dict = {}
    if osp.exists(path + ".meta.json"):
        with open(path + ".meta.json") as f:
            extra = json.load(f)
    return TrainState(st["params"], st["embed"], st["embed_dense"],
                      st["opt"], st["step"]), extra


def _to_tree(state: TrainState) -> Dict[str, Any]:
    return {
        "params": state.params,
        "embed": state.embed,
        "embed_dense": state.embed_dense,
        "opt": state.opt,
        "step": state.step,
    }
