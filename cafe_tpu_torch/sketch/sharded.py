"""Shard-local HotSketch layout for the explicit exchange (port of
cafe_tpu/sketch/sharded.py).

Ids route to shards by a multiplicative hash `shard_of(id) % n`
(decorrelated from the in-shard bucket hash). Each shard owns a
contiguous slice of every sketch array and runs the unchanged v1 insert
and query (hotsketch.py) on its slice with a local config of
`S_l = padded_hotn / n` buckets: per-shard Space-Saving with its own free
stack and decay clock. A shard's local hot slot `l` maps to the global
hot row `shard * S_l + l`; local slot 0 stays the cold sentinel, so the
global capacity is n*(S_l - 1) slots, all inside the padded hot region
[0, padded_hotn) of the unified table.

State vs the single-device sketch: `free_top` and `tot` are length-n
lanes (one scalar per shard), so that every leaf row-shards evenly. The
CAFE+ layout (the `*_plus` functions) does the same with the two-tier
sketch: each shard has its own tiers, threshold, decay clock and step.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

from ..device import resolve_device
from .hotsketch import HotSketchConfig, SketchState, _bucket_of, mul_u32

_SHARD_MULT = 0x9E3779B1  # golden-ratio hash, != bucket hash mult


def shard_of(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Owning shard of each id: (uint32(id) * 0x9E3779B1 mod 2^32) % n,
    wrapping exactly as the JAX package's uint32 product."""
    return (mul_u32(ids, _SHARD_MULT) % n).to(torch.int32)


def local_config(cfg: HotSketchConfig, n: int) -> Tuple[HotSketchConfig, int]:
    """(per-shard config, S_l). Total padded rows must divide by n."""
    from ..embeddings.base import round_up
    total = round_up(cfg.buckets)
    if total % n:
        raise ValueError(f"padded sketch rows {total} not divisible by "
                         f"mesh size {n}")
    s_l = total // n
    return cfg._replace(buckets=s_l), s_l


def init_sharded_sketch(cfg: HotSketchConfig, n: int,
                        device="cuda") -> SketchState:
    """Global state whose per-shard slices are independent local sketches
    (shard s's free stack holds its LOCAL slots 1..S_l-1; free_top / tot
    are [n]). On `device` (default the card)."""
    device = resolve_device(device)
    _, s_l = local_config(cfg, n)
    c = cfg.cells
    free = np.zeros((n, s_l), dtype=np.int32)
    free[:, : s_l - 1] = np.arange(1, s_l, dtype=np.int32)[None, :]
    z = dict(device=device)
    return {
        "val": torch.zeros((n * s_l, c), dtype=torch.int32, **z),
        "cnt": torch.zeros((n * s_l, c), dtype=torch.float32, **z),
        "dic": torch.zeros((n * s_l, c), dtype=torch.int32, **z),
        "free": torch.from_numpy(free.reshape(-1)).to(device),
        "free_top": torch.full((n,), s_l - 1, dtype=torch.int32, **z),
        "tot": torch.zeros((n,), dtype=torch.float32, **z),
    }


def local_config_plus(cfg, n: int):
    """(per-shard CafePlusConfig, S_l). The padded lim must divide by n."""
    from ..embeddings.base import round_up
    total = round_up(cfg.lim)
    if total % n:
        raise ValueError(f"padded lim {total} not divisible by {n}")
    s_l = total // n
    return cfg._replace(lim=s_l), s_l


def init_sharded_sketch_plus(cfg, n: int, device="cuda") -> SketchState:
    """Sharded CAFE+ state: each shard's slice is an independent two-tier
    sketch with its own threshold, decay clock, step and free stack (the
    per-shard scalar lanes are [n]). Local arrays are exact-size (n1, n2
    rows a shard, no ROW_ALIGN padding): the n-stacked arrays divide
    evenly by construction. On `device` (default the card)."""
    device = resolve_device(device)
    lcfg, s_l = local_config_plus(cfg, n)
    c = cfg.cells
    free = np.zeros((n, s_l), dtype=np.int32)
    free[:, : s_l - 1] = np.arange(1, s_l, dtype=np.int32)[None, :]
    z = dict(device=device)

    def cells(rows, dtype):
        return torch.zeros((n * rows, c), dtype=dtype, **z)

    return {
        "val1": cells(lcfg.n1, torch.int32),
        "cnt1": cells(lcfg.n1, torch.float32),
        "dic1": cells(lcfg.n1, torch.int32),
        "val2": cells(lcfg.n2, torch.int32),
        "cnt2": cells(lcfg.n2, torch.float32),
        "dic2": cells(lcfg.n2, torch.int32),
        "ts2": cells(lcfg.n2, torch.int32),
        "free": torch.from_numpy(free.reshape(-1)).to(device),
        "free_top": torch.full((n,), s_l - 1, dtype=torch.int32, **z),
        "threshold": torch.full((n,), cfg.threshold, dtype=torch.float32,
                                **z),
        "real_n": torch.zeros((n,), dtype=torch.int32, **z),
        "decay_acc": torch.ones((n,), dtype=torch.float32, **z),
        "step": torch.zeros((n,), dtype=torch.int32, **z),
    }


def query_sharded_plus(cfg, n: int, st: SketchState,
                       ids: torch.Tensor) -> torch.Tensor:
    """One-process query against the whole sharded CAFE+ layout; returns
    the global -slot convention (as query_sharded)."""
    from .hotsketch_plus import _h1, _h2, tier_slot
    lcfg, s_l = local_config_plus(cfg, n)
    shard = shard_of(ids, n)
    slot_local = torch.maximum(
        tier_slot(st["val1"], st["cnt1"], st["dic1"],
                  _h1(lcfg, ids) + shard * lcfg.n1, ids),
        tier_slot(st["val2"], st["cnt2"], st["dic2"],
                  _h2(lcfg, ids) + shard * lcfg.n2, ids))
    slot = torch.where(slot_local > 0, slot_local + shard * s_l, 0)
    return torch.where(slot > 0, -slot, ids)


def shard_local_view(state: SketchState) -> SketchState:
    """A rank's slice as the kernels expect it: the per-shard scalar lanes
    ([1] on a rank) become scalars; cell and free arrays pass through."""
    return {k: (v[0] if v.dim() == 1 and v.shape[0] == 1 else v)
            for k, v in state.items()}


def shard_global_view(state: SketchState) -> SketchState:
    """Inverse of shard_local_view."""
    return {k: (v[None] if v.dim() == 0 else v) for k, v in state.items()}


def query_sharded(cfg: HotSketchConfig, n: int, st: SketchState,
                  ids: torch.Tensor) -> torch.Tensor:
    """One-process query against the whole SHARDED layout (serving a
    sharded-trained state on one device, parity tests): route each id to
    its shard, probe that shard's buckets, return the GLOBAL slot
    convention (-slot if hot else id)."""
    lcfg, s_l = local_config(cfg, n)
    shard = shard_of(ids, n)
    h = (_bucket_of(lcfg, ids) + shard * s_l).long()   # global bucket row
    bv, bc, bd = st["val"][h], st["cnt"][h], st["dic"][h]
    m = (bc > 0) & (bv == ids[:, None]) & (bd != 0)
    slot_local = torch.where(m, bd, 0).amax(dim=1)
    slot = torch.where(slot_local > 0, slot_local + shard * s_l, 0)
    return torch.where(slot > 0, -slot, ids)
