"""CU (conservative-update count-min) frequency sketch (port of
cafe_tpu/sketch/cu_sketch.py): k hash rows of n counters, multiplicative
hashing; a frequency-estimation tool, not on the training path.

Every row's counter rises to max(counter, min estimate + value); queries
take the min over rows. Duplicate ids of a batch are combined first, so
the update is one scatter-max, which gives the same counters in any
order (on the card too).

State is a dict {"cnt": f32 [k, width]}.
"""

from __future__ import annotations

from typing import Dict, NamedTuple

import torch

from ..device import resolve_device
from .hotsketch import mul_u32

_PRIMES = (2654435761, 2246822519, 3266489917, 668265263,
           374761393, 2853776293, 1540483477, 2447445653)


class CUSketchConfig(NamedTuple):
    rows: int      # k hash rows
    width: int     # n counters per row


def init_cu(cfg: CUSketchConfig, device="cuda") -> Dict[str, torch.Tensor]:
    """A zeroed sketch on `device` (default the card)."""
    if cfg.rows > len(_PRIMES):
        raise ValueError(f"at most {len(_PRIMES)} hash rows")
    return {"cnt": torch.zeros((cfg.rows, cfg.width), dtype=torch.float32,
                               device=resolve_device(device))}


def _flat_positions(cfg: CUSketchConfig, ids: torch.Tensor) -> torch.Tensor:
    """[B, k] flat counter indices row * width + (uint32(id) * prime_row
    mod 2^32) % width."""
    pos = torch.stack([mul_u32(ids, p) % cfg.width
                       for p in _PRIMES[: cfg.rows]], dim=1)
    return pos + torch.arange(cfg.rows, device=ids.device) * cfg.width


def cu_query(cfg: CUSketchConfig, st, ids: torch.Tensor) -> torch.Tensor:
    """The min-over-rows estimate of each id."""
    return st["cnt"].reshape(-1)[_flat_positions(cfg, ids)].amin(dim=1)


def cu_insert(cfg: CUSketchConfig, st, ids: torch.Tensor,
              vals: torch.Tensor = None):
    """Batched conservative-update insert (values default to 1)."""
    if vals is None:
        vals = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    order = torch.sort(ids, stable=True).indices
    sid, sval = ids[order], vals[order]
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=ids.device),
                      sid[1:] != sid[:-1]])
    seg = torch.cumsum(head, 0) - 1
    tot = torch.zeros_like(sval).index_add_(0, seg, sval)[seg]
    use = torch.where(head, tot, 0.0)
    flat = _flat_positions(cfg, sid)
    cnt = st["cnt"].reshape(-1)
    target = cnt[flat].amin(dim=1, keepdim=True) + use[:, None]
    cnt = cnt.clone().scatter_reduce_(
        0, flat.reshape(-1), target.expand(-1, cfg.rows).reshape(-1), "amax")
    return {"cnt": cnt.view(cfg.rows, cfg.width)}
