"""The initial weights, made on the device from the seed, and the norm of
a leaf's change from them.

Every leaf is cut into units (a tower matrix or bias; a field's slice of
a table, in chunks of at most CHUNK_ELEMS values), each drawn by its own
generator seeded by (seed, leaf, unit), so any unit can be drawn again
later without the others: the change of a 9 GB table from its initial
values is measured unit by unit through a fixed scratch buffer, with no
copy of the table. The distributions are the port's own initialisers':
tower weights N(0, sqrt(2 / (fan_in + fan_out))), biases N(0,
sqrt(1 / fan_out)), hot rows U(+-sqrt(1 / max vocabulary)), a field's
hash or full rows U(+-sqrt(1 / its vocabulary)), padding rows 0.
"""

from __future__ import annotations

import math
from typing import Dict, Iterator, List, Tuple

import numpy as np
import torch

CHUNK_ELEMS = 1 << 24


def unit_seed(seed: int, leaf: int, unit: int) -> int:
    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), 1 << 20 | leaf,
                                 unit])
    return int(ss.generate_state(1, np.uint64)[0])


def leaves(lay: Dict) -> List[Tuple[str, tuple]]:
    """[(leaf name, shape)] in a fixed order: the towers, then the
    tables."""
    out = []
    for tower in ("bot", "top"):
        ln = lay["ln_" + tower]
        for i in range(len(ln) - 1):
            out.append((f"{tower}.{i}.w", (ln[i], ln[i + 1])))
            out.append((f"{tower}.{i}.b", (ln[i + 1],)))
    if lay["full"] is not None:
        out.append(("full.table", (lay["full"]["rows"], lay["dim"])))
    out.append(("cafe.table", (lay["cafe"]["rows"], lay["dim"])))
    return out


def _segments(lay: Dict, name: str, shape: tuple):
    """[(row0, row1, kind, a)]: rows [row0, row1) drawn by `kind`
    ('normal' std a, 'uniform' +-a, 'zero')."""
    if name.endswith(".w"):
        n, m = shape
        return [(0, n, "normal", math.sqrt(2.0 / (m + n)))]
    if name.endswith(".b"):
        return [(0, shape[0], "normal", math.sqrt(1.0 / shape[0]))]
    segs = []
    if name == "full.table":
        f = lay["full"]
        for off, n, s in zip(f["offsets"], f["real_ns"], f["scales"]):
            segs.append((off, off + n, "uniform", s))
        end = f["offsets"][-1] + f["real_ns"][-1]
        segs.append((end, f["rows"], "zero", 0.0))
        return segs
    c = lay["cafe"]
    segs.append((0, c["hotn"], "uniform", math.sqrt(1.0 / c["max_count"])))
    segs.append((c["hotn"], c["hash_base"], "zero", 0.0))
    for off, hs, n in zip(c["hash_off"], c["hash_sizes"], c["counts"]):
        lo = c["hash_base"] + off
        segs.append((lo, lo + hs, "uniform", math.sqrt(1.0 / n)))
    segs.append((c["hash_base"] + c["hash_rows"], c["rows"], "zero", 0.0))
    return segs


def units(lay: Dict, leaf: int, name: str, shape: tuple
          ) -> Iterator[Tuple[int, int, str, float, int]]:
    """(row0, row1, kind, a, unit index) of a leaf, each unit at most
    CHUNK_ELEMS values."""
    width = int(np.prod(shape[1:])) if len(shape) > 1 else 1
    per = max(CHUNK_ELEMS // width, 1)
    u = 0
    for r0, r1, kind, a in _segments(lay, name, shape):
        for lo in range(r0, r1, per):
            yield lo, min(lo + per, r1), kind, a, u
            u += 1


def _draw(view: torch.Tensor, kind: str, a: float, seed: int) -> None:
    if kind == "zero":
        view.zero_()
        return
    g = torch.Generator(device=view.device)
    g.manual_seed(seed)
    if kind == "normal":
        view.normal_(0.0, a, generator=g)
    else:
        view.uniform_(-a, a, generator=g)


def make(lay: Dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """{leaf name: f32 tensor on `device`} of the initial weights."""
    out = {}
    for leaf, (name, shape) in enumerate(leaves(lay)):
        t = torch.empty(shape, dtype=torch.float32, device=device)
        for r0, r1, kind, a, u in units(lay, leaf, name, shape):
            _draw(t[r0:r1], kind, a, unit_seed(seed, leaf, u))
        out[name] = t
    return out


@torch.no_grad()
def change_norm(lay: Dict, seed: int, name: str, t: torch.Tensor,
                scratch: torch.Tensor) -> float:
    """||t - its initial value|| for the leaf `name`, drawn again unit by
    unit into `scratch` (f32, at least CHUNK_ELEMS values on t's
    device)."""
    names = [n for n, _ in leaves(lay)]
    leaf = names.index(name)
    total = 0.0
    for r0, r1, kind, a, u in units(lay, leaf, name, tuple(t.shape)):
        region = t[r0:r1]
        init = scratch[:region.numel()].view(region.shape)
        _draw(init, kind, a, unit_seed(seed, leaf, u))
        init.sub_(region)
        # an f32 reduction: a float64 cast would copy the unit
        total += float(torch.linalg.vector_norm(init)) ** 2
    return math.sqrt(total)
