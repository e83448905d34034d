"""The sketch's warm state, made from the seed: what a CAFE sketch holds
after long training, handed alike to the program and to the reference,
so that the checked calls start from full buckets and a nearly full hot
set, and a decay falls inside the third call (the CUDA graph's first
replay).

- Rows: one decay period of the cell's own stream, drawn from the seed on
  a stream of their own: S * k * 10 of score mass, a row carrying
  lanes_per_row lanes of mean score 1.
- Cells: each bucket's C most frequent ids of those rows, most frequent
  first (ties by id); a cell's count is its id's lanes times one scale.
- Hot set: the scale puts the H-th largest count at the threshold k, H =
  `warm_hot_share` of the S - 1 slots. The cells at or above k, the
  largest first (ties by cell), take slots (at most H) from a
  permutation of 1 .. S-1 drawn from the seed; the rest of the
  permutation is the free stack. So some hot cells sit at k and lose
  their slot at the decay, and cells at k without a slot are promoted on
  their next touch.
- Score mass since the last decay: such that the decay falls on the
  middle insert of the third checked call.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from .counts.layout import CELLS, round_up
from .reference.sketch import HASH_MULT

CHECKED_CALLS = 3


def _bucket(ids: torch.Tensor, s: int) -> torch.Tensor:
    """(uint32(id) * HASH_MULT mod 2^32) mod S of int64 ids below 2^31,
    in int64 arithmetic that does not overflow."""
    x = ids & 0xFFFFFFFF
    lo = x * (HASH_MULT & 0xFFFF)
    hi = ((x * (HASH_MULT >> 16)) & 0xFFFF) << 16
    return ((lo + hi) & 0xFFFFFFFF) % s


def decay_insert(traffic: Dict, calls: int = CHECKED_CALLS) -> int:
    """The index of the insert, counted from the first checked step, on
    which the decay falls: the middle insert of the last checked call."""
    k, iv = traffic["steps_per_dispatch"], traffic["cafe_insert_interval"]
    ticks = [t for t in range(calls * k) if t % iv == 0]
    last = [j for j, t in enumerate(ticks) if t >= (calls - 1) * k]
    return last[(len(last) - 1) // 2]


def warm_sketch(lay: Dict, traffic: Dict, gen, seed: int, stream: int,
                device) -> Dict[str, np.ndarray]:
    """{val, cnt, dic: [S, C]; free: [round_up(S)]; free_top; tot} of the
    warm sketch (numpy, ids as int64)."""
    c = lay["cafe"]
    s, fc = c["hotn"], c["lanes_per_row"]
    k = np.float32(c["threshold"])
    decay_at = np.float32(s) * k * np.float32(10.0)
    rows = int(math.ceil(float(decay_at) / fc))
    dev = torch.device(device)
    pool = gen.make_pool(traffic, lay, rows, seed, stream, dev)
    big = torch.tensor(lay["big"], device=dev)
    goff = torch.tensor(c["goff"], dtype=torch.int64, device=dev)
    oids = (pool.sparse[:, big].long() + goff[None, :]).reshape(-1)
    del pool
    ids, n = torch.unique(oids, return_counts=True)
    del oids
    b = _bucket(ids, s)
    # bucket ascending, then lanes descending, then id ascending (unique
    # sorts the ids; both sorts below are stable)
    o = torch.sort(-n, stable=True).indices
    o = o[torch.sort(b[o], stable=True).indices]
    ids, n, b = ids[o], n[o], b[o]
    rank = torch.arange(b.numel(), device=dev) - torch.searchsorted(b, b)
    keep = rank < CELLS
    ids, n, b, rank = (t[keep].cpu().numpy() for t in (ids, n, b, rank))

    val = np.zeros((s, CELLS), dtype=np.int64)
    lanes = np.zeros((s, CELLS), dtype=np.int64)
    val[b, rank] = ids
    lanes[b, rank] = n
    slots = s - 1
    h = max(int(traffic["warm_hot_share"] * slots), 1)
    flat = lanes.reshape(-1)
    order = np.lexsort((np.arange(flat.size), -flat))
    ref = int(flat[order[min(h, int((flat > 0).sum())) - 1]])
    cnt = (lanes.astype(np.float64) * (float(k) / ref)).astype(np.float32)
    hot = order[:h][cnt.reshape(-1)[order[:h]] >= k]

    ss = np.random.SeedSequence([int(seed) & (2**64 - 1), stream])
    perm = np.random.default_rng(ss).permutation(np.arange(1, s))
    dic = np.zeros(s * CELLS, dtype=np.int64)
    dic[hot] = perm[:hot.size]
    free = np.zeros(round_up(s), dtype=np.int64)
    rest = perm[hot.size:]
    free[:rest.size] = rest

    m = np.float32(traffic["batch"] * traffic["cafe_insert_interval"] * fc)
    tot = np.float32(float(decay_at) - (decay_insert(traffic) - 0.5)
                     * float(m))
    if not tot >= 0:
        raise ValueError("warm_sketch: the checked calls are too long for "
                         "one decay period")
    return {"val": val, "cnt": cnt, "dic": dic.reshape(s, CELLS),
            "free": free, "free_top": int(rest.size), "tot": tot}


def occupancy(val, cnt, dic, free_top: int, tot: float) -> str:
    """A line on how full a sketch is (its first S rows)."""
    s, cells = cnt.shape
    used = int((cnt > 0).sum())
    full = int(((cnt > 0).sum(axis=1) == cells).sum())
    hot = int((dic != 0).sum())
    return (f"{used} of {s * cells} cells occupied, {full} of {s} buckets "
            f"full, {hot} hot of {s - 1} slots, free_top {free_top}, "
            f"score mass since the last decay {float(tot)!r}")
