"""Memory-budget sizing for every compression method (a copy of
cafe_tpu/embeddings/sizing.py, numpy only, kept so the port imports
nothing of `cafe_tpu`).

These formulas ARE the compress-rate contract — they must match the
reference exactly so "cr=0.001" means the same memory everywhere:

* compress threshold     = 2000 * cr; smaller fields stay full
                           (init_embed.py:32, 127-132)
* hash                   real_n = ceil(n * cr)          (hash_embedding_bag.py:14)
* qr                     collisions from the quadratic formula on
                           ntotal*cr = ntotal/coll + coll (init_embed.py:64-69)
* mde                    binary-search alpha so the alpha-power dim
                           assignment hits the target rate (init_embed.py:44-63)
* ada                    hotn = (N*dim*cr - N*2)/dim    (init_embed.py:83)
* cafe                   hotn = totn*cr*(1-hash_rate) * dim*4/(dim*4+48)
                           — 48 bytes/slot of sketch metadata charged against
                           the budget (init_embed.py:110-111); per-field hash
                           table = ceil(cr*hash_rate*n) rows (init_embed.py:179)
* off                    hot pool = tot*cr*(1-hash_rate) over compressed
                           fields; cold_f = ceil(cr*hash_rate*n) - hot_f
                           (load_data.py:127, init_embed.py:188-190)
"""

from __future__ import annotations

import math
from typing import List, Sequence

import numpy as np


def compress_threshold(compress_rate: float) -> float:
    return 2000.0 * compress_rate


def compressed_fields(counts: Sequence[int], compress_rate: float) -> List[int]:
    th = compress_threshold(compress_rate)
    return [i for i, n in enumerate(counts) if n > th]


def hash_sizes(counts: Sequence[int], compress_rate: float) -> List[int]:
    return [int(math.ceil(n * compress_rate)) for n in counts]


def qr_collisions(counts: Sequence[int], compress_rate: float) -> int:
    ntotal = int(np.sum(counts))
    tobe_sqrt = (ntotal * compress_rate) ** 2 - 4 * ntotal
    if tobe_sqrt < 0:
        raise AssertionError(
            f"Q-R trick cannot support compress rate: {compress_rate}")
    return int(math.ceil((ntotal * compress_rate - math.sqrt(tobe_sqrt)) / 2))


def _alpha_power_dims(counts: np.ndarray, alpha: float, d0: int,
                      round_dim: bool) -> np.ndarray:
    """Reference md_solver/alpha_power_rule (md_embedding_bag.py:22-68):
    sort by row count ascending, d_i = d0 * (n_i/n_0)^-alpha, the smallest
    table keeps d0, clamp at >= 1, optionally round to powers of two."""
    order = np.argsort(counts)
    n = counts[order].astype(np.float64)
    lamb = d0 * (n[0] ** alpha)
    d = lamb * (n ** (-alpha))
    d = np.maximum(np.round(d), 1.0)
    d[0] = d0
    if round_dim:
        d = 2.0 ** np.round(np.log2(d))
    out = np.zeros_like(d)
    out[order] = d
    return out.astype(np.int64)


def mde_dims(counts: Sequence[int], compress_rate: float, d0: int,
             round_dims: bool = False) -> List[int]:
    counts = np.asarray(counts, dtype=np.int64)
    lo, hi = 0.0001, 0.5
    while hi - lo > 0.0001:
        mid = (lo + hi) / 2
        d = _alpha_power_dims(counts, mid, d0, round_dims)
        cr = float(np.sum(d * counts)) / (float(np.sum(counts)) * d0)
        if cr > compress_rate:
            lo = mid
        else:
            hi = mid
    return _alpha_power_dims(counts, hi, d0, round_dims).tolist()


def ada_hotn(counts: Sequence[int], compress_rate: float, dim: int) -> int:
    th = compress_threshold(compress_rate)
    n_total = int(sum(n for n in counts if n > th))
    return int((n_total * dim * compress_rate - n_total * 2) / dim)


def cafe_hotn(counts: Sequence[int], compress_rate: float, dim: int,
              hash_rate: float) -> int:
    totn = int(np.sum(counts))
    return int(totn * compress_rate * (1 - hash_rate)
               * (dim * 4 / (dim * 4 + 48)))


def cafe_field_hotn(n: int, compress_rate: float, dim: int,
                    hash_rate: float) -> int:
    """Per-field hotn for cafe_hot_separate_field (init_embed.py:154-155)."""
    return int(n * compress_rate * (1 - hash_rate)
               * (dim * 4 / (dim * 4 + 48)))


def cafe_hash_size(n: int, compress_rate: float, hash_rate: float) -> int:
    return int(math.ceil(compress_rate * hash_rate * n))


def auto_staging_frac(flow_per_step: int, hotn: int) -> float:
    """Flow-proportional CAFE+ staging share (opt-in via
    --cafe_plus_staging_frac -1).

    The staging LRU thrashes when the id flow per hot slot is extreme:
    the round-2/3 sweeps (docs/EXPERIMENTS.md; cr=1e-4: ~31 ids/slot ->
    share 0.5 recovers v1 parity where the reference's 0.1 sits at the
    hash floor; <= ~7 ids/slot: 0.1 is fine). Below the thrash onset
    (15 ids/slot) the share SNAPS to the reference's exact 0.1 — at
    small sketch sizes any re-partition of the bucket layout shifts AUC
    by +-1-2 points non-monotonically (measured: frac 0.09/0.10/0.12
    under drift span 0.603-0.617), so off-regime deviations buy nothing
    and cost noise. Above the onset: linear to 0.5 at 30 ids/slot.
    Beyond-reference knob; OFF unless requested."""
    fps = flow_per_step / max(hotn, 1)
    if fps <= 15.0:
        return 0.1
    return float(min(0.1 + 0.4 * (fps - 15.0) / 15.0, 0.5))
