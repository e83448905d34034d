"""Criteo-Kaggle-shaped batches: the port's twin of bench.py's
`make_criteo_batches`, drawing the same numbers from the same seed.

The 26 real per-field vocabularies (sum 33,762,577), 13 dense features,
ids drawn with a Zipf-like skew (u^4) and scattered over each field's id
space by an odd prime multiplier, as label-encoded data is.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .datasets import CTRArrays

# Criteo Kaggle per-field vocabulary sizes (26 fields, sum = 33,762,577)
CRITEO_COUNTS = [
    1460, 583, 10131227, 2202608, 305, 24, 12517, 633, 3, 93145, 5683,
    8351593, 3194, 27, 14992, 5461306, 10, 5652, 2173, 4, 7046547, 18, 15,
    286181, 105, 142572,
]


def make_criteo_arrays(rows: int) -> CTRArrays:
    """`rows` Criteo-Kaggle-shaped rows (seed 0): the arrays that
    make_criteo_batches cuts into batches."""
    counts = np.asarray(CRITEO_COUNTS, dtype=np.int64)
    rng = np.random.default_rng(0)
    sparse = np.empty((rows, len(counts)), dtype=np.int32)
    for f, n in enumerate(counts):
        u = rng.random(rows) ** 4.0
        ranks = (u * n).astype(np.int64) % n
        sparse[:, f] = (ranks * 1000000007) % n
    dense = np.log1p(rng.gamma(2.0, 2.0, (rows, 13))).astype(np.float32)
    label = rng.integers(0, 2, rows).astype(np.float32)
    return CTRArrays(sparse, dense, label, counts.astype(np.int32))


def make_criteo_batches(batch: int = 2048, n_batches: int = 8,
                        device="cuda"):
    """(train_data, batches): the numpy dataset and `n_batches` batches
    (dense, sparse, label, valid) staged on `device`."""
    dev = resolve_device(device)
    train_data = make_criteo_arrays(batch * n_batches)
    batches = []
    for b in range(n_batches):
        lo = b * batch
        batches.append(tuple(
            torch.from_numpy(a[lo:lo + batch]).to(dev)
            for a in (train_data.dense, train_data.sparse, train_data.label))
            + (batch,))
    return train_data, batches
