"""In-memory CTR arrays and fixed-shape batches (the parts of
cafe_tpu/data/datasets.py on the ported path: `CTRArrays` and
`batch_iterator`). The memmap loaders, their index splits, id modulo and
stream resume are not ported yet.

Batch shapes are static: the final partial batch is padded (rows repeated
from the batch head) and carries its true `valid` count.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional, Tuple

import numpy as np


@dataclasses.dataclass
class CTRArrays:
    """One split of a CTR dataset as arrays (see the JAX package)."""

    sparse: np.ndarray  # int32 [N, F]
    dense: Optional[np.ndarray]  # float32 [N, D] or None
    label: np.ndarray  # int32 [N]
    counts: np.ndarray  # int32 [F] per-field vocabulary sizes

    @property
    def num_sparse(self) -> int:
        return self.sparse.shape[1]

    @property
    def num_dense(self) -> int:
        return 0 if self.dense is None else self.dense.shape[1]

    def __len__(self) -> int:
        return len(self.label)


Batch = Tuple[Optional[np.ndarray], np.ndarray, np.ndarray, int]
# (dense [B, D] f32 | None, sparse [B, F] i32, label [B] f32, valid)


def batch_iterator(data: CTRArrays, batch_size: int, *,
                   drop_last: bool = False) -> Iterator[Batch]:
    """Yield fixed-shape batches; the final partial batch is padded (rows
    repeated from the batch head) and reports its true `valid` count."""
    n = len(data)
    nb = n // batch_size if drop_last else (n + batch_size - 1) // batch_size
    for b in range(nb):
        lo = b * batch_size
        hi = min(lo + batch_size, n)
        valid = hi - lo
        sparse = np.ascontiguousarray(data.sparse[lo:hi], dtype=np.int32)
        label = np.asarray(data.label[lo:hi], dtype=np.float32)
        dense = None if data.dense is None else \
            np.ascontiguousarray(data.dense[lo:hi], dtype=np.float32)
        if valid < batch_size:
            pad = batch_size - valid
            sparse = np.concatenate([sparse, sparse[:1].repeat(pad, 0)])
            label = np.concatenate([label, label[:1].repeat(pad, 0)])
            if dense is not None:
                dense = np.concatenate([dense, dense[:1].repeat(pad, 0)])
        yield dense, sparse, label, valid
