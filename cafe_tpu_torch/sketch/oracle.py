"""Sequential numpy oracle for HotSketch semantics.

A from-scratch Python rendering of the behavior in
ArtifactEvaluation/embeddings/sketch.cpp:27-150 (single-tier CAFE sketch):
per-id sequential insert, FIFO free list, in-bucket cells kept sorted by
score, Space-Saving eviction of the min cell, global multiplicative decay.

Used only in tests: the batched device sketch (hotsketch.py) must match this
oracle *statistically* (recall of the ideal top-k, promotion counts), not
bit-exactly — the reference's own microbenchmark applies the same standard
(sketch_expr/sketchtest.py:86-129).
"""

from __future__ import annotations

from collections import deque

import numpy as np


class OracleSketch:
    def __init__(self, buckets: int, threshold: float, decay: float = 0.99,
                 cells: int = 4, hash_mult: int = 2654435761):
        self.s = buckets
        self.k = threshold
        self.decay_rate = decay
        self.c = cells
        self.hash_mult = hash_mult
        self.val = np.zeros((buckets, cells), dtype=np.int64)
        self.cnt = np.zeros((buckets, cells), dtype=np.float64)
        self.dic = np.zeros((buckets, cells), dtype=np.int64)
        self.free = deque(range(1, buckets))
        self.tot = 0.0

    def _hash(self, x: int) -> int:
        return int(((x * self.hash_mult) & 0xFFFFFFFF) % self.s)

    def query(self, x: int) -> int:
        key = self._hash(x)
        for i in range(self.c):
            if self.cnt[key, i] != 0 and self.val[key, i] == x:
                if self.dic[key, i]:
                    return -int(self.dic[key, i])
        return x

    def decay(self) -> None:
        for key in range(self.s):
            for i in range(self.c):
                if self.dic[key, i] and self.cnt[key, i] * self.decay_rate < self.k:
                    self.free.append(int(self.dic[key, i]))
                    self.dic[key, i] = 0
                self.cnt[key, i] *= self.decay_rate
        self.tot = 0.0

    def insert(self, x: int, v: float = 1.0) -> int:
        self.tot += v
        key = self._hash(x)
        promoted = 0
        for i in range(self.c):
            if self.cnt[key, i] and self.val[key, i] == x:
                self.cnt[key, i] += v
                if (self.cnt[key, i] >= self.k and self.free
                        and not self.dic[key, i]):
                    self.dic[key, i] = self.free.popleft()
                    promoted = 1
                # keep cells sorted descending by count (sketch.cpp:104-109)
                j = i
                while j and self.cnt[key, j] > self.cnt[key, j - 1]:
                    for a in (self.cnt, self.val, self.dic):
                        a[key, j], a[key, j - 1] = a[key, j - 1], a[key, j]
                    j -= 1
                return promoted
        for i in range(self.c):
            if self.cnt[key, i] == 0:
                self.cnt[key, i] = v
                self.val[key, i] = x
                return 0
        last = self.c - 1
        if not self.dic[key, last]:
            self.cnt[key, last] += v
            self.val[key, last] = x
        return 0

    def batch_insert(self, ids, scores=None) -> np.ndarray:
        if self.tot > self.s * self.k * 10:
            self.decay()
        if scores is None:
            scores = np.ones(len(ids))
        out = np.zeros(len(ids), dtype=np.int64)
        for i, (x, v) in enumerate(zip(ids, scores)):
            out[i] = self.insert(int(x), float(v))
        return out

    def batch_query(self, ids) -> np.ndarray:
        return np.array([self.query(int(x)) for x in ids], dtype=np.int64)

    def hot_ids(self) -> np.ndarray:
        """All ids currently holding a hot slot."""
        mask = self.dic != 0
        return self.val[mask].astype(np.int64)
