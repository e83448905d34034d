"""A plain rendering of the batched HotSketch v1 insert (CAFE's sketch as
the port runs it on a batch of lanes), in numpy and Python loops over
buckets, for the benchmark's reference. It shares no code with the port.

The sketch: S buckets of C cells, each cell (id, count, hot slot). A
batch insert of (id, score) lanes:

1. Decay: when the score mass since the last decay exceeds S * k * 10,
   every count is multiplied by the decay rate and each hot cell whose
   decayed count falls below the threshold k gives its slot back (slots
   pushed on the free stack in row-major cell order); the mass restarts.
2. The lanes group by (bucket, id); a group's score is its lanes' sum.
   Buckets are visited in order, and within a bucket the groups by id.
3. Round 1, per bucket, against its (decayed) cells:
   - a group whose id sits in an occupied cell adds its score to that
     cell; if the new count reaches k and the cell holds no slot (a slot
     of a cell below k does not count), it is a promotion candidate;
   - the first group of the bucket that found no cell is placed: into
     the first empty cell, else over the least-count cell that holds no
     slot and no matched id (the first among ties), taking that count
     plus its score; the later unmatched groups wait for round 2.
   All round-1 writes see the cells as they were before the round.
4. Candidates are promoted in group order, at most min(free slots,
   PROMO_LANES): the r-th takes the slot at the stack's top minus r.
5. Round 2: the first PROMO_LANES waiting groups, in group order; the
   first of each bucket is placed as in round 1 against the cells after
   round 1 (no cell blocked), the rest are dropped.
6. The mass grows by the sum of every score.
A query answers the largest slot among the bucket's occupied cells that
hold the id, or "not hot".
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

INVALID_ID = 2**31 - 1
HASH_MULT = 2654435761


def bucket_of(ids: np.ndarray, s: int) -> np.ndarray:
    return ((ids.astype(np.int64) & 0xFFFFFFFF) * HASH_MULT
            & 0xFFFFFFFF) % s


class Sketch:
    def __init__(self, buckets: int, threshold: float, decay: float,
                 cells: int = 4, promo_lanes: int = 4096,
                 free_len: int = 0):
        self.s = buckets
        self.c = cells
        self.k = np.float32(threshold)
        self.decay = np.float32(decay)
        self.pl_max = promo_lanes
        self.val = np.zeros((buckets, cells), dtype=np.int64)
        self.cnt = np.zeros((buckets, cells), dtype=np.float32)
        self.dic = np.zeros((buckets, cells), dtype=np.int64)
        # the free stack holds slots 1 .. S-1, the top at free_top - 1
        self.free = np.zeros(max(free_len, buckets), dtype=np.int64)
        self.free[:buckets - 1] = np.arange(1, buckets)
        self.free_top = buckets - 1
        self.tot = np.float32(0.0)

    def load(self, st) -> None:
        """Take a whole state: {val, cnt, dic [S, C]; free; free_top;
        tot} (benchmark/warm.py makes one from the seed)."""
        self.val = np.array(st["val"], dtype=np.int64)
        self.cnt = np.array(st["cnt"], dtype=np.float32)
        self.dic = np.array(st["dic"], dtype=np.int64)
        self.free = np.zeros(max(self.free.shape[0], len(st["free"])),
                             dtype=np.int64)
        self.free[:len(st["free"])] = st["free"]
        self.free_top = int(st["free_top"])
        self.tot = np.float32(st["tot"])

    # ------------------------------------------------------------ query
    def query(self, ids: np.ndarray) -> np.ndarray:
        """The hot slot of each id, 0 where it is not hot."""
        b = bucket_of(ids, self.s)
        m = (self.cnt[b] > 0) & (self.val[b] == ids[:, None]) \
            & (self.dic[b] != 0)
        return np.where(m, self.dic[b], 0).max(axis=1)

    # ------------------------------------------------------------ helpers
    def _push(self, slots) -> None:
        for slot in slots:
            if self.free_top < self.free.shape[0]:
                self.free[self.free_top] = slot
            self.free_top += 1

    def _place(self, cnt_row, dic_row, blocked) -> int:
        """The cell a newcomer takes, or -1."""
        for c in range(self.c):
            if not cnt_row[c] > 0:
                return c
        best = -1
        for c in range(self.c):
            if dic_row[c] == 0 and c not in blocked and (
                    best < 0 or cnt_row[c] < cnt_row[best]):
                best = c
        return best

    # ------------------------------------------------------------ insert
    def insert(self, ids: np.ndarray, scores: np.ndarray
               ) -> List[Tuple[int, int, int, int]]:
        """Insert the lanes; returns the promotions [(id, slot, bucket,
        cell)] in rank order."""
        ids = np.asarray(ids, dtype=np.int64)
        scores = np.maximum(np.asarray(scores, dtype=np.float32), 0)
        valid = ids != INVALID_ID
        scores = np.where(valid, scores, np.float32(0))
        k = self.k
        decay_at = np.float32(self.s) * k * np.float32(10.0)

        # 1. decay
        do_decay = self.tot > decay_at
        fdec = self.decay if do_decay else np.float32(1.0)
        demote = (self.dic != 0) & (self.cnt * fdec < k)
        if do_decay:
            self._push(self.dic[demote].tolist())
            self.tot = np.float32(0.0)
        self.cnt = (self.cnt * fdec).astype(np.float32)
        self.dic[demote] = 0

        # 2. groups by (bucket, id)
        v_ids, v_sc = ids[valid], scores[valid]
        buckets = bucket_of(v_ids, self.s)
        key = buckets * (1 << 32) + v_ids
        ukey, inv = np.unique(key, return_inverse=True)
        gsum = np.zeros(ukey.shape[0], dtype=np.float64)
        np.add.at(gsum, inv, v_sc.astype(np.float64))
        gsum = gsum.astype(np.float32)
        g_bucket = (ukey >> 32).astype(np.int64)
        g_id = (ukey & 0xFFFFFFFF).astype(np.int64)
        starts = np.flatnonzero(np.r_[True, g_bucket[1:] != g_bucket[:-1]])
        ends = np.r_[starts[1:], g_bucket.shape[0]]

        # 3. round 1 (writes against the cells as they were)
        cand, waiting = [], []
        writes = []
        for lo, hi in zip(starts, ends):
            b = int(g_bucket[lo])
            bc, bv, bd0 = self.cnt[b], self.val[b], self.dic[b]
            bd = [0 if (bd0[c] != 0 and bc[c] < k) else int(bd0[c])
                  for c in range(self.c)]
            matched = []
            new = []
            for g in range(lo, hi):
                cell = -1
                for c in range(self.c):
                    if bc[c] > 0 and bv[c] == g_id[g]:
                        cell = c
                        break
                if cell >= 0:
                    matched.append((g, cell))
                else:
                    new.append(g)
            for g, cell in matched:
                n_c = np.float32(bc[cell] + gsum[g])
                writes.append((b, cell, None, n_c))
                if n_c >= k and bd[cell] == 0:
                    cand.append((g, b, cell))
            if new:
                blocked = {cell for _, cell in matched}
                use = self._place(bc, bd, blocked)
                if use >= 0:
                    writes.append((b, use, int(g_id[new[0]]),
                                   np.float32(bc[use] + gsum[new[0]])))
                waiting.extend(new[1:])
        for b, cell, vid, n_c in writes:
            self.cnt[b, cell] = n_c
            if vid is not None:
                self.val[b, cell] = vid

        # 4. promotions
        pl = min(int(valid.shape[0]), self.pl_max)
        ft0 = self.free_top
        bound = min(ft0, pl)
        promos = []
        for r, (g, b, cell) in enumerate(cand[:max(bound, 0)], start=1):
            slot = int(self.free[ft0 - r])
            self.dic[b, cell] = slot
            promos.append((int(g_id[g]), slot, b, cell))
        self.free_top = ft0 - len(promos)

        # 5. round 2
        seen = set()
        for g in waiting[:pl]:
            b = int(g_bucket[g])
            if b in seen:
                continue
            seen.add(b)
            use = self._place(self.cnt[b], self.dic[b], ())
            if use >= 0:
                self.cnt[b, use] = np.float32(self.cnt[b, use] + gsum[g])
                self.val[b, use] = g_id[g]

        # 6. the mass
        self.tot = np.float32(self.tot + np.float32(
            scores.astype(np.float64).sum()))
        return promos

    def revert(self, promos) -> None:
        """Undo promotions: clear their cells' slots and push the slots
        back in order."""
        for _, slot, b, cell in promos:
            self.dic[b, cell] = 0
        self._push([slot for _, slot, _, _ in promos])
