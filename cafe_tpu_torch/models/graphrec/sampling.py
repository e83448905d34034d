"""BPR negative sampling.

Reference: the pybind11 C++ sampler
TOIS_revision/LightGCN/code/sources/sampling.cpp:27-56 — per user,
train_num/user_num (pos, neg) pairs with uniform negatives rejected against
the user's positive set. This numpy version vectorizes the rejection loop;
a C++ twin lives in native/ for parity and host-side speed.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np


def sample_negative(user_num: int, item_num: int, train_num: int,
                    all_pos: Sequence[np.ndarray], neg_num: int = 1,
                    seed: int = 0) -> np.ndarray:
    """Returns [user_num * per_user, 2 + neg_num] rows of
    (user, pos_item, neg_0..neg_{k-1})."""
    rng = np.random.default_rng(seed)
    per_user = max(train_num // max(user_num, 1), 1)
    rows = user_num * per_user
    out = np.empty((rows, 2 + neg_num), dtype=np.int32)
    pos_sets: List[set] = [set(p.tolist()) for p in all_pos]
    r = 0
    for user in range(user_num):
        pos = all_pos[user]
        if len(pos) == 0:
            continue  # cold-start users have nothing to train on; the
            # reference C++ sampler likewise only emits real positives
        ps = pos_sets[user]
        picks = rng.integers(0, len(pos), per_user)
        for i in range(per_user):
            out[r, 0] = user
            out[r, 1] = pos[picks[i]]
            for j in range(neg_num):
                neg = int(rng.integers(0, item_num))
                while neg in ps:
                    neg = int(rng.integers(0, item_num))
                out[r, 2 + j] = neg
            r += 1
    return out[:r]
