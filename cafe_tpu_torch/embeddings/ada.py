"""AdaEmbed baseline (port of cafe_tpu/embeddings/ada.py, one device).

One weight pool [hotn + 1, dim]; an int32 map `dic` routes each feature
id to its admitted slot (0 = not admitted; slot 0 stays zero because its
updates are dropped). Every step each id's gradient norm, normalised to
mean 1 per field, accumulates into `grad_norm`; it decays by 0.8 every
16,384 steps. At step 1 and every 4,096 steps a sampled churn check runs,
and when enough sampled ids would be hot but are not admitted, a rebuild
ranks every id by its per-field p95-normalised importance, admits the top
`hotn`, and hands the admitted ids the slots that no kept id holds (the
freed slots and their optimizer slots zeroed).

State: weight (+ optimizer slots), dic int32, grad_norm f32 (padding
lanes -1, never elected), step int32, key int64.

The sample. The JAX package draws it from a `jax.random` key split every
step, which torch cannot reproduce. The port keeps `key` as a fixed int64
seed and draws each check's sample from a torch.Generator seeded from
(key, step), so a reloaded checkpoint draws the same sample
(`sample_ids`; `_check` takes the indices, so a test can pin JAX's).

The step reads its step count back to the host (to pick the decay and
check steps) and the check reads its churn count: the step stays eager
(`capture_blocker`). Ties among importances resolve as `jax.lax.top_k`
resolves them, lower id first, through a stable descending sort.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.sparse import SLOT_SUFFIXES
from .base import Part, _offsets, round_up

CHECK_EVERY = 4096
DECAY_EVERY = 16384
DECAY = 0.8
SAMPLE = 1_000_000
CHURN_FRAC = 0.05


def _p95_weights(n: int):
    """(low, high, low_weight, high_weight) of the 95th percentile of n
    sorted values, in the f32 arithmetic of jnp.percentile (linear)."""
    f32 = np.float32
    q = f32(95.0) / f32(100.0)
    pos = q * (f32(n) - f32(1))
    low, high = np.floor(pos), np.ceil(pos)
    hw = pos - low
    lw = f32(1) - hw
    clip = lambda x: int(min(max(x, 0), n - 1))  # noqa: E731
    return clip(low), clip(high), float(lw), float(hw)


def percentile95(seg: torch.Tensor, weights) -> torch.Tensor:
    """jnp.percentile(seg, 95) of a 1-D f32 tensor of any length (a sort,
    where torch.quantile refuses more than 2^24 values)."""
    low, high, lw, hw = weights
    s = torch.sort(seg).values
    w = torch.tensor([lw, hw], dtype=torch.float32, device=seg.device)
    return s[low] * w[0] + s[high] * w[1]


class AdaPart(Part):
    capture_blocker = ("AdaEmbed: its step reads the step count back to "
                       "the host to pick the decay and churn-check steps, "
                       "and the check reads its churn count "
                       "(embeddings/ada.py apply_grads, _check)")

    def __init__(self, field_idx: List[int], counts: List[int], hotn: int,
                 dim: int, optimizer: str = "sgd"):
        self.field_idx = list(field_idx)
        self.counts = [int(c) for c in counts]
        self.hotn = int(hotn)
        if self.hotn <= 0:
            # the sizing formula charges the int32 dic and the f32
            # importance (2 i32-equivalents per id) against the budget,
            # so cr must exceed 2/dim
            raise ValueError(
                f"ada: hotn={self.hotn} — the row budget is consumed by "
                f"the dic/importance overhead; ada needs compress_rate > "
                f"2/dim (= {2.0 / dim:.4f} at dim {dim})")
        self.dim = dim
        self.optimizer = optimizer
        self.np_offsets = _offsets(self.counts)
        self.total_n = int(sum(self.counts))
        self.hot_rate = self.hotn / max(self.total_n, 1)
        self.sample = min(SAMPLE, self.total_n)
        self._p95 = [_p95_weights(n) for n in self.counts]

    def init(self, rng: np.random.Generator) -> Dict:
        np_pad = round_up(self.total_n)
        gn = np.full(np_pad, -1.0, dtype=np.float32)
        gn[: self.total_n] = 0.0
        dev = self.device
        state = {
            "weight": torch.zeros((round_up(self.hotn + 1), self.dim),
                                  dtype=torch.float32, device=dev),
            "dic": torch.zeros((np_pad,), dtype=torch.int32, device=dev),
            "grad_norm": torch.from_numpy(gn).to(dev),
            "step": torch.zeros((), dtype=torch.int32, device=dev),
            # the JAX package's PRNGKey(seed) from the same draw
            "key": torch.tensor(int(rng.integers(0, 2**31 - 1)),
                                dtype=torch.int64, device=dev),
        }
        return self._maybe_acc(state, "weight")

    def gather(self, state: Dict, ids: torch.Tensor):
        gid = ids + self._const("np_offsets")
        rows = state["dic"][gid.long()]
        return state["weight"][rows.long()], (gid, rows)

    def apply_grads(self, state: Dict, ids, g_raw, aux, lr: float):
        gid, rows = aux
        b, f, d = g_raw.shape
        # weight update; slot-0 (not admitted) lanes go past the last row
        # and are dropped
        widx = torch.where(rows > 0, rows, state["weight"].shape[0])
        state = self._table_update(state, "weight", widx.reshape(-1),
                                   g_raw.reshape(b * f, d), lr)
        # importance, normalised to mean 1 per field
        norms = torch.sqrt((g_raw * g_raw).sum(-1) + 1e-30)
        norms = norms * b / (norms.sum(0, keepdim=True) + 1e-30)
        grad_norm = state["grad_norm"].index_add_(
            0, gid.reshape(-1).long(), norms.reshape(-1))
        step = int(state["step"]) + 1
        if step % DECAY_EVERY == 0:
            grad_norm.mul_(DECAY)
        state = {**state, "grad_norm": grad_norm,
                 "step": state["step"] + 1}
        if step == 1 or step % CHECK_EVERY == 0:
            state, _ = self._check(state, self.sample_ids(state, step))
        return state, {"ada_admitted": (state["dic"] > 0).sum()}

    def quantize_for_serving(self, state: Dict, bits: int) -> Dict:
        # row 0 (not admitted) is all zero and dequantizes to exactly zero
        return {"weight": self._quantize(state["weight"], bits)}

    def gather_quantized(self, state: Dict, qt: Dict, ids: torch.Tensor):
        gid = ids + self._const("np_offsets")
        return self._dequantize(qt["weight"], state["dic"][gid.long()])

    def sample_ids(self, state: Dict, step: int) -> torch.Tensor:
        """The check's `sample` ids, drawn with replacement from a
        generator seeded from (key, step)."""
        seed = np.random.SeedSequence(
            [int(state["key"]), step]).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return torch.randint(0, self.total_n, (self.sample,),
                             generator=gen, device=self.device)

    # -- policy -------------------------------------------------------
    def _check(self, state: Dict, idx: torch.Tensor):
        """Sampled churn estimate over the ids `idx`: rebuild when more
        than CHURN_FRAC of the top-m sampled importances belong to ids not
        admitted. Returns (state, whether it rebuilt)."""
        cnt = state["grad_norm"][idx.long()]
        dic = state["dic"][idx.long()]
        m = max(int(np.ceil(self.sample * self.hot_rate)), 1)
        kth = torch.topk(cnt, m).values[-1]
        churn = int(((cnt >= kth) & (dic == 0)).sum())
        if churn > np.float32(CHURN_FRAC * m):
            return self._rebuild(state), True
        return state, False

    def _rebuild(self, state: Dict) -> Dict:
        """Admit the global top `hotn` ids by per-field p95-normalised
        importance; evicted ids free their slots, admitted ids take free
        slots in order, every slot no kept id holds is zeroed (with its
        optimizer slots). dic, weight and the slots change in place."""
        cnt = state["grad_norm"]
        dic = state["dic"]
        np_pad = cnt.shape[0]
        normed = torch.full_like(cnt, -1.0)   # padding lanes unelectable
        for i, n in enumerate(self.counts):
            lo = int(self.np_offsets[i])
            seg = cnt[lo:lo + n]
            p = percentile95(seg, self._p95[i])
            normed[lo:lo + n] = torch.where(p != 0, seg / p, seg)
        # top-k with lax.top_k's tie order: equal values, lower index first
        top = torch.sort(normed, descending=True,
                         stable=True).indices[:self.hotn]
        new_hot = torch.zeros(np_pad, dtype=torch.bool, device=cnt.device)
        new_hot[top] = True
        old_hot = dic != 0
        admit = new_hot & ~old_hot
        evict = old_hot & ~new_hot
        keep = new_hot & old_hot
        weight = state["weight"]
        wpad = weight.shape[0]
        used = torch.zeros(wpad, dtype=torch.bool, device=cnt.device)
        used[torch.where(keep, dic, 0).long()] = True
        slot = torch.arange(wpad, device=cnt.device)
        free = torch.nonzero((slot >= 1) & (slot <= self.hotn) & ~used)[:, 0]
        admit_pos = torch.nonzero(admit)[:, 0]
        k = min(len(admit_pos), len(free))
        dic[admit_pos[:k]] = free[:k].to(torch.int32)
        dic.masked_fill_(evict, 0)
        weight.masked_fill_(~used[:, None], 0.0)
        for sfx in SLOT_SUFFIXES[self.optimizer].values():
            if state["weight" + sfx].ndim == 2:
                state["weight" + sfx].masked_fill_(~used[:, None], 0.0)
        return state
