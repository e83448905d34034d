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

The decay is a device branch (utils/cond.cond), so an ordinary step
replays in a CUDA graph. The check steps (`host_step`: step 1 and every
CHECK_EVERY-th) draw the sample on the host, read the churn count and
rebuild through shapes that follow the data: they run eagerly, the
GraphedStep picking them from its host mirror of the step counter
(train/capture.StepMirror). Ties among importances resolve as
`jax.lax.top_k` resolves them, lower id first, through a stable
descending sort.

Under a mesh (enable_mesh) the admission policy is SHARD-LOCAL, as in
the JAX package: the pool splits into per-rank slot ranges, ids belong
to ranks CYCLICALLY (id % n; dic and grad_norm are stored
cyclic-permuted, so a rank's contiguous slice is its id slice), and each
rank runs its own sampled check and rebuild over its ids with a budget
of hotn / n (`_check_local`, `_rebuild_local`: no collective inside, so
ranks may branch apart). The forward all-gathers the ids, their cyclic
owners answer dic, the pool's owners answer the rows. The update
coalesces, all-gathers and lets the pool's owners apply (K2 / K3 through
ops/sparse.apply_rows); the importance lands at the cyclic owners,
normalised over the GLOBAL batch (per-field sums all-reduced). Each
rank's check samples sample / n of its ids from a generator seeded from
(key, step, rank). A mesh-less part in the n-shard layout
(enable_sharded_layout) serves such a state on one device.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.sparse import SLOT_SUFFIXES, apply_rows, coalesce
from ..parallel.exchange import (DROP_ROW, _local_idx, _owner_rows,
                                 all_gather, owner_lookup_cyclic, psum,
                                 psum_scatter)
from ..parallel.sharding import rows_of
from ..utils.cond import cond, host_pred
from .base import _MIN_SHARD_ROWS, Part, _offsets, round_up

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


def _decay_(grad_norm):
    grad_norm.mul_(DECAY)


class AdaPart(Part):
    # the decay is a device branch (utils/cond.cond)
    conds = True

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
        # the storage layout's shard count: the mesh's size under a mesh,
        # n under enable_sharded_layout(n), else 1
        self.n_shards = 1

    def _shardable(self, n: int) -> bool:
        wpad = round_up(self.hotn + 1)
        np_pad = round_up(self.total_n)
        return not (wpad % n or np_pad % n) and \
            wpad >= max(n, _MIN_SHARD_ROWS) and self.hotn // n >= 1

    def enable_mesh(self, mesh) -> bool:
        if not self._shardable(mesh.size):
            return False
        self.mesh = mesh
        self.n_shards = mesh.size
        return True

    def enable_sharded_layout(self, n: int) -> bool:
        """Adopt the n-shard STATE layout (cyclic-permuted dic and
        grad_norm) without a mesh, so that the global state of a run on n
        ranks serves on one device. Serving only: training raises."""
        if n < 1 or self.mesh is not None or not self._shardable(n):
            return False
        self.n_shards = n
        return True

    def _store_perm(self, np_pad: int) -> np.ndarray:
        """store[k] holds global id g = (k % L)*n + k // L (shard-major
        cyclic permutation; L = np_pad // n)."""
        n = self.n_shards
        L = np_pad // n
        k = np.arange(np_pad, dtype=np.int64)
        return (k % L) * n + k // L

    def init(self, rng: np.random.Generator) -> Dict:
        np_pad = round_up(self.total_n)
        gn = np.full(np_pad, -1.0, dtype=np.float32)
        gn[: self.total_n] = 0.0
        if self.n_shards > 1:
            gn = gn[self._store_perm(np_pad)]
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
        if self.mesh is not None:
            rows = owner_lookup_cyclic(
                state["dic"], all_gather(gid.reshape(-1), self.mesh),
                self.mesh)
            raw = psum_scatter(_owner_rows(state["weight"], rows, self.mesh),
                               self.mesh)
            rows = rows[rows_of(self.mesh, rows.shape[0])]
            return raw.reshape(*gid.shape, -1), (gid, rows.reshape(gid.shape))
        rows = self._dic_lookup(state, gid)
        return self._lookup(state, "weight", rows), (gid, rows)

    def _dic_lookup(self, state: Dict, gid: torch.Tensor) -> torch.Tensor:
        """dic[gid] through the storage layout (cyclic-permuted in the
        n-shard layout)."""
        n = self.n_shards
        gid = gid.long()
        if n > 1:
            gid = (gid % n) * (state["dic"].shape[0] // n) + gid // n
        return state["dic"][gid]

    def apply_grads(self, state: Dict, ids, g_raw, aux, lr: float):
        gid, rows = aux
        if self.mesh is not None:
            return self._apply_sharded(state, gid, rows, g_raw, lr)
        if self.n_shards > 1:
            raise RuntimeError(
                "AdaPart: training in the sharded layout requires the mesh "
                "(enable_mesh); enable_sharded_layout serves only")
        b, f, d = g_raw.shape
        # weight update; slot-0 (not admitted) lanes go past the pool's
        # last row (under auto, past the last shard's) and are dropped
        widx = torch.where(rows > 0, rows, round_up(self.hotn + 1))
        state = self._table_update(state, "weight", widx.reshape(-1),
                                   g_raw.reshape(b * f, d), lr)
        # importance, normalised to mean 1 per field
        norms = torch.sqrt((g_raw * g_raw).sum(-1) + 1e-30)
        norms = norms * b / (norms.sum(0, keepdim=True) + 1e-30)
        grad_norm = state["grad_norm"].index_add_(
            0, gid.reshape(-1).long(), norms.reshape(-1))
        step = state["step"] + 1
        cond(step % DECAY_EVERY == 0, _decay_, None, (grad_norm,),
             name="ada_decay")
        state = {**state, "grad_norm": grad_norm, "step": step}
        if self._check_due(step):
            # the importance sums in float atomics on the card: under auto
            # every rank's check reads rank 0's
            self._agree(grad_norm)
            state, _ = self._check(state, self.sample_ids(state,
                                                          int(step)))
        return state, {"ada_admitted": (state["dic"] > 0).sum()}

    @staticmethod
    def host_step(step: int) -> bool:
        """Steps (counted from 1) that run the sampled check: they draw
        the sample on the host and the rebuild's shapes follow the data,
        so they run eagerly (train/capture.GraphedStep's StepMirror)."""
        return step == 1 or step % CHECK_EVERY == 0

    @staticmethod
    def _check_due(step: torch.Tensor) -> bool:
        """Whether this step runs the check. A graph never holds one: a
        GraphedStep captures only calls without a check step (its host
        mirror of the step counter picks them), so a step being captured
        skips it; an eager step reads the predicate once."""
        if step.is_cuda and torch.cuda.is_current_stream_capturing():
            return False
        return host_pred((step == 1) | (step % CHECK_EVERY == 0))

    def quantize_for_serving(self, state: Dict, bits: int) -> Dict:
        # row 0 (not admitted) is all zero and dequantizes to exactly zero
        return {"weight": self._quantize(state["weight"], bits)}

    def gather_quantized(self, state: Dict, qt: Dict, ids: torch.Tensor):
        gid = ids + self._const("np_offsets")
        if self.mesh is not None:
            # the cyclic owners answer dic, the pool's owners dequantize:
            # O(batch) traffic, the dic and the codes never move
            rows = owner_lookup_cyclic(
                state["dic"], all_gather(gid.reshape(-1), self.mesh),
                self.mesh)
            return self._dequantize_owned(qt["weight"], rows).reshape(
                *gid.shape, -1)
        return self._dequantize(qt["weight"], self._dic_lookup(state, gid),
                                key="weight")

    def _draw(self, seeds, high: int, size: int) -> torch.Tensor:
        seed = np.random.SeedSequence(seeds).generate_state(1, np.uint64)[0]
        gen = torch.Generator(device=self.device)
        gen.manual_seed(int(seed))
        return torch.randint(0, high, (size,), generator=gen,
                             device=self.device)

    def sample_ids(self, state: Dict, step: int) -> torch.Tensor:
        """The check's `sample` ids, drawn with replacement from a
        generator seeded from (key, step)."""
        return self._draw([int(state["key"]), step], self.total_n,
                          self.sample)

    def sample_ids_local(self, state: Dict, step: int,
                         me: int) -> torch.Tensor:
        """Rank `me`'s check sample: sample / n local positions of its
        live ids, seeded from (key, step, rank)."""
        n = self.n_shards
        n_live = max((self.total_n - 1 - me) // n + 1, 1)
        return self._draw([int(state["key"]), step, me],
                          min(n_live, state["dic"].shape[0]),
                          max(self.sample // n, 1))

    # -- the sharded step ----------------------------------------------
    def _apply_sharded(self, state: Dict, gid, rows, g_raw, lr: float):
        """The pool's owners apply the coalesced, all-gathered update;
        the importance accumulates at the cyclic owners; then this rank's
        decay (a device branch, as on one device), check and rebuild (no
        collective in them; host steps, as on one device), and the
        admitted count summed over the mesh."""
        mesh, n = self.mesh, self.n_shards
        b, f, d = g_raw.shape
        m = b * f
        weight, slots = state["weight"], self._slots_of(state, "weight")
        widx = torch.where(rows > 0, rows, DROP_ROW).reshape(m)
        widx, g2 = coalesce(widx, g_raw.reshape(m, d), DROP_ROW)
        weight, slots = apply_rows(
            weight, slots, _local_idx(weight.shape[0],
                                      all_gather(widx, mesh), mesh),
            all_gather(g2, mesh), lr, self.optimizer, self.apply_impl)
        # importance, normalised to mean 1 per field over the GLOBAL batch
        norms = torch.sqrt((g_raw * g_raw).sum(-1) + 1e-30)
        norms = norms * (b * n) / (psum(norms.sum(0, keepdim=True), mesh)
                                   + 1e-30)
        all_gid = all_gather(gid.reshape(-1), mesh).long()
        all_sc = all_gather(norms.reshape(-1), mesh)
        mine = all_gid % n == mesh.rank
        grad_norm = state["grad_norm"]
        grad_norm.index_add_(0, torch.where(mine, all_gid // n, 0),
                             torch.where(mine, all_sc, 0.0))
        step = state["step"] + 1
        cond(step % DECAY_EVERY == 0, _decay_, None, (grad_norm,),
             name="ada_decay")
        carry = (weight, slots, state["dic"], grad_norm)
        if self._check_due(step):
            carry, _ = self._check_local(
                carry, self.sample_ids_local(state, int(step), mesh.rank),
                mesh.rank)
        weight, slots, dic, grad_norm = carry
        n_adm = psum((dic != 0).sum(dtype=torch.int32), mesh)
        out = self._put_slots({**state, "weight": weight, "dic": dic,
                               "grad_norm": grad_norm, "step": step},
                              "weight", slots)
        return out, {"ada_admitted": n_adm}

    def _check_local(self, carry, idx: torch.Tensor, me: int):
        """Rank `me`'s sampled churn estimate over the local positions
        `idx` of its id slice (the statistic of _check at sample / n
        draws). Returns (carry, whether it rebuilt)."""
        _, _, dic_l, gn_l = carry
        sample_l = max(self.sample // self.n_shards, 1)
        cnt = gn_l[idx.long()]
        m_l = max(int(np.ceil(sample_l * self.hot_rate)), 1)
        kth = torch.topk(cnt, m_l).values[-1]
        churn = int(((cnt >= kth) & (dic_l[idx.long()] == 0)).sum())
        if churn > np.float32(CHURN_FRAC * m_l):
            return self._rebuild_local(carry, me), True
        return carry, False

    def _field_lanes(self, me: int, L: int):
        """Per field, the contiguous local positions [k0, k1) of rank
        `me`'s id slice (global id k * n + me) that hold the field's ids,
        with the p95 weights of their count; empty fields left out."""
        n = self.n_shards
        out = []
        for i, cnt in enumerate(self.counts):
            lo = int(self.np_offsets[i])
            k0 = max(-(-(lo - me) // n), 0)
            k1 = min(-(-(lo + cnt - me) // n), L)
            if k1 > k0:
                out.append((k0, k1, _p95_weights(k1 - k0)))
        return out

    def _rebuild_local(self, carry, me: int):
        """Rank `me`'s admit/evict swap over its id slice and its OWN slot
        range [me * W_l, (me + 1) * W_l): the local top-(hotn / n) by
        per-field p95-normalised importance (the JAX package's
        shard-local rebuild); global slot 0, the not-admitted sentinel,
        is never handed out. In place; returns the carry."""
        w_l, sl, dic_l, gn_l = carry
        n = self.n_shards
        L, W_l = gn_l.shape[0], w_l.shape[0]
        dev = gn_l.device
        normed = torch.full_like(gn_l, -float("inf"))   # unelectable
        for k0, k1, weights in self._field_lanes(me, L):
            seg = gn_l[k0:k1]
            p = percentile95(seg, weights)
            normed[k0:k1] = torch.where(p != 0, seg / p, seg)
        top = torch.sort(normed, descending=True,
                         stable=True).indices[:max(self.hotn // n, 1)]
        new_hot = torch.zeros(L, dtype=torch.bool, device=dev)
        new_hot[top] = True
        new_hot &= torch.isfinite(normed)
        old_hot = dic_l != 0
        admit = new_hot & ~old_hot
        evict = old_hot & ~new_hot
        keep = new_hot & old_hot
        lo_slot = me * W_l
        used = torch.zeros(W_l + 1, dtype=torch.bool, device=dev)
        used[torch.where(keep, dic_l - lo_slot, W_l).long()] = True
        used = used[:W_l]
        free_mask = ~used
        if me == 0:
            free_mask[0] = False      # global slot 0: not admitted
        free = torch.nonzero(free_mask)[:, 0]
        admit_pos = torch.nonzero(admit)[:, 0]
        k = min(len(admit_pos), len(free))
        dic_l[admit_pos[:k]] = (free[:k] + lo_slot).to(torch.int32)
        dic_l.masked_fill_(evict, 0)
        w_l.masked_fill_(~used[:, None], 0.0)
        for v in sl.values():
            if v.dim() == 2:
                v.masked_fill_(~used[:, None], 0.0)
        return w_l, sl, dic_l, gn_l

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
        wpad = round_up(self.hotn + 1)   # the pool (a shard under auto)
        used = torch.zeros(wpad, dtype=torch.bool, device=cnt.device)
        used[torch.where(keep, dic, 0).long()] = True
        slot = torch.arange(wpad, device=cnt.device)
        free = torch.nonzero((slot >= 1) & (slot <= self.hotn) & ~used)[:, 0]
        admit_pos = torch.nonzero(admit)[:, 0]
        k = min(len(admit_pos), len(free))
        dic[admit_pos[:k]] = free[:k].to(torch.int32)
        dic.masked_fill_(evict, 0)
        for sfx in [""] + list(SLOT_SUFFIXES[self.optimizer].values()):
            if state["weight" + sfx].ndim == 2:
                state["weight" + sfx].masked_fill_(
                    ~self._owned_rows("weight" + sfx, used)[:, None], 0.0)
        return state
