"""PinSAGE item-to-item recommender with CAFE-compressed item embeddings
(port of cafe_tpu/models/graphrec/pinsage.py).

The sampler is the JAX package's host numpy random walk, drawing from its
generator in the same order, so one seed gives the same blocks in both
packages. The item-id embedding is a CAFE v1 part (compress_ratio > 1,
the reference's sizing) or a full table; two weighted-SAGE convolutions
and the max-margin loss run through autograd on static [batch, T]
neighbour blocks; the convs take the dense optimizer
(train/step._dense_update) and the table the part's apply_grads on the
block's padded unique ids, whose CAFE insert lands through kernel K1
(land_impl 'auto'; the JAX package's part keeps the 'segmax' default,
which lands the same values). The block's three position gathers take
ops/sparse.gather_rows, whose backward sums a repeated position's
gradients through segment_rows (kernel K3 on the card), and the part
coalesces its duplicate rows the same way (Part.deterministic_sums): the
step's sums run in a fixed order, so two runs from one state repeat bit
for bit.

The train and representation steps read nothing back to the host and
make no shape from the data (the block is padded to a fixed capacity,
the rows-Adam / Adagrad apply updates fixed-shape rows), so on the card
`build_train_step` and `build_representation_step` replay them as CUDA
graphs, the port's counterparts of main_graphrec.py's
`jax.jit(model.train_step)` and of `represent_items`' jitted
representation step (train/capture.py). A graph keys on positional
tensors, so the built steps take the block as BLOCK_KEYS in order; on
the CPU they run eagerly. The host sampler, not the device, sets a
step's pace.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Tuple

import numpy as np
import torch

from ...device import resolve_device
from ...embeddings.base import HashedTablePart
from ...embeddings.cafe import CafePart
from ...ops.sparse import gather_rows
from ...train.step import (_dense_update, _leaves, build_graphrec_step,
                           init_dense_opt)

# a block's tensors in the positional order of the built steps
BLOCK_KEYS = ("ids", "ego_pos", "nbr1_pos", "nbr2_pos", "w1", "w2")


def block_args(block: Dict) -> tuple:
    """A block's tensors as the built steps take them (BLOCK_KEYS)."""
    return tuple(block[k] for k in BLOCK_KEYS)


class FixedLR:
    """A train step built for one learning rate: `step(state, *block,
    lr)`. A graph replays the lr it was captured with, so a call with
    another lr raises rather than replay a stale constant. Attributes
    not set here (`graphed`, `replays`, `capture_s`, ...) are the
    wrapped step's."""

    def __init__(self, step, lr: float):
        self.step = step
        self.lr = lr

    def __getattr__(self, name):
        return getattr(self.step, name)

    def __call__(self, state, *args):
        *block, lr = args
        if lr != self.lr:
            raise ValueError(f"PinSAGE train step built for lr {self.lr}, "
                             f"called with lr {lr}: build another step")
        return self.step(state, *block)


class RandomWalkSampler:
    """Item->user->item random walks; neighbors ranked by visit count.

    Equivalent role to dgl.sampling.RandomWalkNeighborSampler as used in
    sampler.py (num_random_walks, num_neighbors): for each seed item run
    `walks` 2-hop walks and keep the top `T` most-visited items with their
    visit counts as edge weights.
    """

    def __init__(self, user_items: List[np.ndarray],
                 item_users: List[np.ndarray], walks: int = 10,
                 top_t: int = 3, seed: int = 0):
        self.user_items = user_items
        self.item_users = item_users
        self.walks = walks
        self.top_t = top_t
        self.rng = np.random.default_rng(seed)

    def sample(self, seeds: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
        """-> (neighbors [B, T] int32, weights [B, T] f32); self-loop pads
        seeds with no reachable neighbors."""
        b = len(seeds)
        nbrs = np.tile(seeds[:, None], (1, self.top_t)).astype(np.int32)
        wts = np.zeros((b, self.top_t), dtype=np.float32)
        wts[:, 0] = 1.0
        for i, s in enumerate(seeds):
            visits: Dict[int, int] = {}
            us = self.item_users[int(s)]
            if len(us) == 0:
                continue
            for _ in range(self.walks):
                u = us[self.rng.integers(0, len(us))]
                its = self.user_items[int(u)]
                if len(its) == 0:
                    continue
                it = int(its[self.rng.integers(0, len(its))])
                if it != int(s):
                    visits[it] = visits.get(it, 0) + 1
            if not visits:
                continue
            top = sorted(visits.items(), key=lambda kv: -kv[1])[: self.top_t]
            for j, (it, c) in enumerate(top):
                nbrs[i, j] = it
                wts[i, j] = c
        return nbrs, wts

    def pos_pairs(self, batch: int) -> Tuple[np.ndarray, np.ndarray,
                                             np.ndarray]:
        """(head, pos, neg) item triples: pos reached by a 2-hop walk from
        head, neg uniform (sampler.py's ItemToItemBatchSampler)."""
        n_items = len(self.item_users)
        heads = self.rng.integers(0, n_items, batch).astype(np.int32)
        pos = heads.copy()
        for i, h in enumerate(heads):
            us = self.item_users[int(h)]
            if len(us) == 0:
                continue
            u = us[self.rng.integers(0, len(us))]
            its = self.user_items[int(u)]
            if len(its):
                pos[i] = its[self.rng.integers(0, len(its))]
        neg = self.rng.integers(0, n_items, batch).astype(np.int32)
        return heads, pos, neg


@dataclasses.dataclass
class PinSAGEConfig:
    hidden_dims: int = 16
    n_layers: int = 2
    lr: float = 0.01
    compress_ratio: int = 1      # >1 enables CAFE (layers.py:81-90)
    sketch_threshold: float = 500.0
    seed: int = 0
    # applies to BOTH the conv params (dense Adam) and the embedding table
    # (rows-Adam, ops/sparse.py). The reference trains with Adam
    # (PinSAGE/model.py:133); sgd/adagrad kept for ablations.
    optimizer: str = "adam"      # sgd | adagrad | adam


class PinSAGE:
    def __init__(self, cfg: PinSAGEConfig, n_items: int, device="cuda"):
        self.cfg = cfg
        self.n_items = n_items
        self.device = resolve_device(device)
        d = cfg.hidden_dims
        if cfg.compress_ratio > 1:
            size = n_items // cfg.compress_ratio
            hash_size = int(size * 0.5)          # layers.py:32-33
            hotn = max(int(size - hash_size) * d // (d + 13), 2)
            hash_size = max(hash_size, 1)
            self.part = CafePart([0], [n_items], [0], hotn, [hash_size], d,
                                 cfg.sketch_threshold, 0.99, n_items,
                                 optimizer=cfg.optimizer, land_impl="auto")
        else:
            self.part = HashedTablePart([0], [n_items], [n_items], d,
                                        optimizer=cfg.optimizer)
        self.part.device = self.device
        self.part.deterministic_sums = True

    def init(self) -> Dict:
        rng = np.random.default_rng(self.cfg.seed)
        state = {"embed": self.part.init(rng)}
        d = self.cfg.hidden_dims

        def xav(shape):
            bound = np.sqrt(6.0 / (shape[0] + shape[1]))
            return torch.from_numpy(rng.uniform(-bound, bound, shape)
                                    .astype(np.float32)).to(self.device)

        def zeros():
            return torch.zeros((d,), dtype=torch.float32, device=self.device)

        for li in range(self.cfg.n_layers):
            state[f"conv{li}"] = {"wn": xav((d, d)), "bn": zeros(),
                                  "wo": xav((2 * d, d)), "bo": zeros()}
        convs = [state[f"conv{li}"] for li in range(self.cfg.n_layers)]
        state["opt"] = init_dense_opt(convs, self.cfg.optimizer)
        return state

    # -- weighted SAGE conv (layers.py WeightedSAGEConv) ----------------
    def _conv(self, p, h_self, h_nbr, w):
        """h_nbr [B, T, D], w [B, T] -> [B, D]."""
        m = torch.relu(h_nbr @ p["wn"] + p["bn"])
        agg = (m * w[..., None]).sum(1) / (w.sum(1, keepdim=True) + 1e-9)
        z = torch.relu(torch.cat([h_self, agg], 1) @ p["wo"] + p["bo"])
        return z / (torch.linalg.vector_norm(z, dim=1, keepdim=True) + 1e-9)

    def _representation(self, state, ego_rows, nbr_rows1, w1,
                        nbr_rows2, w2):
        """Two-layer PinSAGE: layer-1 conv over the 2-hop block is folded
        into the neighbor features of layer 2 (standard block form).

        ego_rows [B, D]; nbr_rows1 [B, T, D] (1-hop neighbors' features);
        nbr_rows2 [B, T, T, D] (their neighbors); w* matching weights."""
        b, t, d = nbr_rows1.shape
        if self.cfg.n_layers == 2:
            flat_self = nbr_rows1.reshape(b * t, d)
            flat_nbr = nbr_rows2.reshape(b * t, t, d)
            flat_w = w2.reshape(b * t, t)
            h1 = self._conv(state["conv0"], flat_self, flat_nbr, flat_w)
            h1 = h1.reshape(b, t, d)
            ego1 = self._conv(state["conv0"], ego_rows, nbr_rows1, w1)
            return self._conv(state["conv1"], ego1, h1, w1)
        return self._conv(state["conv0"], ego_rows, nbr_rows1, w1)

    def _block_rep(self, state, feats, block):
        return self._representation(
            state, gather_rows(feats, block["ego_pos"]),
            gather_rows(feats, block["nbr1_pos"]), block["w1"],
            gather_rows(feats, block["nbr2_pos"]), block["w2"])

    def train_step(self, state: Dict, batch: Dict, lr: float
                   ) -> Tuple[Dict, torch.Tensor]:
        """Max-margin step (model.py:30-34) over (head, pos, neg) triples;
        item features come through the (possibly CAFE) embedding. Convs,
        their optimizer slots and the part's tables update in place."""
        ids = batch["ids"]          # [cap, 1] all item ids used (padded)
        raw, aux = self.part.gather(state["embed"], ids)
        conv_keys = [f"conv{li}" for li in range(self.cfg.n_layers)]
        convs = [state[k] for k in conv_keys]
        leaves = _leaves(convs)
        raw = raw.detach().requires_grad_()
        with torch.enable_grad():
            for p in leaves:
                p.requires_grad_()
            z = self._block_rep(state, raw[:, 0, :], batch)
            b3 = z.shape[0] // 3
            zh, zp, zn = z[:b3], z[b3:2 * b3], z[2 * b3:]
            pos_s = (zh * zp).sum(1)
            neg_s = (zh * zn).sum(1)
            loss = torch.clamp(neg_s - pos_s + 1.0, min=0.0).mean()
            grads = torch.autograd.grad(loss, leaves + [raw])
        for p in leaves:
            p.requires_grad_(False)
        new_state = dict(state)
        new_state["opt"] = _dense_update(convs, list(grads[:-1]),
                                         state.get("opt"), lr,
                                         self.cfg.optimizer)
        with torch.no_grad():
            new_state["embed"], _ = self.part.apply_grads(
                state["embed"], ids, grads[-1], aux, lr)
        return new_state, loss.detach()

    def build_train_step(self, lr: float, capture: bool = True):
        """The train step main_graphrec_torch calls, (state,
        *block_args(block), lr) -> (state, loss), built for `lr`
        (FixedLR). On the card, with
        `capture` and no train.step.graphrec_capture_blockers, it replays
        a CUDA graph (a GraphedStep: it owns the state it captured and
        returns it, and `loss` is a tensor the next replay overwrites);
        else it runs train_step eagerly."""
        def step(state, *block):
            return self.train_step(state, dict(zip(BLOCK_KEYS, block)), lr)

        return FixedLR(build_graphrec_step(step, self.part, self.device,
                                           carry=True, capture=capture), lr)

    def build_representation_step(self, capture: bool = True):
        """representation_step as (state, *block_args(block)) -> [S, D]:
        on the card, with `capture` and no blockers, a graphed eval step
        whose output the next replay overwrites; else eager."""
        def step(state, *block):
            return self.representation_step(state,
                                            dict(zip(BLOCK_KEYS, block)))

        return build_graphrec_step(step, self.part, self.device,
                                   carry=False, capture=capture)

    def make_block(self, sampler: RandomWalkSampler,
                   seeds: np.ndarray) -> Dict:
        """Assemble a static-shape conv block for arbitrary seed items."""
        t = sampler.top_t
        n1, w1 = sampler.sample(seeds)                  # [S, T]
        n2 = np.empty((len(seeds), t, t), dtype=np.int32)
        w2 = np.empty((len(seeds), t, t), dtype=np.float32)
        for j in range(t):
            nj, wj = sampler.sample(n1[:, j])
            n2[:, j] = nj
            w2[:, j] = wj
        return self._pack_block(seeds, n1, w1, n2, w2)

    def make_batch(self, sampler: RandomWalkSampler, batch: int) -> Dict:
        """Assemble a static-shape training block for (head, pos, neg)."""
        heads, pos, neg = sampler.pos_pairs(batch)
        seeds = np.concatenate([heads, pos, neg])  # [3B]
        return self.make_block(sampler, seeds)

    def _pack_block(self, seeds, n1, w1, n2, w2) -> Dict:
        # unique ids referenced; positions into the gathered table. Padded
        # to a fixed capacity (padding repeats uniq[0]; no position
        # references the padded lanes, so their gradients are zero and
        # updates no-ops).
        all_ids = np.concatenate(
            [seeds, n1.reshape(-1), n2.reshape(-1)]).astype(np.int32)
        uniq, inv = np.unique(all_ids, return_inverse=True)
        cap = len(all_ids)
        uniq_p = np.full(cap, uniq[0], dtype=np.int32)
        uniq_p[: len(uniq)] = uniq
        uniq = uniq_p
        s = len(seeds)
        inv = inv.reshape(-1).astype(np.int64)
        block = {
            "ids": uniq[:, None],
            "ego_pos": inv[:s],
            "nbr1_pos": inv[s:s + n1.size].reshape(n1.shape),
            "nbr2_pos": inv[s + n1.size:].reshape(n2.shape),
            "w1": w1,
            "w2": w2,
        }
        return {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
                for k, v in block.items()}

    @torch.no_grad()
    def representation_step(self, state: Dict, block: Dict) -> torch.Tensor:
        """Item representations for a block's seeds (inference)."""
        raw, _ = self.part.gather(state["embed"], block["ids"])
        return self._block_rep(state, raw[:, 0, :], block)

    def represent_items(self, state: Dict, sampler: RandomWalkSampler,
                        batch: int = 256, step=None) -> np.ndarray:
        """[n_items, D] representations of every item (evaluation.py's
        h_item), computed in fixed-shape blocks, through `step` (a
        build_representation_step; default the eager
        representation_step). Each block's output is copied out before
        the next call, which a graphed step's replay overwrites."""
        out = np.empty((self.n_items, self.cfg.hidden_dims), np.float32)
        for lo in range(0, self.n_items, batch):
            ids = np.arange(lo, min(lo + batch, self.n_items),
                            dtype=np.int32)
            pad = batch - len(ids)
            seeds = np.concatenate([ids, np.zeros(pad, np.int32)])
            block = self.make_block(sampler, seeds)
            z = (self.representation_step(state, block) if step is None
                 else step(state, *block_args(block)))
            out[lo:lo + len(ids)] = z[: len(ids)].cpu().numpy()
        return out
