"""LightGCN with optional CAFE-compressed node embeddings (port of
cafe_tpu/models/graphrec/lightgcn.py).

The node-id table (users then items, one unified id space) is a CAFE
hot/hash pair behind the v1 HotSketch when compress_rate < 1, else a full
HashedTablePart; the sizing, the init draws and the BPR step are the JAX
package's. Propagation gathers each edge's source row and sums the
messages by destination through ops/sparse.segment_rows (the JAX
package's XLA segment_sum; kernel K3 on the card), and the gather's
backward sums through segment_rows too (ops/sparse.gather_rows), so the
step's sums run in a fixed order, as XLA's do, and two runs from one
state repeat bit for bit; the part's apply coalesces its duplicate rows
the same way (Part.deterministic_sums).

One BPR step gathers all n_nodes rows through the part, runs autograd
through propagate, the softplus BPR loss and the ego L2 term, and hands
the full [n_nodes, 1, d] gradient to the part's apply_grads, which
inserts into the sketch and updates the rows (rows-Adam by default).
The insert lands through kernel K1 (land_impl 'auto', the CTR path's
default): the JAX package's graphrec parts keep CafePart's 'segmax'
default, XLA's segment_max, which lands the same values. The step reads
nothing back to the host and makes no shape from the data (every node
row each step, the rows-Adam / Adagrad apply on fixed-shape rows), so
on the card `build_step` replays it as a CUDA graph, the port's
counterpart of `jit_step` (train/capture.py); on the CPU it runs
eagerly. Scoring and recall@k stay eager, as the JAX package does not
jit them either.

Evaluation scores users in chunks on the device, masks each user's train
items and takes the top k there, so the [users x items] score matrix
(4.9 GB in f32 at Gowalla's size) is never whole.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ...device import resolve_device
from ...embeddings.base import HashedTablePart
from ...embeddings.cafe import CafePart
from ...ops.sparse import gather_rows, segment_rows
from ...train.step import build_graphrec_step


class Graph(NamedTuple):
    src: np.ndarray     # int32 [E*2] (bidirected, user/item unified space)
    dst: np.ndarray     # int32 [E*2]
    w: np.ndarray       # f32   [E*2] 1/sqrt(deg_src*deg_dst)
    n_users: int
    n_items: int


def build_bipartite_graph(users: np.ndarray, items: np.ndarray,
                          n_users: int, n_items: int) -> Graph:
    """Symmetric-normalized bidirected interaction graph; item ids offset by
    n_users into the unified node space (model.py's getSparseGraph)."""
    u = np.asarray(users, dtype=np.int64)
    i = np.asarray(items, dtype=np.int64) + n_users
    src = np.concatenate([u, i]).astype(np.int32)
    dst = np.concatenate([i, u]).astype(np.int32)
    n = n_users + n_items
    deg = np.bincount(src, minlength=n).astype(np.float64)
    deg[deg == 0] = 1.0
    w = (1.0 / np.sqrt(deg[src] * deg[dst])).astype(np.float32)
    return Graph(src, dst, w, n_users, n_items)


@dataclasses.dataclass
class LightGCNConfig:
    latent_dim: int = 64
    n_layers: int = 3
    lr: float = 0.001
    weight_decay: float = 1e-4   # BPR reg coefficient
    compress_rate: float = 1.0   # 1.0 = full table
    hot_rate: float = 0.7        # world.py:49 (CAFE share going to hot)
    sketch_threshold: float = 500.0
    sketch_decay: float = 0.99
    seed: int = 0
    # the reference trains with Adam (LightGCN/code/utils.py:39, lr 0.001
    # per world.py); rows-Adam (ops/sparse.py) is the sparse-table form.
    # sgd/adagrad kept for ablations.
    optimizer: str = "adam"      # sgd | adagrad | adam


# users scored per chunk in recall_at_k: [chunk, n_items] f32 scores
EVAL_CHUNK = 4096


class LightGCN:
    def __init__(self, cfg: LightGCNConfig, graph: Graph, device="cuda"):
        self.cfg = cfg
        self.graph = graph
        self.device = resolve_device(device)
        self.n_nodes = graph.n_users + graph.n_items
        d = cfg.latent_dim
        if cfg.compress_rate < 1.0:
            size = int(self.n_nodes * cfg.compress_rate)
            hotn = max(int(size * cfg.hot_rate * d / (d + 12)), 2)
            hash_size = max(size - hotn, 1)
            self.part = CafePart(
                [0], [self.n_nodes], [0], hotn, [hash_size], d,
                cfg.sketch_threshold, cfg.sketch_decay, self.n_nodes,
                optimizer=cfg.optimizer, land_impl="auto")
        else:
            self.part = HashedTablePart([0], [self.n_nodes],
                                        [self.n_nodes], d,
                                        optimizer=cfg.optimizer)
        self.part.device = self.device
        self.part.deterministic_sums = True

        def dev(a, dtype):
            return torch.from_numpy(np.asarray(a)).to(self.device, dtype)

        self._src = dev(graph.src, torch.int64)
        self._dst = dev(graph.dst, torch.int64)
        self._w = dev(graph.w, torch.float32)[:, None]
        self._ids = torch.arange(self.n_nodes, dtype=torch.int32,
                                 device=self.device)[:, None]

    def init(self) -> dict:
        rng = np.random.default_rng(self.cfg.seed)
        state = self.part.init(rng)
        # reference init: normal(std=0.1) on the node embedding
        # (model.py:111-117), drawn after the part's own draws
        state["table"] = torch.from_numpy(
            rng.normal(0.0, 0.1, tuple(state["table"].shape))
            .astype(np.float32)).to(self.device)
        return state

    # -- propagation (model.py:129-161) --------------------------------
    def propagate(self, emb0: torch.Tensor) -> torch.Tensor:
        out = emb0
        acc = emb0
        for _ in range(self.cfg.n_layers):
            msgs = gather_rows(out, self._src) * self._w
            out = segment_rows(msgs, self._dst, self.n_nodes)
            acc = acc + out
        return acc / (self.cfg.n_layers + 1)

    def _table(self, state) -> Tuple[torch.Tensor, tuple]:
        raw, aux = self.part.gather(state, self._ids)
        return raw[:, 0, :], aux

    def _on(self, x) -> torch.Tensor:
        """x as an int64 tensor on the model's device (a device int64
        tensor as it is)."""
        return torch.as_tensor(np.asarray(x) if not isinstance(
            x, torch.Tensor) else x).to(self.device, torch.int64)

    def bpr_step(self, state: dict, users, pos, neg
                 ) -> Tuple[dict, torch.Tensor]:
        """One BPR update (model.py:181-196) with CAFE bookkeeping; the
        part's tables are updated in place. Returns (state, loss)."""
        cfg = self.cfg
        users = self._on(users)
        pos_n = self._on(pos) + self.graph.n_users
        neg_n = self._on(neg) + self.graph.n_users

        raw, aux = self._table(state)
        emb0 = raw.detach().requires_grad_()
        with torch.enable_grad():
            light = self.propagate(emb0)
            ue, pe, ne = light[users], light[pos_n], light[neg_n]
            pos_s = (ue * pe).sum(1)
            neg_s = (ue * ne).sum(1)
            loss = F.softplus(neg_s - pos_s).mean()
            ego = torch.cat([emb0[users], emb0[pos_n], emb0[neg_n]])
            reg = 0.5 * (ego * ego).sum() / users.shape[0]
            loss = loss + cfg.weight_decay * reg
            g, = torch.autograd.grad(loss, emb0)
        with torch.no_grad():
            state, _ = self.part.apply_grads(state, self._ids, g[:, None, :],
                                             aux, cfg.lr)
        return state, loss.detach()

    def build_step(self, capture: bool = True):
        """The BPR step main_graphrec_torch calls, (state, users, pos,
        neg) -> (state, loss) with the batch as int64 device tensors: the
        port's
        `jit_step`. On the card, with `capture` and no
        train.step.graphrec_capture_blockers, a GraphedStep (it owns the
        state it captured and returns it, and `loss` is a tensor the next
        replay overwrites); else the eager bpr_step."""
        return build_graphrec_step(self.bpr_step, self.part, self.device,
                                   carry=True, capture=capture)

    # -- evaluation -----------------------------------------------------
    @torch.no_grad()
    def _light(self, state) -> torch.Tensor:
        return self.propagate(self._table(state)[0])

    @torch.no_grad()
    def scores(self, state: dict, users: np.ndarray) -> torch.Tensor:
        light = self._light(state)
        return light[self._on(users)] @ light[self.graph.n_users:].T

    @torch.no_grad()
    def recall_at_k(self, state: dict, train_pos, test_pos,
                    k: int = 20) -> float:
        """recall@k / users with test interactions, train items masked;
        users scored EVAL_CHUNK at a time on the device."""
        users = np.array([u for u in range(self.graph.n_users)
                          if len(test_pos[u]) > 0])
        if len(users) == 0:
            return 0.0
        light = self._light(state)
        items = light[self.graph.n_users:]
        n_items = items.shape[0]
        kk = min(k, n_items)
        total = torch.zeros((), dtype=torch.float64, device=self.device)
        for lo in range(0, len(users), EVAL_CHUNK):
            chunk = users[lo:lo + EVAL_CHUNK]
            s = light[self._on(chunk)] @ items.T
            s[self._on(_rows_of(train_pos, chunk)),
              self._on(np.concatenate([train_pos[u] for u in chunk]))] = -1e9
            top = torch.topk(s, kk, dim=1).indices
            test = torch.zeros_like(s, dtype=torch.bool)
            test[self._on(_rows_of(test_pos, chunk)),
                 self._on(np.concatenate([test_pos[u] for u in chunk]))] = True
            hits = test.gather(1, top).sum(1, dtype=torch.float64)
            denom = torch.from_numpy(np.minimum(
                [len(test_pos[u]) for u in chunk], k).astype(np.float64))
            total += (hits / denom.to(self.device)).sum()
        return float(total) / len(users)


def _rows_of(pos_lists, users) -> np.ndarray:
    """For each user of `users` (row r), r repeated once per item."""
    return np.repeat(np.arange(len(users)),
                     [len(pos_lists[u]) for u in users])
