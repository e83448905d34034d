"""AutoEncoder embedding baseline (port of cafe_tpu/embeddings/ae.py).

Per field a reduced-dim table (MDE's dim assignment) with a projection
back to the base dim, and a decoder fc1 (base -> low) / fc2 (low ->
vocab) that reconstructs the one-hot id. The autoencoders are pretrained
on the first 0.001 % of batches with SGD at lr 0.1 (`pretrain_step`,
train/loop.run); the main run serves the embeddings FROZEN.

Pretraining materialises [batch, fields, max vocab] logits, as the
reference does, so its memory grows with the vocabulary:
--max_ind_range bounds it.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from .base import Part, _offsets, round_up

AE_LR = 0.1
PRETRAIN_FRACTION = 1e-5


class AEGroupPart(Part):
    """Fields sharing one reduced dim; embeddings frozen after
    pretraining. Whole on every rank under --shard_exchange auto too: the
    pretraining differentiates through the table itself."""

    auto_shardable = False

    def __init__(self, field_idx: List[int], counts: List[int],
                 low_dim: int, base_dim: int, optimizer: str = "sgd"):
        self.field_idx = list(field_idx)
        self.counts = [int(c) for c in counts]
        self.low_dim = int(low_dim)
        self.dim = base_dim
        self.optimizer = optimizer
        self.np_offsets = _offsets(self.counts)
        self.max_n = max(self.counts)

    def init(self, rng: np.random.Generator) -> Dict:
        f = len(self.field_idx)
        table = np.zeros((round_up(int(sum(self.counts))), self.low_dim),
                         dtype=np.float32)
        lo = 0
        for n in self.counts:
            scale = np.sqrt(1.0 / n)
            table[lo:lo + n] = rng.uniform(
                -scale, scale, size=(n, self.low_dim)).astype(np.float32)
            lo += n

        def xav(shape):
            bound = np.sqrt(6.0 / (shape[-2] + shape[-1]))
            return rng.uniform(-bound, bound, size=shape).astype(np.float32)

        state = {
            "table": table,
            # per-field dense pieces, stacked on a leading field axis
            "proj_w": xav((f, self.low_dim, self.dim)),
            "proj_b": np.zeros((f, self.dim), np.float32),
            "fc1_w": xav((f, self.dim, self.low_dim)),
            "fc1_b": np.zeros((f, self.low_dim), np.float32),
            # fc2 maps low -> vocab, padded to the largest field's vocab
            "fc2_w": xav((f, self.low_dim, self.max_n)),
            "fc2_b": np.zeros((f, self.max_n), np.float32),
        }
        return {k: torch.from_numpy(v).to(self.device)
                for k, v in state.items()}

    def _embed(self, state, ids):
        flat = ids + self._const("np_offsets")
        low = state["table"][flat.long()]                  # [B, F, low]
        if self.low_dim == self.dim:
            return low, flat
        return (torch.einsum("bfd,fde->bfe", low, state["proj_w"])
                + state["proj_b"][None]), flat

    def gather(self, state: Dict, ids: torch.Tensor):
        raw, flat = self._embed(state, ids)
        return raw.detach(), flat   # frozen: no gradient reaches the table

    def apply_grads(self, state, ids, g_raw, aux, lr):
        return state, {}

    def quantize_for_serving(self, state: Dict, bits: int) -> Dict:
        return {"table": self._quantize(state["table"], bits)}

    def gather_quantized(self, state: Dict, qt: Dict, ids: torch.Tensor):
        """The low-dim rows dequantized, then the f32 projection."""
        low = self._dequantize(qt["table"], ids + self._const("np_offsets"))
        if self.low_dim == self.dim:
            return low
        return (torch.einsum("bfd,fde->bfe", low, state["proj_w"])
                + state["proj_b"][None])

    def _vocab_mask(self) -> torch.Tensor:
        """[F, max_n] f32: 1 inside each field's own vocabulary."""
        cache = self.__dict__.setdefault("_consts", {})
        if "vocab_mask" not in cache:
            mask = (np.arange(self.max_n)[None, :]
                    < np.asarray(self.counts)[:, None])
            cache["vocab_mask"] = torch.as_tensor(
                mask, dtype=torch.float32, device=self.device)
        return cache["vocab_mask"]

    def pretrain_step(self, state: Dict, ids: torch.Tensor) -> Dict:
        """One reconstruction step: per field the squared error between
        fc2(fc1(proj(emb))) and the one-hot id, masked to the field's
        vocabulary, summed and divided by the batch; SGD at AE_LR on every
        AE tensor the loss reaches (updated in place once all gradients
        are taken)."""
        b = ids.shape[0]
        leaves = {k: v.detach().requires_grad_() for k, v in state.items()}
        with torch.enable_grad():
            emb, _ = self._embed(leaves, ids)                 # [B, F, D]
            h = (torch.einsum("bfe,fed->bfd", emb, leaves["fc1_w"])
                 + leaves["fc1_b"][None])
            v = (torch.einsum("bfd,fdn->bfn", h, leaves["fc2_w"])
                 + leaves["fc2_b"][None])                     # [B, F, N]
            # (v - onehot) * mask, the one-hot subtracted by a scatter
            # (every id lies inside its field's vocabulary)
            diff = (v * self._vocab_mask()[None]).scatter_add(
                -1, ids.long()[..., None],
                torch.full(ids.shape + (1,), -1.0, device=v.device))
            loss = (diff * diff).sum() / b
            # a group at the base dim has no projection: no gradient
            grads = torch.autograd.grad(loss, list(leaves.values()),
                                        allow_unused=True)
        with torch.no_grad():
            for p, g in zip(state.values(), grads):
                if g is not None:
                    p.sub_(AE_LR * g)
        return state


def pretrain_batches(nbatches: int) -> int:
    return max(1, int(nbatches * PRETRAIN_FRACTION))
