"""DLRM dense towers (port of cafe_tpu/models/dlrm.py).

Bottom MLP on dense features, dot-product feature interaction (the upper
triangle of T @ T^T, picked with a fixed index list built from the JAX
package's static mask), top MLP with a sigmoid output. Legacy options as
in the JAX package: interaction_op "cat", interaction_itself (keep the
diagonal), loss_threshold (clamp p to [t, 1-t]). `device` defaults to the
card and raises without CUDA unless it is "cpu".
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .mlp import apply_mlp, init_mlp, mm


class DLRM:
    name = "dlrm"

    def __init__(self, embedding_dim: int, num_sparse: int, num_dense: int,
                 ln_bot, ln_top, compute_dtype=torch.float32,
                 interaction_op: str = "dot",
                 interaction_itself: bool = False,
                 loss_threshold: float = 0.0, device="cuda"):
        self.embedding_dim = embedding_dim
        self.num_sparse = num_sparse
        self.num_dense = num_dense
        self.ln_bot = list(ln_bot)
        self.ln_top = list(ln_top)
        self.compute_dtype = compute_dtype
        assert interaction_op in ("dot", "cat"), interaction_op
        self.interaction_op = interaction_op
        self.loss_threshold = float(loss_threshold)
        self.device = resolve_device(device)
        nf = num_sparse + (1 if num_dense > 0 else 0)
        k = 0 if interaction_itself else 1
        mask = np.triu(np.ones((nf, nf), bool), k=k).reshape(-1)
        self._triu = torch.as_tensor(np.nonzero(mask)[0], device=self.device)

    def init(self, seed: int):
        """Params from a torch.Generator (distributions of the JAX init,
        not its numbers — bridge.py carries the JAX numbers over)."""
        gen = torch.Generator().manual_seed(int(seed))
        params = {"top": init_mlp(gen, self.ln_top, self.device)}
        if self.num_dense > 0:
            params["bot"] = init_mlp(gen, self.ln_bot, self.device)
        return params

    def interact(self, x, feats):
        # feats: [B, F, D]; x: [B, D] bottom-MLP output or None
        if self.interaction_op == "cat":
            r = feats.reshape(feats.shape[0], -1)
            if x is not None:
                r = torch.cat([x, r], dim=1)
            return r
        t = feats if x is None else torch.cat([x[:, None, :], feats], dim=1)
        z = mm(t, t.transpose(1, 2), self.compute_dtype)
        r = z.reshape(z.shape[0], -1)[:, self._triu]
        if x is not None:
            r = torch.cat([x, r], dim=1)
        return r

    def apply(self, params, dense, feats):
        """dense: [B, num_dense] | None; feats: [B, F, D] -> prob [B]."""
        x = None
        if dense is not None:
            x = apply_mlp(params["bot"], dense,
                          compute_dtype=self.compute_dtype)
        r = self.interact(x, feats)
        out = apply_mlp(params["top"], r,
                        sigmoid_layer=len(self.ln_top) - 2,
                        compute_dtype=self.compute_dtype)
        p = out[:, 0]
        if 0.0 < self.loss_threshold < 1.0:
            p = p.clamp(self.loss_threshold, 1.0 - self.loss_threshold)
        return p
