"""Deep & Cross Network towers (port of cafe_tpu/models/dcn.py).

Three cross layers x1 <- x0 * (x1 @ w) + b (no residual term, as the
reference), a deep tower [in, 256, 256, 256] with a sigmoid on its last
layer, and a last linear on [deep | cross] with a sigmoid. Matmuls follow
models/mlp.mm's precision policy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .mlp import apply_mlp, init_mlp, mm


class DCN:
    name = "dcn"
    cross_layer_n = 3

    def __init__(self, embedding_dim: int, num_sparse: int, num_dense: int,
                 ln_bot=None, ln_top=None, compute_dtype=torch.float32,
                 device="cuda"):
        self.embedding_dim = embedding_dim
        self.num_sparse = num_sparse
        self.num_dense = num_dense
        self.input_dim = embedding_dim * num_sparse + num_dense
        self.ln_top = [self.input_dim, 256, 256, 256]
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)

    def init(self, seed: int):
        """Params from a torch.Generator with the JAX init's
        distributions: cross weights N(0, 1e-4) and zero biases, the last
        linear U(-1/sqrt(in), 1/sqrt(in)), the deep tower as init_mlp."""
        gen = torch.Generator().manual_seed(int(seed))
        dev = self.device
        cross = [{"w": (torch.randn((self.input_dim, 1), generator=gen)
                        * 1e-4).to(dev),
                  "b": torch.zeros((self.input_dim,), device=dev)}
                 for _ in range(self.cross_layer_n)]
        last_in = self.input_dim + 256
        bound = 1.0 / float(np.sqrt(last_in))
        last = {k: ((torch.rand(shape, generator=gen) * 2 - 1)
                    * bound).to(dev)
                for k, shape in (("w", (last_in, 1)), ("b", (1,)))}
        return {"top": init_mlp(gen, self.ln_top, dev), "cross": cross,
                "last": last}

    def apply(self, params, dense, feats):
        """dense: [B, num_dense] | None; feats: [B, F, D] -> prob [B]."""
        x0 = feats.reshape(feats.shape[0], -1)
        if dense is not None:
            x0 = torch.cat([dense, x0], dim=1)
        deep = apply_mlp(params["top"], x0, sigmoid_layer=len(self.ln_top) - 2,
                         compute_dtype=self.compute_dtype)
        x1 = x0
        for layer in params["cross"]:
            x1 = x0 * mm(x1, layer["w"], self.compute_dtype) + layer["b"]
        out = mm(torch.cat([deep, x1], dim=1), params["last"]["w"],
                 self.compute_dtype) + params["last"]["b"]
        return torch.sigmoid(out)[:, 0]
