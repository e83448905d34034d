"""Wide & Deep towers (port of cafe_tpu/models/wdl.py).

A deep tower [in, 256, 256, 1] whose last layer is already sigmoided,
summed with a wide linear and sigmoided again: the reference's double
sigmoid, kept. Matmuls follow models/mlp.mm's precision policy.
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import resolve_device
from .mlp import apply_mlp, init_mlp, mm


class WDL:
    name = "wdl"

    def __init__(self, embedding_dim: int, num_sparse: int, num_dense: int,
                 ln_bot=None, ln_top=None, compute_dtype=torch.float32,
                 device="cuda"):
        self.embedding_dim = embedding_dim
        self.num_sparse = num_sparse
        self.num_dense = num_dense
        self.input_dim = embedding_dim * num_sparse + num_dense
        self.ln_top = [self.input_dim, 256, 256, 1]
        self.compute_dtype = compute_dtype
        self.device = resolve_device(device)

    def init(self, seed: int):
        """Params from a torch.Generator with the JAX init's
        distributions: the wide weight N(0, 1e-4), its bias
        U(-1/sqrt(in), 1/sqrt(in)), the deep tower as init_mlp."""
        gen = torch.Generator().manual_seed(int(seed))
        wide_w = torch.randn((self.input_dim, 1), generator=gen) * 1e-4
        bound = 1.0 / float(np.sqrt(self.input_dim))
        wide_b = (torch.rand((1,), generator=gen) * 2 - 1) * bound
        return {"top": init_mlp(gen, self.ln_top, self.device),
                "wide": {"w": wide_w.to(self.device),
                         "b": wide_b.to(self.device)}}

    def apply(self, params, dense, feats):
        """dense: [B, num_dense] | None; feats: [B, F, D] -> prob [B]."""
        x = feats.reshape(feats.shape[0], -1)
        if dense is not None:
            x = torch.cat([dense, x], dim=1)
        deep = apply_mlp(params["top"], x, sigmoid_layer=len(self.ln_top) - 2,
                         compute_dtype=self.compute_dtype)
        wide = mm(x, params["wide"]["w"], self.compute_dtype) \
            + params["wide"]["b"]
        return torch.sigmoid(deep + wide)[:, 0]
