"""MLP with the reference's initialization (port of cafe_tpu/models/mlp.py).

Weights ~ N(0, sqrt(2/(m+n))), biases ~ N(0, sqrt(1/m)), ReLU between
layers, sigmoid at `sigmoid_layer`. Params are a list of {"w", "b"} f32
tensors (the JAX pytree's layout: w is [n_in, n_out]).

The JAX package initialises from `jax.random`, which torch cannot
reproduce: `init_mlp` draws the same distributions from a torch.Generator,
and runs that must match the JAX package bring its params over with
bridge.py.

Matmuls follow the JAX package's precision policy: operands rounded to
`compute_dtype` (bf16 in the headline config), products accumulated and
returned in f32, f32 bias. bf16 x bf16 products are exact in f32, so
rounding the operands and multiplying in f32 is that policy; a bf16
torch.matmul would round its output to bf16 as well.
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np
import torch

from ..device import resolve_device


def init_mlp(gen: torch.Generator, ln: Sequence[int], device="cuda"
             ) -> List[dict]:
    """Params on `device` (default the card; raises without CUDA unless
    device='cpu')."""
    device = resolve_device(device)
    params = []
    ln = list(ln)
    for i in range(len(ln) - 1):
        n, m = int(ln[i]), int(ln[i + 1])
        w = torch.randn((n, m), generator=gen) * np.sqrt(2.0 / (m + n))
        b = torch.randn((m,), generator=gen) * np.sqrt(1.0 / m)
        params.append({"w": w.float().to(device), "b": b.float().to(device)})
    return params


def mm(x: torch.Tensor, w: torch.Tensor, compute_dtype) -> torch.Tensor:
    """x @ w with operands rounded to compute_dtype, f32 accumulate and
    f32 result (jnp.dot(..., preferred_element_type=f32))."""
    if compute_dtype != torch.float32:
        x = x.to(compute_dtype).float()
        w = w.to(compute_dtype).float()
    return x @ w


def apply_mlp(params: List[dict], x: torch.Tensor, sigmoid_layer: int = -1,
              compute_dtype=torch.float32) -> torch.Tensor:
    for i, layer in enumerate(params):
        x = mm(x, layer["w"], compute_dtype) + layer["b"]
        x = torch.sigmoid(x) if i == sigmoid_layer else torch.relu(x)
    return x
