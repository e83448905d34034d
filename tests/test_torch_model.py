"""MLP and DLRM towers of the port against the JAX package, from the same
(bridged) params and inputs.

Tolerances: f32 towers 1e-5 (the two CPU matmul libraries sum in other
orders, ~1e-7 relative per product). bf16 towers round their operands to
bf16 at every layer; a last-bit difference before a rounding moves a
value by one bf16 ulp (2^-8 relative), so they get 2e-2 absolute on
outputs in [0, 1].
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from cafe_tpu.models.dlrm import DLRM as JDLRM
from cafe_tpu.models.mlp import apply_mlp as japply, init_mlp as jinit
from cafe_tpu_torch.bridge import to_torch
from cafe_tpu_torch.models.dlrm import DLRM as TDLRM
from cafe_tpu_torch.models.mlp import apply_mlp as tapply

torch.set_num_threads(1)


@pytest.mark.parametrize("sigmoid_layer", [-1, 2])
def test_mlp_f32_matches(sigmoid_layer):
    params = jinit(jax.random.PRNGKey(0), [13, 32, 16, 4])
    x = np.random.default_rng(0).normal(0, 1, (64, 13)).astype(np.float32)
    want = np.asarray(japply(params, jnp.asarray(x), sigmoid_layer))
    got = tapply(to_torch(params, "cpu"), torch.from_numpy(x),
                 sigmoid_layer).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)


def _dlrm_pair(dtype, **kw):
    ln_bot, ln_top = [4, 16, 8], [8 + 15, 16, 1]   # 5 fields + bottom
    j = JDLRM(8, 5, 4, ln_bot, ln_top,
              compute_dtype=jnp.bfloat16 if dtype == "bf16" else jnp.float32,
              **kw)
    t = TDLRM(8, 5, 4, ln_bot, ln_top,
              compute_dtype=torch.bfloat16 if dtype == "bf16"
              else torch.float32, device="cpu", **kw)
    return j, t


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_dlrm_forward_matches(dtype, tol):
    j, t = _dlrm_pair(dtype)
    params = j.init(jax.random.PRNGKey(1))
    rng = np.random.default_rng(1)
    dense = rng.normal(0, 1, (64, 4)).astype(np.float32)
    feats = rng.normal(0, 0.3, (64, 5, 8)).astype(np.float32)
    want = np.asarray(j.apply(params, jnp.asarray(dense), jnp.asarray(feats)))
    got = t.apply(to_torch(params, "cpu"), torch.from_numpy(dense),
                  torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


def test_dlrm_cat_interaction_and_clamp():
    ln_bot, ln_top = [4, 16, 8], [8 + 5 * 8, 16, 1]
    kw = dict(interaction_op="cat", loss_threshold=0.3)
    j = JDLRM(8, 5, 4, ln_bot, ln_top, **kw)
    t = TDLRM(8, 5, 4, ln_bot, ln_top, device="cpu", **kw)
    params = j.init(jax.random.PRNGKey(2))
    rng = np.random.default_rng(2)
    dense = rng.normal(0, 1, (32, 4)).astype(np.float32)
    feats = rng.normal(0, 0.3, (32, 5, 8)).astype(np.float32)
    want = np.asarray(j.apply(params, jnp.asarray(dense), jnp.asarray(feats)))
    got = t.apply(to_torch(params, "cpu"), torch.from_numpy(dense),
                  torch.from_numpy(feats)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    assert got.min() >= 0.3 - 1e-7 and got.max() <= 0.7 + 1e-7
