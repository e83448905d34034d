"""K4's plain version (kernels/gather.gather_plain, and `gather` on CPU
tensors) against the JAX package's pallas_gather in interpret mode, at
tiles of 16-32 rows (interpret mode unrolls one DMA a row)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.ops.pallas_gather import pallas_gather
from cafe_tpu_torch.kernels import gather

torch.set_num_threads(1)


def _table(rng, n, d, dtype):
    if dtype == "int32":
        return rng.integers(-2**31, 2**31 - 1, (n, d)).astype(np.int32)
    return rng.normal(0, 1, (n, d)).astype(np.float32)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "int32"])
@pytest.mark.parametrize("tile,b", [(16, 64), (32, 96)])
def test_gather_plain_matches_pallas_interpret(dtype, tile, b):
    rng = np.random.default_rng(tile + b)
    n, d = 300, 16
    table = _table(rng, n, d, dtype)
    ids = rng.integers(0, n, b).astype(np.int32)
    ids[:3] = [0, n - 1, n - 1]                  # both ends, a duplicate
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table)
    if dtype == "bfloat16":
        jt = jt.astype(jnp.bfloat16)
        tt = tt.to(torch.bfloat16)
    want = pallas_gather(jt, jnp.asarray(ids), tile=tile, interpret=True)
    for fn in (gather.gather_plain, gather.gather):
        got = fn(tt, torch.from_numpy(ids), tile=tile)
        assert got.dtype == tt.dtype and got.shape == (b, d)
        # compare the bits: a row copy is exact for every dtype
        np.testing.assert_array_equal(
            got.view(torch.int16 if dtype == "bfloat16" else torch.int32
                     ).numpy(),
            np.asarray(want).view(np.int16 if dtype == "bfloat16"
                                  else np.int32))


def test_batch_not_a_multiple_of_tile_raises_in_both():
    rng = np.random.default_rng(0)
    table = _table(rng, 100, 8, "float32")
    ids = rng.integers(0, 100, 48).astype(np.int32)
    with pytest.raises(AssertionError):
        pallas_gather(jnp.asarray(table), jnp.asarray(ids), tile=32,
                      interpret=True)
    for fn in (gather.gather_plain, gather.gather):
        with pytest.raises(ValueError, match="multiple of tile"):
            fn(torch.from_numpy(table), torch.from_numpy(ids), tile=32)
        assert fn(torch.from_numpy(table), torch.from_numpy(ids),
                  tile=16).shape == (48, 8)


@pytest.mark.parametrize("bad", [-1, 100])
def test_plain_raises_on_ids_outside_the_table(bad):
    """No wrap of -1 to the last row (as table[ids] would), no clamp."""
    table = torch.arange(800, dtype=torch.float32).view(100, 8)
    ids = torch.zeros(16, dtype=torch.int32)
    ids[5] = bad
    for fn in (gather.gather_plain, gather.gather):
        with pytest.raises(IndexError, match="outside"):
            fn(table, ids, tile=16)


def test_checks_and_strided_tables():
    table = torch.arange(600, dtype=torch.float32).view(60, 10)
    with pytest.raises(TypeError, match="int32"):
        gather.gather(table, torch.zeros(16, dtype=torch.int64), tile=16)
    with pytest.raises(ValueError, match="table"):
        gather.gather(table[0], torch.zeros(16, dtype=torch.int32), tile=16)
    ids = torch.tensor([59, 0, 7, 7], dtype=torch.int32)
    for view in (table[:, 1:], table[:, ::2], table[::2]):
        got = gather.gather(view, ids % view.shape[0], tile=4)
        assert torch.equal(got, view[(ids % view.shape[0]).long()])


def test_vector_bytes_is_the_widest_common_unit():
    assert gather.vector_bytes(512, 512, 4096, 8192) == 16
    assert gather.vector_bytes(516, 516, 4096, 8192) == 4
    assert gather.vector_bytes(512, 512, 4100, 8192) == 4
    assert gather.vector_bytes(130, 130, 4096, 8192) == 1
    assert gather.vector_bytes(512, 512, 4098, 8192) == 1


def test_cpu_tensors_never_launch_the_kernel():
    before = gather.KERNEL.launches
    table = torch.randn(64, 8, generator=torch.Generator().manual_seed(0))
    ids = torch.arange(32, dtype=torch.int32)
    assert torch.equal(gather.gather(table, ids, tile=16), table[:32])
    assert gather.KERNEL.launches == before
