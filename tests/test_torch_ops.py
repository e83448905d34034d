"""Port ops and kernels' plain versions against the JAX package.

K1 (kernels/land.py) against JAX land_max(impl='segmax') and the numpy
oracle of tests/test_pallas_land.py — bit-equal. K2 (kernels/
scatter_add.py) against pallas_scatter_add in interpret mode (duplicates
within a tile, as tests/test_pallas_apply.py runs it) and against
sparse_sgd for duplicates across the whole batch — f32, 1e-6 relative.
The kernels themselves run only on the card (tests/test_torch_kernels.py).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cafe_tpu.ops import sorted_update as jsu
from cafe_tpu.ops.pallas_apply import pallas_scatter_add
from cafe_tpu.ops.sparse import sparse_sgd
from cafe_tpu_torch.kernels import gather, land, scatter_add
from cafe_tpu_torch.ops import sorted_update as tsu
from cafe_tpu_torch.ops.sparse import apply_rows
from test_torch_kernels import LAND_CASES, _land_case, _oracle_add

torch.set_num_threads(1)


@pytest.mark.parametrize("b,c,n,kind", LAND_CASES)
def test_land_max_plain_bit_equal(b, c, n, kind):
    keys, enc, want = _land_case(b + n, b, c, n, kind)
    jx = np.asarray(jsu.land_max(jnp.asarray(enc), jnp.asarray(keys), n,
                                 "segmax"))
    tk, te = torch.from_numpy(keys), torch.from_numpy(enc)
    np.testing.assert_array_equal(jx, want)
    for got in (land.land_max_plain(te, tk, n), land.land_max(te, tk, n),
                tsu.land_max(te, tk, n, "auto"),
                tsu.land_max(te, tk, n, "segmax")):
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("n,d,b,tile", [(192, 128, 176, 64)])
def test_scatter_add_plain_vs_pallas_interpret(n, d, b, tile):
    rng = np.random.default_rng(n + b)
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    nt = -(-b // tile)
    per = n // nt
    ids = np.concatenate([rng.integers(t * per, (t + 1) * per, tile)
                          for t in range(nt)])[:b].astype(np.int32)
    ids[::9] = n + 5                      # dropped lanes
    upd = rng.normal(0, 0.1, (b, d)).astype(np.float32)
    jx = np.asarray(pallas_scatter_add(jnp.asarray(table), jnp.asarray(ids),
                                       jnp.asarray(upd), tile=tile,
                                       interpret=True))
    got = scatter_add.scatter_add_(torch.from_numpy(table.copy()),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(upd)).numpy()
    np.testing.assert_allclose(got, jx, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(got, _oracle_add(table, ids, upd),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("impl", ["pallas", "scatter"])
def test_apply_rows_vs_sparse_sgd_cross_tile(impl):
    """Duplicate groups spread over the whole batch (the case the Pallas
    interpreter cannot run), through both apply_rows arms."""
    rng = np.random.default_rng(3)
    n, d, b, lr = 300, 32, 2048, 0.5
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    ids = rng.integers(0, n, b).astype(np.int32)
    ids[rng.permutation(b)[:600]] = 17    # one 600-lane group, all tiles
    ids[::13] = n + 1                     # dropped lanes
    grad = rng.normal(0, 1, (b, d)).astype(np.float32)
    jx = np.asarray(sparse_sgd(jnp.asarray(table), jnp.asarray(ids),
                               jnp.asarray(grad), lr))
    got, slots = apply_rows(torch.from_numpy(table.copy()),
                            {}, torch.from_numpy(ids),
                            torch.from_numpy(grad), lr, "sgd", impl)
    assert slots == {}
    # sums of up to 600 terms of |lr * g| <~ 2: f32 reordering stays
    # well inside 1e-6 relative of the group's magnitude
    np.testing.assert_allclose(got.numpy(), jx, rtol=1e-6, atol=2e-5)


def test_seg_max_and_seg_sum_vs_jax():
    rng = np.random.default_rng(4)
    keys = np.sort(rng.integers(0, 60, 500)).astype(np.int32)
    ivals = rng.integers(-1000, 1000, (500, 3)).astype(np.int32)
    fvals = rng.normal(0, 1, (500, 3)).astype(np.float32)
    tk = torch.from_numpy(keys)
    for vals in (ivals, fvals):
        jx = np.asarray(jsu.seg_max(jnp.asarray(vals), jnp.asarray(keys), 50))
        got = tsu.seg_max(torch.from_numpy(vals), tk, 50).numpy()
        np.testing.assert_array_equal(got, jx)
    jx = np.asarray(jsu.seg_sum(jnp.asarray(fvals), jnp.asarray(keys), 50))
    got = tsu.seg_sum(torch.from_numpy(fvals), tk, 50).numpy()
    np.testing.assert_allclose(got, jx, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("k", [1, 40, 200])
def test_compact_mask_vs_jax(k):
    rng = np.random.default_rng(k)
    mask = rng.random(200) < 0.3
    jpos, jvalid = jsu.compact_mask(jnp.asarray(mask), k)
    pos, valid = tsu.compact_mask(torch.from_numpy(mask), k)
    np.testing.assert_array_equal(pos.numpy(), np.asarray(jpos))
    np.testing.assert_array_equal(valid.numpy(), np.asarray(jvalid))


def test_wrappers_refuse_other_devices():
    """No silent fallback: a tensor that is neither on the CPU nor on a
    CUDA card is refused, never routed to the plain version."""
    enc = torch.zeros((4, 2), dtype=torch.int32, device="meta")
    keys = torch.zeros(4, dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        land.land_max(enc, keys, 3)
    table = torch.zeros((4, 2), device="meta")
    with pytest.raises(ValueError):
        scatter_add.scatter_add_(table, keys, torch.zeros((4, 2),
                                                          device="meta"))
    with pytest.raises(ValueError):
        gather.gather(table, keys, tile=4)
    with pytest.raises(ValueError, match="unknown"):
        tsu.land_max(enc, keys, 3, "nope")


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("table_pass", [True, False])
def test_apply_rows_adagrad_adam_vs_jax(optimizer, table_pass):
    """Coalesce-first Adagrad / rows-Adam through both arms (table pass
    and per-row), two steps so the slots carry state; duplicates and
    dropped lanes included."""
    from cafe_tpu.ops.sparse import apply_rows as japply, init_slots as jinit
    from cafe_tpu_torch.ops.sparse import init_slots
    rng = np.random.default_rng(6)
    n, d, b, lr = 200, 16, 600, 0.05
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    jt, js = jnp.asarray(table), jinit(jnp.asarray(table), optimizer)
    tt = torch.from_numpy(table.copy())
    ts = init_slots(tt, optimizer)
    for _ in range(2):
        ids = rng.integers(0, n, b).astype(np.int32)
        ids[::17] = n + 3
        grad = rng.normal(0, 1, (b, d)).astype(np.float32)
        jt, js = japply(jt, js, jnp.asarray(ids), jnp.asarray(grad), lr,
                        optimizer, table_pass=table_pass)
        tt, ts = apply_rows(tt, ts, torch.from_numpy(ids),
                            torch.from_numpy(grad), lr, optimizer,
                            table_pass=table_pass)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-5,
                               atol=1e-6)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
