"""K3 (kernels/rowsum.py) and the dense sparse-apply route against the JAX
package.

* K3's plain version against JAX `sparse_add_dense`, whose Pallas kernel
  runs here in TPU interpret mode (`force_tpu_interpret_mode`, nothing in
  the JAX package changes): Zipf duplicates, ids in [0, N+5), negative
  ids, B not a multiple of the kernel's 512-lane tile, all lanes dropped.
  Tolerance 1e-5: the Pallas kernel sums each row's lanes in a one-hot
  matmul, the port in lane order.
* The route: the port's `_use_pallas_apply` / `_use_dense_rowsum` equal
  the JAX package's over a grid of (rows, dim, lanes) and every impl,
  with the JAX package told it runs on a TPU.
* 3 whole CAFE steps with sparse_apply_impl='dense' and frequency
  scores, from one bridged state: sketch state exact, floats within the
  tolerances of tests/test_torch_train.py.
* Negative ids: every SGD arm of the port drops them.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

import cafe_tpu.ops.pallas_rowsum as jrowsum
import cafe_tpu.ops.sparse as jsparse
from cafe_tpu_torch.kernels import rowsum
from cafe_tpu_torch.ops import sparse as tsparse
from test_torch_train import SKETCH_EXACT, SMALL, _close, _run

torch.set_num_threads(1)


def _case(kind, n=1000, d=16, b=1500, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    if kind == "zipf":
        ids = (rng.random(b) ** 4 * n).astype(np.int32)
    elif kind == "past_end":
        ids = rng.integers(0, n + 5, b).astype(np.int32)
    elif kind == "negative":
        ids = rng.integers(0, n, b).astype(np.int32)
        ids[::7], ids[3::11] = -1, -5
    else:  # all_dropped
        ids = np.where(rng.random(b) < 0.5, -1, n + 7).astype(np.int32)
    upd = rng.normal(0, 0.1, (b, d)).astype(np.float32)
    return table, ids, upd


@pytest.mark.parametrize("kind,b", [("zipf", 1500), ("past_end", 1500),
                                    ("negative", 700), ("all_dropped", 300)])
def test_plain_matches_pallas_interpret(kind, b):
    table, ids, upd = _case(kind, b=b)
    assert b % jrowsum.TB != 0
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(jrowsum.sparse_add_dense(
            jnp.asarray(table), jnp.asarray(ids), jnp.asarray(upd)))
    got = rowsum.sparse_add_dense_(torch.from_numpy(table.copy()),
                                   torch.from_numpy(ids),
                                   torch.from_numpy(upd)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
    if kind == "all_dropped":
        np.testing.assert_array_equal(got, table)
    if kind == "negative":
        # the JAX package's sparse_sgd wraps -1 to the last row; K3 (and
        # the reference's dense arm) drops it
        assert (ids == -1).any()
        kept = ids[(ids >= 0) & (ids < table.shape[0])]
        untouched = np.setdiff1d(np.arange(table.shape[0]), kept)
        np.testing.assert_array_equal(got[untouched], table[untouched])


GRID = list(itertools.product(
    (1000, 27136, 98304, 1 << 20, 3232256),   # rows
    (8, 12, 16, 64, 128),                      # dim
    (512, 53248, 65536, 262144, 262145)))      # lanes


@pytest.mark.parametrize("impl", ["auto", "scatter", "pallas", "dense"])
def test_route_matches_jax(monkeypatch, impl):
    monkeypatch.setattr(jsparse, "_on_tpu", lambda: True)
    monkeypatch.setattr(jsparse, "APPLY_IMPL", impl)
    routes = set()
    for n, d, lanes in GRID:
        k2 = tsparse._use_pallas_apply(n, d, impl)
        k3 = not k2 and tsparse._use_dense_rowsum(n, d, lanes, impl)
        assert k2 == jsparse._use_pallas_apply(n, d), (n, d, lanes)
        assert k3 == (not k2 and jsparse._use_dense_rowsum(n, d, lanes)), \
            (n, d, lanes)
        routes.add((k2, k3))
    if impl == "dense":
        assert routes == {(True, False), (False, True), (False, False)}
        # the headline table takes K3, the sibling's takes K2
        assert tsparse._use_dense_rowsum(27136, 16, 53248, impl)
        assert tsparse._use_pallas_apply(3232256, 128, impl)


def test_dense_steps_match_jax(monkeypatch):
    """3 steps through the dense arm in both packages (the JAX package's
    Pallas kernel in interpret mode)."""
    monkeypatch.setattr(jsparse, "_on_tpu", lambda: True)
    monkeypatch.setattr(jsparse, "APPLY_IMPL", "dense")
    calls = {"jax": 0, "port": 0}
    j_add, t_add = jrowsum.sparse_add_dense, rowsum.sparse_add_dense_

    def j_spy(*a):
        calls["jax"] += 1
        return j_add(*a)

    def t_spy(*a):
        calls["port"] += 1
        return t_add(*a)

    monkeypatch.setattr(jrowsum, "sparse_add_dense", j_spy)
    monkeypatch.setattr(rowsum, "sparse_add_dense_", t_spy)
    with pltpu.force_tpu_interpret_mode():
        _, jout, tout, *_ = _run(dict(SMALL, sparse_apply_impl="dense"),
                                 steps=3)
    assert calls["jax"] >= 1 and calls["port"] == 3
    promotions = 0
    for i, ((js, jm), (ts, tm)) in enumerate(zip(jout, tout)):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"metric {k}, step {i}")
        promotions += jm["cafe_promotions"]
        _close(ts["params"], js["params"], 1e-5, f"step {i} params")
        np.testing.assert_allclose(ts["embed"]["part0"]["table"],
                                   js["embed"]["part0"]["table"],
                                   rtol=1e-5, atol=1e-5)
        for f in SKETCH_EXACT:
            np.testing.assert_array_equal(ts["embed"]["part0"]["sketch"][f],
                                          js["embed"]["part0"]["sketch"][f],
                                          err_msg=f"sketch {f}, step {i}")
    assert promotions > 0


@pytest.mark.parametrize("impl", ["scatter", "pallas", "dense"])
def test_every_sgd_arm_drops_negative_ids(impl):
    """The reference's sparse_sgd wraps -1 to the last row while its
    dense arm drops it; every SGD arm of the port drops it."""
    table, ids, upd = _case("negative", n=64, d=8, b=300)
    got, _ = tsparse.apply_rows(torch.from_numpy(table.copy()), {},
                                torch.from_numpy(ids), torch.from_numpy(upd),
                                1.0, "sgd", impl)
    keep = ids >= 0
    want = table.copy()
    np.add.at(want, ids[keep], -upd[keep])
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    if impl == "dense":
        assert tsparse._use_dense_rowsum(64, 8, 300, impl)
