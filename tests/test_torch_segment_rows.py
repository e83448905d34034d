"""ops/sparse.segment_rows (kernel K3's plain version on the CPU),
ops/sparse.gather_rows and the deterministic sparse apply against the
JAX package and plain PyTorch, and the graph recommenders' sums routed
through them.

* segment_rows equals cafe_tpu.ops.sparse.segment_rows within 1e-6
  relative: empty segments, one segment that takes every lane, lanes
  outside [0, num_segments) dropped, int32 and int64 ids, trailing dims
  flattened; its gradient is the gather of the incoming gradient.
* gather_rows' backward equals the gradient of plain indexing exactly on
  dyadic payloads (every partial sum is exact, so no order can differ).
* apply_rows(deterministic=True) equals the default arms (SGD, the table
  pass, per-row Adagrad and Adam) exactly on dyadic payloads, through
  K3's wrapper.
* LightGCN's propagation and a BPR step, and PinSAGE's train step, run
  their sums through K3's wrapper (counted on the CPU) with the part's
  deterministic apply; tests/test_torch_graphrec.py holds their values
  to the JAX package's within its TOL.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.ops import sparse as jsparse
from cafe_tpu_torch.kernels import rowsum
from cafe_tpu_torch.ops import sparse as tsparse

torch.set_num_threads(1)


def _values(rng, e, tail=(8,)):
    return rng.normal(0.0, 1.0, (e,) + tail).astype(np.float32)


def _dyadic(rng, shape):
    """Small multiples of 1/8: every sum of a few of them is exact."""
    return (rng.integers(-64, 64, shape) / 8.0).astype(np.float32)


def _case(kind, rng, dtype):
    e, n = 700, 50
    if kind == "random":
        ids = rng.integers(0, n, e)
    elif kind == "empty_segments":         # only every third segment used
        ids = rng.integers(0, n // 3, e) * 3
    elif kind == "one_segment":            # one segment takes every lane
        ids = np.full(e, 7)
    else:                                  # lanes outside [0, n) dropped
        ids = rng.integers(-20, n + 20, e)
    return _values(rng, e), ids.astype(dtype), n


@pytest.mark.parametrize("dtype", [np.int32, np.int64])
@pytest.mark.parametrize("kind", ["random", "empty_segments", "one_segment",
                                  "dropped_lanes"])
def test_segment_rows_equals_jax(kind, dtype):
    vals, ids, n = _case(kind, np.random.default_rng(0), dtype)
    want = np.asarray(jsparse.segment_rows(jnp.asarray(vals),
                                           jnp.asarray(ids), n))
    got = tsparse.segment_rows(torch.from_numpy(vals), torch.from_numpy(ids),
                               n)
    assert got.shape == (n, vals.shape[1]) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                               atol=1e-6 * np.abs(want).max())
    if kind == "empty_segments":
        assert (got.numpy()[1::3] == 0).all()


def test_segment_rows_flattens_trailing_dims():
    rng = np.random.default_rng(1)
    vals = _values(rng, 300, (3, 4))
    ids = rng.integers(0, 40, 300).astype(np.int32)
    want = np.asarray(jsparse.segment_rows(jnp.asarray(vals),
                                           jnp.asarray(ids), 40))
    got = tsparse.segment_rows(torch.from_numpy(vals), torch.from_numpy(ids),
                               40)
    assert got.shape == (40, 3, 4)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


def test_segment_rows_takes_k3_and_f32_only():
    calls, wrapper = [], rowsum.sparse_add_dense_

    def counting(*a):
        calls.append(a[0].shape)
        return wrapper(*a)

    rowsum.sparse_add_dense_ = counting
    try:
        tsparse.segment_rows(torch.ones(5, 2), torch.tensor([0, 1, 1, 3, 3]),
                             4)
    finally:
        rowsum.sparse_add_dense_ = wrapper
    assert calls == [(4, 2)]
    with pytest.raises(TypeError):
        tsparse.segment_rows(torch.ones(5, 2, dtype=torch.float64),
                             torch.zeros(5, dtype=torch.int64), 4)
    # no lanes: zeros, no launch
    assert torch.equal(tsparse.segment_rows(torch.ones(0, 3),
                                            torch.zeros(0, dtype=torch.int64),
                                            2), torch.zeros(2, 3))


def test_segment_rows_gradient_is_a_gather():
    rng = np.random.default_rng(2)
    vals = torch.from_numpy(_dyadic(rng, (200, 6))).requires_grad_()
    ids = torch.from_numpy(rng.integers(0, 30, 200))
    gout = torch.from_numpy(_dyadic(rng, (30, 6)))
    g, = torch.autograd.grad(tsparse.segment_rows(vals, ids, 30), vals, gout)
    assert torch.equal(g, gout[ids])


@pytest.mark.parametrize("idx_shape", [(500,), (40, 3), (20, 3, 3)])
def test_gather_rows_backward_equals_indexing(idx_shape):
    rng = np.random.default_rng(3)
    table = torch.from_numpy(_dyadic(rng, (60, 16)))
    idx = torch.from_numpy(rng.integers(0, 60, idx_shape))
    gout = torch.from_numpy(_dyadic(rng, idx_shape + (16,)))
    a = table.clone().requires_grad_()
    b = table.clone().requires_grad_()
    out = tsparse.gather_rows(a, idx)
    assert torch.equal(out, table[idx])
    ga, = torch.autograd.grad(out, a, gout)
    gb, = torch.autograd.grad(b[idx], b, gout)
    assert torch.equal(ga, gb)


def test_gather_rows_without_grad_is_indexing():
    table = torch.arange(24, dtype=torch.float32).reshape(6, 4)
    idx = torch.tensor([[5, 0], [0, 2]])
    with torch.no_grad():
        assert torch.equal(tsparse.gather_rows(table, idx), table[idx])


@pytest.mark.parametrize("optimizer,table_pass", [
    ("sgd", None), ("adagrad", True), ("adagrad", False),
    ("adam", True), ("adam", False)])
def test_deterministic_apply_equals_the_default_arms(optimizer, table_pass):
    """Dyadic tables and gradients, a small lr that is a power of two:
    SGD and the coalesced sums are exact, so the deterministic arms give
    the default arms' values bit for bit (Adam's and Adagrad's divisions
    and roots see equal inputs)."""
    rng = np.random.default_rng(4)
    n, d, b = 64, 8, 400
    table = torch.from_numpy(_dyadic(rng, (n, d)))
    idx = torch.from_numpy(rng.integers(0, n, b))
    grad = torch.from_numpy(_dyadic(rng, (b, d)))
    out = {}
    for det in (False, True):
        calls, wrapper = [], rowsum.sparse_add_dense_

        def counting(*a):
            calls.append(1)
            return wrapper(*a)

        rowsum.sparse_add_dense_ = counting
        try:
            t = table.clone()
            slots = tsparse.init_slots(t, optimizer)
            t, slots = tsparse.apply_rows(t, slots, idx, grad, 0.125,
                                          optimizer, table_pass=table_pass,
                                          deterministic=det)
        finally:
            rowsum.sparse_add_dense_ = wrapper
        out[det] = (t, slots, len(calls))
    assert out[False][2] == 0 and out[True][2] == 1
    assert torch.equal(out[False][0], out[True][0])
    for k in out[False][1]:
        assert torch.equal(out[False][1][k], out[True][1][k]), k


def _counting_k3():
    """(calls list, restore): K3's wrapper counting its calls."""
    calls, wrapper = [], rowsum.sparse_add_dense_

    def counting(*a):
        calls.append(tuple(a[2].shape))
        return wrapper(*a)

    rowsum.sparse_add_dense_ = counting
    return calls, lambda: setattr(rowsum, "sparse_add_dense_", wrapper)


def test_lightgcn_sums_through_k3():
    from cafe_tpu_torch.models.graphrec import (LightGCN, LightGCNConfig,
                                                build_bipartite_graph)
    rng = np.random.default_rng(5)
    users, items = rng.integers(0, 30, 300), rng.integers(0, 40, 300)
    graph = build_bipartite_graph(users, items, 30, 40)
    model = LightGCN(LightGCNConfig(latent_dim=8, n_layers=3,
                                    compress_rate=0.5, sketch_threshold=2.0),
                     graph, device="cpu")
    assert model.part.deterministic_sums
    state = model.init()
    calls, restore = _counting_k3()
    try:
        model.bpr_step(state, users[:16], items[:16], items[16:32])
    finally:
        restore()
    edges = len(graph.src)
    # 3 layers' sums and their gathers' backward, then the apply's sum
    assert calls[:3] == [(edges, 8)] * 3 and len(calls) == 7
    assert calls[3:6] == [(edges, 8)] * 3


def test_pinsage_sums_through_k3():
    from cafe_tpu_torch.models.graphrec import (PinSAGE, PinSAGEConfig,
                                                RandomWalkSampler)
    rng = np.random.default_rng(6)
    n_users, n_items = 40, 60
    user_items = [rng.choice(n_items, 5, replace=False).astype(np.int32)
                  for _ in range(n_users)]
    item_users = [np.array([u for u in range(n_users)
                            if i in user_items[u]], np.int32)
                  for i in range(n_items)]
    sampler = RandomWalkSampler(user_items, item_users, seed=0)
    model = PinSAGE(PinSAGEConfig(hidden_dims=8, compress_ratio=4,
                                  sketch_threshold=2.0), n_items,
                    device="cpu")
    assert model.part.deterministic_sums
    state = model.init()
    block = model.make_batch(sampler, 16)
    calls, restore = _counting_k3()
    try:
        model.train_step(state, block, 0.01)
        with torch.no_grad():
            model.representation_step(state, block)
    finally:
        restore()
    # the three position gathers' backward and the apply; the
    # representation step takes no backward
    assert len(calls) == 4
    assert sorted(calls[:3]) == sorted(
        (int(block[k].numel()), 8)
        for k in ("ego_pos", "nbr1_pos", "nbr2_pos"))
