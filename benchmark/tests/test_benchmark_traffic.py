"""criteo_stream against the port's make_criteo_arrays on the same draws,
and its pool's determinism."""

import numpy as np
import torch

from benchmark.traffic import criteo_stream as cs


def test_benchmark_ids_match_make_criteo_arrays_on_the_same_draws():
    from cafe_tpu_torch.data.criteo import CRITEO_COUNTS, make_criteo_arrays
    rows = 20000
    want = make_criteo_arrays(rows)
    rng = np.random.default_rng(0)          # make_criteo_arrays' draws
    for f, n in enumerate(CRITEO_COUNTS):
        u = torch.from_numpy(rng.random(rows))
        got = cs.ids_from_uniform(u, n).numpy()
        same = got == want.sparse[:, f]
        # u ** 4 may round one ulp apart from numpy's power: a rank then
        # moves to its neighbour, at most a handful of rows in 20,000
        assert same.mean() >= 0.999, (f, same.mean())
        ranks_got = (got.astype(np.int64) * pow(cs.MULT, -1, n)) % n
        ranks_want = (want.sparse[:, f].astype(np.int64)
                      * pow(cs.MULT, -1, n)) % n if n > 1 else ranks_got
        assert np.abs(ranks_got - ranks_want)[~same].max(initial=0) <= 1


def test_benchmark_dense_and_labels_distribution():
    g = torch.Generator().manual_seed(3)
    u1, u2 = torch.rand(200000, generator=g), torch.rand(200000, generator=g)
    d = cs.dense_from_uniform(u1, u2)
    gamma = torch.expm1(d.double())
    assert abs(float(gamma.mean()) - 4.0) < 0.05      # Gamma(2, 2): mean 4
    assert abs(float(gamma.var()) - 8.0) < 0.3        # and variance 8
    want = np.log1p(np.random.default_rng(0).gamma(2.0, 2.0, 200000))
    assert abs(float(d.mean()) - want.mean()) < 0.01
    pool = cs.Pool([5, 7], 13, 4096, 11, 1, "cpu")
    assert abs(float(pool.label.mean()) - 0.5) < 0.05
    assert set(torch.unique(pool.label).tolist()) == {0.0, 1.0}


def test_benchmark_pool_is_set_by_seed_not_size():
    counts = [3, 1000, 40_000_000]
    a = cs.Pool(counts, 13, 5000, 2**31 + 17, 1, "cpu")
    b = cs.Pool(counts, 13, 3000, 2**31 + 17, 1, "cpu")
    c = cs.Pool(counts, 13, 3000, 2**31 + 18, 1, "cpu")
    assert torch.equal(a.sparse[:3000], b.sparse)
    assert torch.equal(a.dense[:3000], b.dense)
    assert not torch.equal(b.sparse, c.sparse)
    for j, n in enumerate(counts):
        assert int(a.sparse[:, j].min()) >= 0 and int(a.sparse[:, j].max()) < n


def test_benchmark_pool_wraps_are_counted():
    pool = cs.Pool([10], 13, 100, 1, 1, "cpu")
    assert pool.batches(30) == 3
    for i in range(7):
        pool.batch(i, 30)
    assert pool.wraps == 2
    assert torch.equal(pool.batch(4, 30)[1], pool.batch(1, 30)[1])
