"""The landing arms of the sketch insert (ops/sorted_update.land_max
'segmax' / 'segsum1' / 'scan', set_rows_max, and the 'scatter' mode of
sketch/hotsketch.sketch_insert) against the JAX package, on the inputs of
tests/test_sketch.py::TestLandImplEquivalence."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.ops import sorted_update as jsu
from cafe_tpu.sketch import hotsketch as jhs
from cafe_tpu_torch.ops import sorted_update as tsu
from cafe_tpu_torch.sketch import hotsketch as ths

torch.set_num_threads(1)

FIELDS = ("val", "cnt", "dic", "free", "free_top", "tot")


def _land_inputs(seed=1, b=512, c=3, n=64):
    """tests/test_sketch.py:256-272: sorted keys with dropped keys >= n,
    at most one writer per (segment, channel)."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(0, n + 2, b)).astype(np.int32)
    enc = np.full((b, c), -1, np.int32)
    for s in range(n):
        lanes = np.where(keys == s)[0]
        if len(lanes):
            ch = rng.integers(0, c)
            enc[rng.choice(lanes), ch] = int(rng.integers(0, 1 << 30))
    return keys, enc, n


@pytest.mark.parametrize("impl", ["segmax", "segsum1", "scan", "pallas"])
@pytest.mark.parametrize("seed", [1, 2])
def test_land_max_arms_match_jax(impl, seed):
    keys, enc, n = _land_inputs(seed)
    want = np.asarray(jsu.land_max(jnp.asarray(enc), jnp.asarray(keys), n,
                                   "segmax"))
    got = tsu.land_max(torch.from_numpy(enc), torch.from_numpy(keys), n,
                       impl)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("impl", ["segsum1", "scan"])
def test_land_max_arms_match_jax_same_impl(impl):
    """The JAX package's own arm of the same name, with keys below 0 and a
    segment whose one writer carries 0 (the sum and scan edge cases)."""
    keys, enc, n = _land_inputs(3, b=300, c=4, n=40)
    keys[:5] = -1
    keys = np.sort(keys)
    enc[keys == 7] = -1
    enc[np.where(keys == 7)[0][:1], 2] = 0
    want = np.asarray(jsu.land_max(jnp.asarray(enc), jnp.asarray(keys), n,
                                   impl))
    got = tsu.land_max(torch.from_numpy(enc), torch.from_numpy(keys), n,
                       impl)
    np.testing.assert_array_equal(got.numpy(), want)


def test_land_max_unknown_impl_raises():
    keys, enc, n = _land_inputs()
    with pytest.raises(ValueError, match="unknown"):
        tsu.land_max(torch.from_numpy(enc), torch.from_numpy(keys), n, "x")


def test_set_rows_max_matches_jax():
    keys, enc, n = _land_inputs(4, b=400, c=4, n=50)
    rng = np.random.default_rng(9)
    for dtype in (np.int32, np.float32):
        dest = rng.integers(0, 1000, (n, 4)).astype(dtype)
        want = np.asarray(jsu.set_rows_max(jnp.asarray(dest),
                                           jnp.asarray(enc),
                                           jnp.asarray(keys)))
        got = tsu.set_rows_max(torch.from_numpy(dest), torch.from_numpy(enc),
                               torch.from_numpy(keys))
        assert got.dtype == torch.from_numpy(dest).dtype
        np.testing.assert_array_equal(got.numpy(), want)


def test_use_scatter_landing_matches_jax():
    for impl in ("auto", "segmax", "segsum1", "scan", "pallas", "scatter"):
        for n in (512, 1 << 21):
            assert tsu.use_scatter_landing(impl, n) == \
                jsu.use_scatter_landing(impl, n)


# (land impl, max_id) of tests/test_sketch.py:233-236; max_id < 2^27
# switches the landing to the packed C+1-channel encoding
COMBOS = [("segmax", 2**31), ("segsum1", 2**31), ("scan", 2**31),
          ("segmax", 1 << 21), ("segsum1", 1 << 21), ("scatter", 2**31),
          ("scatter", 1 << 21)]
INSERTS = 12


def _stream(dyadic=False):
    """The id/score stream of tests/test_sketch.py. `dyadic` rounds the
    scores to multiples of 1/4: their running sums are then exact in f32
    in any order, so the group totals (a cumsum, which XLA and torch sum
    in other orders) agree bit for bit between the packages."""
    r = np.random.default_rng(7)
    out = []
    for _ in range(INSERTS):
        ids = np.minimum(r.zipf(1.3, 2048), 1 << 20).astype(np.int32)
        sc = r.random(2048, dtype=np.float32) * 2.0
        out.append((ids, np.round(sc * 4) / 4 if dyadic else sc))
    return out


def _port_run(impl, max_id, stream):
    cfg = ths.HotSketchConfig(buckets=512, threshold=4.0, land_impl=impl,
                              max_id=max_id)
    st = ths.init_sketch(cfg, device="cpu")
    results = []
    for ids, sc in stream:
        before = {k: v.clone() for k, v in st.items()}
        new, res = ths.sketch_insert(cfg, st, torch.from_numpy(ids),
                                     torch.from_numpy(sc))
        for k in FIELDS:           # the insert leaves its input untouched
            assert torch.equal(st[k], before[k]), (impl, k)
        st = new
        results.append(res)
    return st, results


@pytest.fixture(scope="module")
def port_runs():
    stream = _stream()
    return {key: _port_run(*key, stream) for key in COMBOS}


@pytest.fixture(scope="module")
def port_runs_dyadic():
    stream = _stream(dyadic=True)
    return {key: _port_run(*key, stream) for key in COMBOS}


@pytest.fixture(scope="module")
def jax_runs():
    """The JAX package's sketch_insert on the dyadic stream, per combo."""
    stream = _stream(dyadic=True)
    out = {}
    for impl, max_id in COMBOS:
        cfg = jhs.HotSketchConfig(buckets=512, threshold=4.0,
                                  land_impl=impl, max_id=max_id)
        st = jhs.init_sketch(cfg)
        results = []
        for ids, sc in stream:
            st, res = jhs.sketch_insert(cfg, st, jnp.asarray(ids),
                                        jnp.asarray(sc))
            results.append(res)
        out[(impl, max_id)] = (st, results)
    return out


@pytest.mark.parametrize("impl,max_id", COMBOS)
def test_sketch_states_bit_identical_to_segmax(port_runs, impl, max_id):
    ref, ref_res = port_runs[("segmax", 2**31)]
    got, got_res = port_runs[(impl, max_id)]
    for k in FIELDS:
        assert torch.equal(got[k], ref[k]), (impl, max_id, k)
    for a, b in zip(ref_res, got_res):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("impl,max_id", COMBOS)
def test_sketch_states_match_jax(port_runs_dyadic, jax_runs, impl, max_id):
    got, got_res = port_runs_dyadic[(impl, max_id)]
    want, want_res = jax_runs[(impl, max_id)]
    assert int(got["free_top"]) < 511          # ids promoted
    for k in FIELDS:
        np.testing.assert_array_equal(got[k].numpy(),
                                      np.asarray(getattr(want, k)),
                                      err_msg=f"{impl} {max_id} {k}")
    for a, b in zip(want_res, got_res):
        for f in a._fields:
            np.testing.assert_array_equal(getattr(b, f).numpy(),
                                          np.asarray(getattr(a, f)),
                                          err_msg=f)
