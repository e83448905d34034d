"""The sorted-keys contract of K1 (kernels/land.cu), held on the CPU.

The CUDA kernel lands by row-owner tiles and finds each tile's lanes by
binary search, so it requires ascending keys (the JAX kernel's contract,
cafe_tpu/ops/pallas_land.py) and traps on a descent. These tests run the
port's sketch insert through the kernel's arm (land_impl 'auto' and
'pallas') with `land.land_max` wrapped to assert that every call's keys
ascend, in both landing branches of hotsketch.sketch_insert: the packed
one (max_id < 2^27, cells <= 16: C + 1 channels) and the two-channel one
(2C channels). The insert's state must stay bit-identical to the 'segmax'
arm, which takes keys in any order. `land_max_plain` stays order-free.
"""

import numpy as np
import pytest
import torch

from cafe_tpu_torch.kernels import land
from cafe_tpu_torch.sketch import hotsketch as hs

torch.set_num_threads(1)

FIELDS = ("val", "cnt", "dic", "free", "free_top", "tot")


def _stream(seed, inserts=6, b=2048):
    """Zipf ids with padded lanes (INVALID_ID, keyed past the last
    bucket) and non-negative scores."""
    r = np.random.default_rng(seed)
    out = []
    for _ in range(inserts):
        ids = np.minimum(r.zipf(1.3, b), 1 << 20).astype(np.int32)
        ids[r.random(b) < 0.1] = hs.INVALID_ID
        out.append((ids, (r.random(b, dtype=np.float32) * 2.0)))
    return out


@pytest.fixture
def sorted_calls(monkeypatch):
    """Wraps land.land_max: every call's keys must ascend; returns the
    list of (lanes, channels, n_rows) of the calls."""
    calls = []
    real = land.land_max

    def checked(enc, keys, n_rows):
        k = keys.numpy()
        assert np.all(k[1:] >= k[:-1]), "land_max keys descend"
        calls.append((enc.shape[0], enc.shape[1], n_rows))
        return real(enc, keys, n_rows)

    monkeypatch.setattr(land, "land_max", checked)
    return calls


def _run(impl, max_id, cells, stream):
    cfg = hs.HotSketchConfig(buckets=257, threshold=3.0, cells=cells,
                             land_impl=impl, max_id=max_id)
    st = hs.init_sketch(cfg, device="cpu")
    results = []
    for ids, sc in stream:
        st, res = hs.sketch_insert(cfg, st, torch.from_numpy(ids),
                                   torch.from_numpy(sc))
        results.append(res)
    return st, results


# (max_id, cells, channels the landing takes): packed, then two-channel
# by a wide id range, then two-channel by more than 16 cells
BRANCHES = [(1 << 21, 4, 5), (2**31, 4, 8), (1 << 21, 17, 34)]


@pytest.mark.parametrize("impl", ["auto", "pallas"])
@pytest.mark.parametrize("max_id,cells,channels", BRANCHES)
def test_insert_lands_sorted_keys(sorted_calls, impl, max_id, cells,
                                  channels):
    stream = _stream(max_id % 97 + cells)
    got, got_res = _run(impl, max_id, cells, stream)
    assert sorted_calls == [(2048, channels, 257)] * len(stream)
    ref, ref_res = _run("segmax", max_id, cells, stream)
    assert len(sorted_calls) == len(stream)   # segmax does not call K1
    assert int(got["free_top"]) < 256         # ids promoted
    for k in FIELDS:
        assert torch.equal(got[k], ref[k]), k
    for a, b in zip(ref_res, got_res):
        for f in a._fields:
            assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("seed", [0, 1])
def test_land_max_plain_takes_any_order(seed):
    """The plain version lands shuffled keys as the sorted ones."""
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.integers(-4, 70, 600)).astype(np.int32)
    enc = np.where(rng.random((600, 3)) < 0.5,
                   rng.integers(0, 1 << 30, (600, 3)), -1).astype(np.int32)
    perm = rng.permutation(600)
    want = land.land_max_plain(torch.from_numpy(enc),
                               torch.from_numpy(keys), 64)
    got = land.land_max_plain(torch.from_numpy(enc[perm]),
                              torch.from_numpy(keys[perm]), 64)
    assert torch.equal(got, want)
