"""HotSketch v1 port against the JAX package: bucket hash, query, insert
(decay, matching, placement/eviction, promotion, round 2) and revert.

Scores are integers, so no f32 summation order can flip a decision: the
whole sketch state and every insert report must be EXACTLY equal after
every batch.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cafe_tpu.sketch import hotsketch as jhs
from cafe_tpu_torch.sketch import hotsketch as ths

torch.set_num_threads(1)

FIELDS = ("val", "cnt", "dic", "free", "free_top", "tot")


def _to_torch(jstate):
    return {f: torch.from_numpy(np.array(getattr(jstate, f))) for f in FIELDS}


def _assert_state_equal(tstate, jstate, where=""):
    for f in FIELDS:
        np.testing.assert_array_equal(tstate[f].numpy(),
                                      np.asarray(getattr(jstate, f)),
                                      err_msg=f"{f} {where}")


def _batches(seed, n_batches=6, b=512, vocab=600):
    rng = np.random.default_rng(seed)
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    p = ranks ** -1.1
    p /= p.sum()
    perm = rng.permutation(vocab) * 7 + 3          # scattered id space
    out = []
    for _ in range(n_batches):
        ids = perm[rng.choice(vocab, b, p=p)].astype(np.int32)
        ids[rng.random(b) < 0.05] = jhs.INVALID_ID  # padded lanes
        scores = rng.integers(0, 4, b).astype(np.float32)
        out.append((ids, scores))
    return out


def test_bucket_hash_matches_jax():
    rng = np.random.default_rng(0)
    ids = np.concatenate([rng.integers(-2**31, 2**31 - 1, 4000),
                          [0, 1, 2**31 - 1, -1, -2**31]]).astype(np.int32)
    for s in (1, 64, 9646, 1543432):
        jcfg = jhs.HotSketchConfig(buckets=s, threshold=1.0)
        tcfg = ths.HotSketchConfig(buckets=s, threshold=1.0)
        np.testing.assert_array_equal(
            ths._bucket_of(tcfg, torch.from_numpy(ids)).numpy(),
            np.asarray(jhs._bucket_of(jcfg, jnp.asarray(ids))))


def test_init_sketch_bit_equal():
    jcfg = jhs.HotSketchConfig(buckets=700, threshold=2.0)
    tcfg = ths.HotSketchConfig(buckets=700, threshold=2.0)
    _assert_state_equal(ths.init_sketch(tcfg, device="cpu"),
                        jhs.init_sketch(jcfg))


@pytest.mark.parametrize("land_impl,max_id,buckets,b", [
    ("auto", 1 << 27, 64, 512),     # packed landing, K1's plain version
    ("segmax", 2**31, 64, 512),     # 2C-channel landing, torch seg max
    ("auto", 1 << 27, 300, 6000),   # B > PROMO_LANES: capped reports
])
def test_insert_stream_exact(land_impl, max_id, buckets, b):
    kw = dict(buckets=buckets, threshold=4.0, decay=0.5,
              land_impl=land_impl, max_id=max_id)
    jcfg, tcfg = jhs.HotSketchConfig(**kw), ths.HotSketchConfig(**kw)
    jst = jhs.init_sketch(jcfg)
    tst = _to_torch(jst)
    decays = promos = 0
    for i, (ids, scores) in enumerate(_batches(1, b=b, vocab=b + 88)):
        q_ids = np.unique(ids[ids != jhs.INVALID_ID])
        np.testing.assert_array_equal(
            ths.sketch_query(tcfg, tst, torch.from_numpy(q_ids)).numpy(),
            np.asarray(jhs.sketch_query(jcfg, jst, jnp.asarray(q_ids))))
        decays += int(float(jst.tot) > buckets * 4.0 * 10)
        jst, jres = jhs.sketch_insert(jcfg, jst, jnp.asarray(ids),
                                      jnp.asarray(scores))
        tst, tres = ths.sketch_insert(tcfg, tst, torch.from_numpy(ids),
                                      torch.from_numpy(scores))
        _assert_state_equal(tst, jst, f"after batch {i}")
        for f in ("ids", "slots", "mask", "bucket", "cell"):
            np.testing.assert_array_equal(getattr(tres, f).numpy(),
                                          np.asarray(getattr(jres, f)),
                                          err_msg=f"report {f}, batch {i}")
        promos += int(np.asarray(jres.mask).sum())
    assert decays >= 1 and promos >= 1   # the stream exercised both


def test_revert_promotions_exact():
    """Revert the promotions beyond a cap smaller than the report (the
    CafePart migration cap, cap < L)."""
    kw = dict(buckets=64, threshold=3.0)
    jcfg, tcfg = jhs.HotSketchConfig(**kw), ths.HotSketchConfig(**kw)
    jst = jhs.init_sketch(jcfg)
    tst = _to_torch(jst)
    for ids, scores in _batches(2, n_batches=3):
        jst, jres = jhs.sketch_insert(jcfg, jst, jnp.asarray(ids),
                                      jnp.asarray(scores))
        tst, tres = ths.sketch_insert(tcfg, tst, torch.from_numpy(ids),
                                      torch.from_numpy(scores))
    mask = np.asarray(jres.mask)
    assert mask.sum() >= 3
    cap = 2
    excess = mask & (np.cumsum(mask) - 1 >= cap)
    jst2 = jhs.revert_promotions(jcfg, jst, None, jres, jnp.asarray(excess))
    tst2 = ths.revert_promotions(tcfg, tst, None, tres,
                                 torch.from_numpy(excess))
    _assert_state_equal(tst2, jst2, "after revert")
    assert int(jst2.free_top) == int(jst.free_top) + int(excess.sum())


def test_decay_and_alloc_slots_exact():
    """The stand-alone decay (with demotions) and the slot allocator."""
    kw = dict(buckets=64, threshold=3.0, decay=0.5)
    jcfg, tcfg = jhs.HotSketchConfig(**kw), ths.HotSketchConfig(**kw)
    jst = jhs.init_sketch(jcfg)
    tst = _to_torch(jst)
    for ids, scores in _batches(3, n_batches=3):
        jst, _ = jhs.sketch_insert(jcfg, jst, jnp.asarray(ids),
                                   jnp.asarray(scores))
        tst, _ = ths.sketch_insert(tcfg, tst, torch.from_numpy(ids),
                                   torch.from_numpy(scores))
    assert int((np.asarray(jst.dic) != 0).sum()) > 0
    jd, td = jhs._decay(jcfg, jst), ths._decay(tcfg, tst)
    _assert_state_equal(td, jd, "after decay")
    assert int(jd.free_top) > int(jst.free_top)     # something demoted
    want = np.random.default_rng(4).random(80) < 0.5
    for top in (int(jd.free_top), 3):
        jr = jhs.alloc_slots(jd.free, jnp.int32(top), jnp.asarray(want))
        tr = ths.alloc_slots(td["free"], torch.tensor(top, dtype=torch.int32),
                             torch.from_numpy(want))
        for j, t in zip(jr, tr):
            np.testing.assert_array_equal(t.numpy(), np.asarray(j))
