"""The CAFE+ sketch port (cafe_tpu_torch/sketch/hotsketch_plus.py), the v1
sketch's probes and the CU sketch against the JAX package.

Every case of tests/test_sketch_plus.py runs here on both packages from
one numpy-made stream, and keeps its own assertion on the port's state.
After every insert all 13 state fields (val1/cnt1/dic1, val2/cnt2/dic2/
ts2, free/free_top, threshold, real_n, decay_acc, step) and the report
must be EXACTLY equal: scores are integers (or sums of integers and
powers of ten divided by V), so no f32 summation order can move a count,
a crossing or a reset's cut. Added: collisions in one main-tier cell,
a reset with tied counts at its cut, decay streams, inherit on and off,
and a step of more than 4,096 promotions through the revert.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cafe_tpu.sketch import cu_sketch as jcu
from cafe_tpu.sketch import hotsketch as jhs
from cafe_tpu.sketch import hotsketch_plus as jp
from cafe_tpu_torch.sketch import cu_sketch as tcu
from cafe_tpu_torch.sketch import hotsketch as ths
from cafe_tpu_torch.sketch import hotsketch_plus as tp

torch.set_num_threads(1)

FIELDS = jp.CafePlusState._fields
INVALID = int(jhs.INVALID_ID)


def pad_ids(ids, scores, width):
    out_i = np.full(width, INVALID, dtype=np.int32)
    out_s = np.zeros(width, dtype=np.float32)
    out_i[: len(ids)] = ids
    out_s[: len(ids)] = scores
    return out_i, out_s


class Both:
    """One CafePlusConfig driven through both packages in lockstep; every
    insert compares the whole state and the report."""

    def __init__(self, **kw):
        self.jcfg, self.cfg = jp.CafePlusConfig(**kw), tp.CafePlusConfig(**kw)
        self.jst = jp.init_sketch_plus(self.jcfg)
        self.st = tp.init_sketch_plus(self.cfg, device="cpu")
        self.n = 0
        self.check("init")

    def check(self, where):
        for f in FIELDS:
            np.testing.assert_array_equal(
                self.st[f].numpy(), np.asarray(getattr(self.jst, f)),
                err_msg=f"{f} {where}")

    def insert(self, ids, scores):
        ids = np.asarray(ids, np.int32)
        scores = np.asarray(scores, np.float32)
        self.jst, jres = jp.sketch_insert_plus(
            self.jcfg, self.jst, jnp.asarray(ids), jnp.asarray(scores))
        self.st, res = tp.sketch_insert_plus(
            self.cfg, self.st, torch.from_numpy(ids),
            torch.from_numpy(scores))
        self.n += 1
        self.check(f"after insert {self.n}")
        for f in ("ids", "slots", "mask"):
            np.testing.assert_array_equal(
                getattr(res, f).numpy(), np.asarray(getattr(jres, f)),
                err_msg=f"report {f}, insert {self.n}")
        assert res.bucket is None and res.cell is None
        return jres, res

    def query(self, ids):
        ids = np.asarray(ids, np.int32)
        got = tp.sketch_query_plus(self.cfg, self.st,
                                   torch.from_numpy(ids)).numpy()
        np.testing.assert_array_equal(got, np.asarray(jp.sketch_query_plus(
            self.jcfg, self.jst, jnp.asarray(ids))))
        return got

    def np(self, f):
        return self.st[f].numpy()


def _ids_sharing(fn_keys, count, start=1, limit=200000):
    """`count` ids whose keys (a tuple of the hashes in fn_keys) are all
    equal, searched upwards from `start`."""
    ids = torch.arange(start, limit, dtype=torch.int32)
    keys = torch.stack([fn(ids).long() for fn in fn_keys], 1)
    want = keys[0]
    hit = ids[(keys == want).all(dim=1)]
    assert hit.numel() >= count
    return [int(x) for x in hit[:count]]


def test_hashes_match_jax():
    rng = np.random.default_rng(0)
    ids = np.concatenate([rng.integers(-2**31, 2**31 - 1, 4000),
                          [0, 1, INVALID, -1, -2**31]]).astype(np.int32)
    for lim, frac in ((10, 0.1), (512, 0.1), (9646, 0.1), (1543432, 0.43)):
        kw = dict(lim=lim, threshold=1.0, staging_frac=frac)
        jc, tc = jp.CafePlusConfig(**kw), tp.CafePlusConfig(**kw)
        assert (tc.n1, tc.n2) == (jc.n1, jc.n2)
        for jf, tf in ((jp._h1, tp._h1), (jp._h2, tp._h2)):
            np.testing.assert_array_equal(
                tf(tc, torch.from_numpy(ids)).numpy(),
                np.asarray(jf(jc, jnp.asarray(ids))))


class TestTwoTier:
    def test_new_ids_enter_staging_not_main(self):
        s = Both(lim=64, threshold=100.0)
        s.insert(*pad_ids([11, 22], [1.0, 1.0], 8))
        assert int((s.np("cnt2") > 0).sum()) == 2
        assert int((s.np("cnt1") > 0).sum()) == 0

    def test_graduation_to_main_tier_with_slot(self):
        s = Both(lim=64, threshold=5.0, adjust_threshold=False)
        s.insert(*pad_ids([7], [3.0], 8))
        _, res = s.insert(*pad_ids([7], [3.0], 8))
        assert bool(res.mask.any())
        assert int((s.np("cnt1") > 0).sum()) == 1
        assert 7 in s.np("val1")[s.np("cnt1") > 0].tolist()
        assert int((s.np("cnt2") > 0).sum()) == 0
        assert s.query([7])[0] < 0

    def test_staged_hot_id_visible_to_query(self):
        s = Both(lim=64, threshold=2.0, adjust_threshold=False)
        s.insert(*pad_ids([9], [1.0], 8))
        _, res = s.insert(*pad_ids([9], [1.5], 8))
        assert bool(res.mask.any())
        assert s.query([9])[0] < 0

    def test_lru_displacement_moves_worthy_victim(self):
        s = Both(lim=512, threshold=1e9, cells=2, adjust_threshold=False)
        a, b, c = _ids_sharing([lambda x: tp._h2(s.cfg, x)], 3)
        s.insert(*pad_ids([a], [6.0], 8))
        s.insert(*pad_ids([b], [1.0], 8))
        # the bucket is full; c displaces the LRU victim a (count 6 >= 5),
        # which moves to the main tier
        s.insert(*pad_ids([c], [1.0], 8))
        assert a in s.np("val1")[s.np("cnt1") > 0].tolist()
        live2 = s.np("val2")[s.np("cnt2") > 0].tolist()
        assert c in live2 and b in live2 and a not in live2

    def test_adaptive_threshold_reset(self):
        s = Both(lim=8, threshold=1.0, adjust_threshold=True)
        for i in range(40):
            ids = np.arange(i * 8, i * 8 + 8, dtype=np.int32)
            s.insert(ids, np.full(8, 2.0, np.float32))
            s.insert(ids, np.full(8, 2.0, np.float32))
        assert float(s.st["threshold"]) > 1.0
        d1, d2 = s.np("dic1"), s.np("dic2")
        used = np.concatenate([d1[d1 != 0], d2[d2 != 0]])
        assert len(used) == len(set(used.tolist())) <= s.cfg.lim - 1

    def test_decay_divides_counts_and_threshold(self):
        s = Both(lim=64, threshold=1000.0, alpha=10001.0,
                 adjust_threshold=False)
        s.insert(*pad_ids([5], [40.0], 8))
        thr0 = float(s.st["threshold"])
        s.insert(*pad_ids([6], [1.0], 8))
        assert float(s.st["threshold"]) == pytest.approx(thr0 / 10000.0)
        c2 = s.np("cnt2")
        assert c2[c2 > 0].min() >= 40.0 / 10000.0 - 1e-9

    def test_recall_on_zipf_stream(self):
        rng = np.random.default_rng(3)
        vocab = 4000
        p = np.arange(1, vocab + 1, dtype=np.float64) ** -1.2
        stream = rng.choice(vocab, size=60000, p=p / p.sum()).astype(
            np.int32)
        s = Both(lim=512, threshold=8.0)
        for lo in range(0, len(stream), 512):
            chunk = stream[lo:lo + 512]
            s.insert(chunk, np.ones(len(chunk), np.float32))
        counts = np.bincount(stream, minlength=vocab)
        hot = set(s.np("val1")[s.np("dic1") != 0].tolist()) \
            | set(s.np("val2")[s.np("dic2") != 0].tolist())
        ideal = set(np.argsort(-counts)[: len(hot)].tolist())
        assert len(ideal & hot) / max(1, len(ideal)) > 0.6


class TestRegressionFixes:
    def test_colliding_fresh_ids_both_survive(self):
        # lim 10 -> n2 = 1 staging bucket: every fresh id collides
        s = Both(lim=10, threshold=100.0, adjust_threshold=False)
        s.insert(*pad_ids([5, 9], [1.0, 1.0], 8))
        v2, c2 = list(s.np("val2")[0]), s.np("cnt2")[0]
        assert {5, 9} <= set(v2)
        for want in (5, 9):
            assert c2[v2.index(want)] == 1.0

    def test_colliding_fresh_hot_ids_get_distinct_slots(self):
        s = Both(lim=10, threshold=0.5, adjust_threshold=False)
        before = int(s.st["free_top"])
        ids, sc = pad_ids([5, 9], [1.0, 1.0], 8)
        s.insert(ids, sc)
        q = s.query(ids)
        slots = {-q[0], -q[1]}
        assert all(x > 0 for x in slots) and len(slots) == 2
        assert int(s.st["free_top"]) == before - 2

    def test_free_stack_conserved_under_collisions(self):
        s = Both(lim=16, threshold=2.0, adjust_threshold=False)
        rng = np.random.default_rng(0)
        for _ in range(30):
            s.insert(*pad_ids(rng.integers(0, 40, 16), np.ones(16), 16))
        held = np.concatenate([s.np("dic1").ravel(), s.np("dic2").ravel()])
        held = held[held != 0]
        assert len(set(held.tolist())) == len(held)
        assert len(held) + int(s.st["free_top"]) == s.cfg.lim - 1

    def test_reset_keeps_hottest_id_hot(self):
        kw = dict(lim=8, threshold=10.0)
        jc, tc = jp.CafePlusConfig(**kw), tp.CafePlusConfig(**kw)
        jst = jp.init_sketch_plus(jc)
        cnt1 = np.asarray(jst.cnt1).copy()
        val1 = np.asarray(jst.val1).copy()
        cnt1.reshape(-1)[:12] = 10.0 + np.arange(12)
        val1.reshape(-1)[:12] = 100 + np.arange(12)
        jst = jst._replace(cnt1=jnp.asarray(cnt1), val1=jnp.asarray(val1),
                           real_n=jnp.asarray(12, np.int32))
        tst = {f: torch.from_numpy(np.array(getattr(jst, f)))
               for f in FIELDS}
        jst2, tst2 = jp._reset(jc, jst), tp._reset(tc, tst)
        for f in FIELDS:
            np.testing.assert_array_equal(tst2[f].numpy(),
                                          np.asarray(getattr(jst2, f)))
        dic = tst2["dic1"].numpy().reshape(-1)
        assert dic[11] != 0                       # the hottest keeps a slot
        held = dic[dic != 0]
        assert len(held) == len(set(held.tolist())) == tc.lim - 1
        assert dic[0] == 0 and dic[1] == 0        # the coldest are denied

    def test_rebuild_free_list_preserves_padded_shape(self):
        kw = dict(buckets=64, threshold=5.0)
        jst = jhs.init_sketch(jhs.HotSketchConfig(**kw))
        jst = jst._replace(dic=jst.dic.at[0, 0].set(3))
        tcfg = ths.HotSketchConfig(**kw)
        tst = {f: torch.from_numpy(np.array(getattr(jst, f)))
               for f in jst._fields}
        jst2 = jhs.rebuild_free_list(jhs.HotSketchConfig(**kw), jst)
        tst2 = ths.rebuild_free_list(tcfg, tst)
        for f in ("free", "free_top"):
            np.testing.assert_array_equal(tst2[f].numpy(),
                                          np.asarray(getattr(jst2, f)))
        assert tst2["free"].shape == tst["free"].shape
        assert int(tst2["free_top"]) == tcfg.buckets - 2
        popped = tst2["free"][: int(tst2["free_top"])].numpy()
        assert 3 not in popped and 0 not in popped
        assert popped.max() < tcfg.buckets


def test_analyse_plus_probe():
    s = Both(lim=64, threshold=3.0, adjust_threshold=False)
    hot = np.arange(5, 15, dtype=np.int32)
    for _ in range(4):
        s.insert(*pad_ids(np.concatenate([hot, hot]), np.ones(20), 20))
    cold = np.arange(900, 910, dtype=np.int32)
    for ids, want in ((hot, 1.0), (cold, 0.0)):
        got = tp.analyse_plus(s.cfg, s.st, torch.from_numpy(ids))
        assert float(got) == want == float(jp.analyse_plus(
            s.jcfg, s.jst, jnp.asarray(ids)))


class TestStagingInheritance:
    """cfg.inherit: a newcomer displacing a DISCARDED victim absorbs its
    count; off, it starts from its own."""

    def _fill_and_evict(self, inherit):
        # lim 10 -> one staging bucket of 4 cells
        s = Both(lim=10, threshold=100.0, cells=4, adjust_threshold=False,
                 inherit=inherit)
        s.insert(*pad_ids([1, 2, 3, 4], [2.0] * 4, 8))
        # newcomer 5 evicts the LRU victim (count 2 < 5: discarded)
        s.insert(*pad_ids([5], [3.0], 8))
        where = np.argwhere(s.np("val2") == 5)
        assert len(where) == 1
        return float(s.np("cnt2")[tuple(where[0])])

    def test_inherit_absorbs_discarded_count(self):
        assert self._fill_and_evict(True) == 5.0

    def test_reference_semantics_without_inherit(self):
        assert self._fill_and_evict(False) == 3.0

    @pytest.mark.parametrize("inherit", [False, True])
    def test_stream_exact(self, inherit):
        """A collision-heavy stream (a few staging buckets, many fresh ids
        a batch) with and without inheritance."""
        s = Both(lim=24, threshold=6.0, inherit=inherit)
        rng = np.random.default_rng(5)
        for _ in range(25):
            ids = rng.integers(0, 300, 64).astype(np.int32)
            ids[rng.random(64) < 0.1] = INVALID
            s.insert(ids, rng.integers(0, 4, 64))
        assert int((s.np("dic1") != 0).sum()) > 0


def test_reset_heavy_stream_fires():
    """tests/test_sketch_plus.py TestResetCost's stream: a low threshold
    and a heavy-tailed Zipf trip the reset at least 3 times in 12 steps,
    on both packages alike."""
    s = Both(lim=2048, threshold=2.0)
    rng = np.random.default_rng(0)
    trip = int(s.cfg.lim * 1.2)
    fires = 0
    for _ in range(12):
        ids = np.minimum(rng.zipf(1.05, 4096), 1 << 20).astype(np.int32)
        sc = rng.random(4096, dtype=np.float32) * 4.0
        fires += int(s.st["real_n"]) > trip
        jst, jres = jp.sketch_insert_plus(s.jcfg, s.jst, jnp.asarray(ids),
                                          jnp.asarray(sc))
        s.st, res = tp.sketch_insert_plus(s.cfg, s.st, torch.from_numpy(ids),
                                          torch.from_numpy(sc))
        s.jst = jst
        # f32 scores sum in one order on both (index_add_ on the CPU is
        # sequential, as XLA's scatter-add): the same state
        s.check("zipf stream")
        np.testing.assert_array_equal(res.slots.numpy(),
                                      np.asarray(jres.slots))
    assert fires >= 3


def test_collisions_last_lane_wins():
    """Two lanes pick one empty main-tier cell in one round: the LAST lane
    (lanes are id-sorted) takes it and the other the next cell in round
    two, as XLA's in-order scatter leaves it. Once with two graduates,
    once with two moved staging victims."""
    kw = dict(lim=40, threshold=10.0, cells=2, adjust_threshold=False)
    s = Both(**kw)
    keys = [lambda x: tp._h1(s.cfg, x), lambda x: tp._h2(s.cfg, x)]
    row = int(keys[0](torch.tensor([1])))

    # graduates: a < b staged below the threshold, then both cross at once
    a, b = _ids_sharing(keys, 2)
    s.insert(*pad_ids([a, b], [6.0, 6.0], 8))
    assert int((s.np("cnt1") > 0).sum()) == 0
    s.insert(*pad_ids([a, b], [6.0, 6.0], 8))
    assert list(s.np("val1")[row]) == [b, a]
    assert list(s.np("cnt1")[row]) == [12.0, 12.0]
    assert (s.np("dic1")[row] != 0).all()

    # victims: x < y fill one staging bucket with counts 6 (>= 5: worth
    # keeping); fresh u < v of that bucket displace them in one insert
    # (u takes x's cell 0, v y's cell 1), so both victims move to one
    # empty main-tier bucket on the lanes of u and v
    s = Both(**kw)
    x, y, u, v = _ids_sharing(keys, 4)
    s.insert(*pad_ids([x, y], [6.0, 6.0], 8))
    s.insert(*pad_ids([u, v], [1.0, 1.0], 8))
    assert list(s.np("val1")[row]) == [y, x]
    assert list(s.np("cnt1")[row]) == [6.0, 6.0]
    assert list(s.np("val2")[int(keys[1](torch.tensor([1])))]) == [u, v]


def test_reset_with_tied_counts_at_the_cut():
    """Every candidate has the same count when the reset fires, so the
    cut falls inside one tie group: the stable order over (count, cell)
    picks who keeps a slot, and the threshold becomes that count."""
    s = Both(lim=16, threshold=1.0)
    fired = 0
    for i in range(6):
        ids = np.arange(i * 12, i * 12 + 12, dtype=np.int32)
        for _ in range(2):
            before = int(s.st["real_n"])
            s.insert(ids, np.full(12, 1.0, np.float32))
            fired += before > int(s.cfg.lim * 1.2)
    assert fired >= 1
    assert float(s.st["threshold"]) == 2.0       # the tied count
    held = np.concatenate([s.np("dic1").ravel(), s.np("dic2").ravel()])
    held = held[held != 0]
    assert len(set(held.tolist())) == len(held) <= s.cfg.lim - 1


@pytest.mark.parametrize("alpha", [2.0, 3.5])
def test_decay_stream_exact(alpha):
    """alpha >= 2 fires the decay every few inserts (at the default
    1.000001 it would take ~9.2 M): counts and threshold are divided by
    V (the f32 reciprocal multiply of the compiled JAX division), with
    resets in between."""
    s = Both(lim=32, threshold=3.0, alpha=alpha)
    rng = np.random.default_rng(int(alpha * 10))
    fired = 0
    for _ in range(30):
        before = float(s.st["decay_acc"])
        ids = rng.zipf(1.3, 96).astype(np.int32) % 400
        s.insert(ids, rng.integers(1, 5, 96))
        fired += float(s.st["decay_acc"]) < before
    assert fired >= 2
    cnt = np.concatenate([s.np("cnt1").ravel(), s.np("cnt2").ravel()])
    assert (cnt != np.round(cnt)).any()          # divided counts live on


def test_revert_more_than_4096_promotions():
    """One insert promotes more than PROMO_LANES ids (every fresh id
    clears a threshold below its score and takes a slot at once); the
    promotions beyond 4,096 are reverted (CafePart's migration cap)."""
    s = Both(lim=16384, threshold=0.5, staging_frac=0.5)
    ids = (np.random.default_rng(1).permutation(1 << 16)[:12000]
           .astype(np.int32))
    jres, res = s.insert(ids, np.ones(12000, np.float32))
    mask = res.mask.numpy()
    assert mask.sum() > 4096
    excess = mask & (np.cumsum(mask) - 1 >= 4096)
    jst = jp.revert_promotions_plus(s.jcfg, s.jst, None, jres,
                                    jnp.asarray(excess))
    tst = tp.revert_promotions_plus(s.cfg, s.st, None, res,
                                    torch.from_numpy(excess))
    for f in FIELDS:
        np.testing.assert_array_equal(tst[f].numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    assert int(tst["free_top"]) == int(s.st["free_top"]) + int(excess.sum())
    q = tp.sketch_query_plus(s.cfg, tst, res.ids).numpy()
    assert ((q < 0) == (mask & ~excess)).all()


def test_cafe_part_end_to_end_routing():
    """tests/test_sketch_plus.py's CafePart case on both packages: one id
    promoted by four steps, the table and sketch equal after each."""
    from cafe_tpu.embeddings.cafe import CafePart as JPart
    from cafe_tpu_torch.embeddings.cafe import CafePart as TPart
    kw = dict(hotn=64, hash_sizes=[50], dim=4, sketch_threshold=2.0,
              sketch_decay=0.99, max_count=1000, plus=True)
    jp_, tp_ = JPart([0], [1000], [0], **kw), TPart([0], [1000], [0], **kw)
    tp_.device = torch.device("cpu")
    jstate = jp_.init(np.random.default_rng(0))
    tstate = tp_.init(np.random.default_rng(0))
    ids = np.array([[5]], np.int32)
    g = np.ones((1, 1, 4), np.float32)
    for _ in range(4):
        _, jaux = jp_.gather(jstate, jnp.asarray(ids))
        jstate, _ = jp_.apply_grads(jstate, jnp.asarray(ids),
                                    jnp.asarray(g), jaux, lr=0.01)
        _, taux = tp_.gather(tstate, torch.from_numpy(ids))
        tstate, _ = tp_.apply_grads(tstate, torch.from_numpy(ids),
                                    torch.from_numpy(g), taux, lr=0.01)
        np.testing.assert_allclose(tstate["table"].numpy(),
                                   np.asarray(jstate["table"]), atol=1e-7)
        for f in FIELDS:
            np.testing.assert_array_equal(
                tstate["sketch"][f].numpy(),
                np.asarray(getattr(jstate["sketch"], f)))
    _, (_, _, _, is_hot) = tp_.gather(tstate, torch.from_numpy(ids))
    assert bool(is_hot[0, 0])


# ---- the v1 sketch's probes (tests/test_sketch.py:123, :204)

def _v1_stream(cfg_kw, seed, n, b, vocab):
    jcfg = jhs.HotSketchConfig(**cfg_kw)
    jst = jhs.init_sketch(jcfg)
    rng = np.random.default_rng(seed)
    for _ in range(n):
        ids = rng.integers(0, vocab, size=b).astype(np.int32)
        jst, _ = jhs.sketch_insert(jcfg, jst, jnp.asarray(ids),
                                   jnp.ones(b, jnp.float32))
    tst = {f: torch.from_numpy(np.array(getattr(jst, f)))
           for f in jst._fields}
    return jcfg, jst, ths.HotSketchConfig(**cfg_kw), tst


def test_rebuild_free_list_matches_jax():
    jcfg, jst, tcfg, tst = _v1_stream(dict(buckets=64, threshold=2.0), 1,
                                      10, 32, 100)
    n_hot = int((tst["dic"] != 0).sum())
    jst2, tst2 = jhs.rebuild_free_list(jcfg, jst), \
        ths.rebuild_free_list(tcfg, tst)
    for f in jst._fields:
        np.testing.assert_array_equal(tst2[f].numpy(),
                                      np.asarray(getattr(jst2, f)))
    assert int(tst2["free_top"]) == tcfg.buckets - 1 - n_hot
    free = set(tst2["free"][: int(tst2["free_top"])].tolist())
    used = set(tst["dic"][tst["dic"] != 0].tolist())
    assert not (free & used) and 0 not in free


def test_analyse_probes_and_hot_fraction_match_jax():
    jcfg, jst, tcfg, tst = _v1_stream(dict(buckets=64, threshold=3.0), 2,
                                      0, 1, 1)
    hot = np.arange(10, 20, dtype=np.int32)
    for _ in range(4):
        ids = np.concatenate([hot, hot])
        jst, _ = jhs.sketch_insert(jcfg, jst, jnp.asarray(ids),
                                   jnp.ones(20, jnp.float32))
        tst, _ = ths.sketch_insert(tcfg, tst, torch.from_numpy(ids),
                                   torch.ones(20))
    cold = np.arange(5000, 5010, dtype=np.int32)
    mixed = np.concatenate([hot[:3], cold[:7]])
    for fn, want in ((ths.analyse, {0: 1.0, 1: 0.0}),
                     (ths.analyse_tracked, {0: 1.0, 1: 0.0})):
        jfn = getattr(jhs, fn.__name__)
        for k, ids in enumerate((hot, cold, mixed)):
            got = fn(tcfg, tst, torch.from_numpy(ids))
            assert got.dtype == torch.float32
            assert float(got) == float(jfn(jcfg, jst, jnp.asarray(ids)))
            if k in want:
                assert float(got) == want[k]
    frac = ths.hot_fraction(tcfg, tst)
    assert float(frac) == float(jhs.hot_fraction(jcfg, jst)) \
        == float(np.float32(10) / np.float32(63))


# ---- the conservative-update count-min sketch

def test_cu_sketch_matches_jax():
    cfg_kw = dict(rows=4, width=97)
    jcfg, tcfg = jcu.CUSketchConfig(**cfg_kw), tcu.CUSketchConfig(**cfg_kw)
    jst, tst = jcu.init_cu(jcfg), tcu.init_cu(tcfg, device="cpu")
    rng = np.random.default_rng(7)
    for i in range(8):
        ids = rng.zipf(1.3, 300).astype(np.int32) % 5000
        vals = None if i % 2 else rng.integers(1, 6, 300).astype(np.float32)
        jst = jcu.cu_insert(jcfg, jst, jnp.asarray(ids),
                            None if vals is None else jnp.asarray(vals))
        tst = tcu.cu_insert(tcfg, tst, torch.from_numpy(ids),
                            None if vals is None else torch.from_numpy(vals))
        np.testing.assert_array_equal(tst["cnt"].numpy(), np.asarray(jst.cnt))
    q = np.arange(0, 400, dtype=np.int32)
    est = tcu.cu_query(tcfg, tst, torch.from_numpy(q)).numpy()
    np.testing.assert_array_equal(est, np.asarray(jcu.cu_query(
        jcfg, jst, jnp.asarray(q))))
    assert (est >= 0).all() and est.max() > 0
