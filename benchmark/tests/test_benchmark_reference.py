"""The plain reference against the port's CPU path at tiny sizes: the
sketch insert (every branch: placements, evictions, round 2, promotions
at the free-stack limit, decay), the warm sketch, and a whole run of a
cell judged correct."""

import time

import numpy as np
import pytest
import torch

from benchmark import core, warm, weights
from benchmark.cell import Run
from benchmark.counts.layout import layout
from benchmark.reference.sketch import INVALID_ID, Sketch
from benchmark.tests import tiny


def _port_sketch(s, threshold, decay):
    from cafe_tpu_torch.sketch.hotsketch import HotSketchConfig, init_sketch
    cfg = HotSketchConfig(buckets=s, threshold=threshold, decay=decay,
                          land_impl="auto", max_id=1 << 20)
    return cfg, init_sketch(cfg, "cpu")


@pytest.mark.parametrize("s,threshold,lanes,vocab", [
    (37, 6.0, 300, 400),      # crowded buckets: evictions, round 2
    (64, 3.0, 500, 90),       # few ids: promotions until the stack empties
    (512, 40.0, 4500, 3000),  # more lanes than PROMO_LANES
])
def test_benchmark_sketch_matches_the_port(s, threshold, lanes, vocab):
    from cafe_tpu_torch.sketch.hotsketch import sketch_insert
    cfg, st = _port_sketch(s, threshold, 0.9)
    ref = Sketch(s, threshold, 0.9, free_len=st["free"].shape[0])
    rng = np.random.default_rng(s)
    for step in range(12):
        ids = (rng.random(lanes) ** 3 * vocab).astype(np.int64)
        ids[rng.random(lanes) < 0.02] = INVALID_ID
        sc = rng.gamma(2.0, 0.7, lanes).astype(np.float32)
        st, res = sketch_insert(cfg, st, torch.from_numpy(ids).int(),
                                torch.from_numpy(sc))
        promos = ref.insert(ids, sc)
        n = int(res.mask.sum())
        assert n == len(promos), step
        assert res.ids[:n].tolist() == [p[0] for p in promos]
        assert res.slots[:n].tolist() == [p[1] for p in promos]
        assert np.array_equal(st["val"][:s].numpy(), ref.val)
        assert np.array_equal(st["dic"][:s].numpy(), ref.dic)
        # the port sums a group's scores as a difference of two f32
        # prefix sums over the batch, off by a few ulps of the batch's
        # total; a cell's count carries that from every step
        tol = (step + 1) * 4 * float(np.spacing(np.float32(sc.sum())))
        np.testing.assert_allclose(st["cnt"][:s].numpy(), ref.cnt,
                                   rtol=1e-6, atol=tol)
        assert int(st["free_top"]) == ref.free_top
        top = ref.free_top
        assert np.array_equal(st["free"][:top].numpy(), ref.free[:top])
        q = np.arange(vocab)
        want = ref.query(q)
        from cafe_tpu_torch.sketch.hotsketch import sketch_query
        got = -sketch_query(cfg, st, torch.from_numpy(q).int()).numpy()
        assert np.array_equal(np.where(got > 0, got, 0), want)


def test_benchmark_sketch_decays_as_the_port():
    from cafe_tpu_torch.sketch.hotsketch import sketch_insert
    cfg, st = _port_sketch(16, 2.0, 0.5)
    ref = Sketch(16, 2.0, 0.5, free_len=st["free"].shape[0])
    rng = np.random.default_rng(1)
    decays = 0
    for _ in range(30):
        ids = rng.integers(0, 60, 200)
        sc = rng.gamma(2.0, 0.5, 200).astype(np.float32)
        before = ref.tot
        st, _ = sketch_insert(cfg, st, torch.from_numpy(ids).int(),
                              torch.from_numpy(sc))
        ref.insert(ids, sc)
        decays += before > 16 * 2.0 * 10
        assert np.array_equal(st["dic"][:16].numpy(), ref.dic)
        assert int(st["free_top"]) == ref.free_top
    assert decays >= 3


def test_benchmark_weights_are_set_by_the_seed():
    lay = layout(tiny.TINY_CONF)
    a = weights.make(lay, 2**40 + 3, "cpu")
    b = weights.make(lay, 2**40 + 3, "cpu")
    scratch = torch.empty(weights.CHUNK_ELEMS)
    for name, _ in weights.leaves(lay):
        assert torch.equal(a[name], b[name])
        assert weights.change_norm(lay, 2**40 + 3, name, a[name],
                                   scratch) == 0.0
    c = lay["cafe"]
    t = a["cafe.table"]
    assert float(t[c["hotn"]:c["hash_base"]].abs().max()) == 0.0
    bound = (1.0 / c["max_count"]) ** 0.5
    assert float(t[:c["hotn"]].abs().max()) <= bound
    t[3] += 1.0
    assert abs(weights.change_norm(lay, 2**40 + 3, "cafe.table", t, scratch)
               - lay["dim"] ** 0.5) < 1e-5


@pytest.mark.parametrize("k,interval", [(1, 1), (2, 2)])
def test_benchmark_train_run_on_the_port_is_correct(k, interval):
    man = tiny.manifest(["c"])
    run = Run(man, {"name": "c"}, tiny.TINY_CONF,
              tiny.train_traffic(k=k, interval=interval), tiny.TRAIN_LIMITS,
              2**33 + 5, 0.3, False, "cpu", time.perf_counter())
    res = run.run()
    assert res["correct"], res["checks"]
    assert res["attempted"] >= 1
    assert set(res["metrics"]) == {"train_examples_per_s",
                                   "train_step_p95_ms", "setup_s"}
    assert list(res)[-1] == "checks"


def test_benchmark_traced_run_reports_the_trace():
    traffic = tiny.train_traffic(k=2, interval=2)
    run = Run(tiny.manifest(["c"]), {"name": "c"}, tiny.TINY_CONF, traffic,
              tiny.TRAIN_LIMITS, 31, 0.2, True, "cpu", time.perf_counter())
    res = run.run()
    assert res["correct"], res["checks"]
    assert set(res["device"]) >= {"busy_s", "window_s"}
    assert res["device"]["window_s"] > 0
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    # on the CPU only the host's metric reads; the device's read nothing
    assert set(res["metrics"]) == {"train_dispatch_host_ms"}


def _warm(traffic, seed=2**35 + 9):
    lay = layout(tiny.TINY_CONF)
    gen = core.generator(traffic["generator"])
    return lay, warm.warm_sketch(lay, traffic, gen, seed, 4, "cpu")


@pytest.mark.parametrize("k,interval", [(1, 1), (2, 2), (8, 1), (8, 8)])
def test_benchmark_warm_sketch_decays_in_the_third_call(k, interval):
    traffic = tiny.train_traffic(k=k, interval=interval)
    lay, st = _warm(traffic)
    c = lay["cafe"]
    decay_at = np.float32(c["hotn"]) * np.float32(c["threshold"]) * 10
    m = traffic["batch"] * interval * c["lanes_per_row"]
    n = warm.decay_insert(traffic)
    # the n-th insert (from 0) is the first that finds the mass past it
    assert st["tot"] + (n - 1) * m <= decay_at < st["tot"] + n * m
    ticks = [t for t in range(3 * k) if t % interval == 0]
    assert 2 * k <= ticks[n] < 3 * k


def test_benchmark_warm_sketch_is_whole_and_set_by_the_seed():
    traffic = tiny.train_traffic()
    lay, st = _warm(traffic)
    _, again = _warm(traffic)
    _, other = _warm(traffic, seed=5)
    for name in ("val", "cnt", "dic", "free"):
        assert np.array_equal(st[name], again[name])
    assert not np.array_equal(st["dic"], other["dic"])
    s = lay["cafe"]["hotn"]
    cnt, dic = st["cnt"], st["dic"]
    k = np.float32(lay["cafe"]["threshold"])
    hot = dic[dic != 0]
    # every slot once: held by a cell at or above k, or on the free stack
    assert (cnt[dic != 0] >= k).all() and (cnt[dic == 0] >= 0).all()
    slots = np.concatenate([hot, st["free"][:st["free_top"]]])
    assert np.array_equal(np.sort(slots), np.arange(1, s))
    assert hot.size == int(traffic["warm_hot_share"] * (s - 1))
    # an id sits in one cell of its own bucket
    occ = cnt > 0
    b = warm._bucket(torch.from_numpy(st["val"][occ]), s).numpy()
    assert np.array_equal(b, np.nonzero(occ)[0])
    assert np.unique(st["val"][occ]).size == int(occ.sum())


def test_benchmark_warm_sketch_loads_alike_in_the_port_and_the_reference():
    from cafe_tpu_torch.sketch.hotsketch import sketch_query
    from benchmark.systems.dlrm_cafe import System
    traffic = tiny.train_traffic()
    lay, st = _warm(traffic)
    sysm = System(tiny.TINY_CONF, lay, weights.make(lay, 3, "cpu"), {},
                  "cpu")
    sysm.load_sketch(st)
    ref = Sketch(lay["cafe"]["hotn"], lay["cafe"]["threshold"], 0.99)
    ref.load(st)
    part = next(p for p in sysm.embed.parts if hasattr(p, "sketch_cfg"))
    q = np.arange(lay["cafe"]["max_id"])
    got = -sketch_query(part.sketch_cfg, sysm.sketch(),
                        torch.from_numpy(q).int()).numpy()
    want = ref.query(q)
    assert (want > 0).sum() == (st["dic"] != 0).sum()
    assert np.array_equal(np.where(got > 0, got, 0), want)
