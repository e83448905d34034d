"""The port's flat sharded exchange (parallel/exchange.py), its
shard-local sketch layout (sketch/sharded.py) and K5's plain version
(kernels/a2a.py) against the JAX package, on the CPU.

The JAX functions run on the virtual CPU mesh of tests/conftest.py; the
port runs one gloo process per rank (tests/torch_dist_worker.py), each on
its row shard and batch slice, and the parent joins the ranks' outputs.

Tolerances: routing, capacities, the sketch layout and every fetch are
EXACT (integer logic and data movement), and so is rows-Adam's step
count. Sparse applies sum the duplicate rows of different ranks in
another order: within 1e-5 (|grads| ~ 1, lr 0.1, a few duplicates per
row).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from jax.sharding import Mesh as JMesh, NamedSharding, PartitionSpec as P

import torch_dist_worker as w
from cafe_tpu.ops.pallas_a2a import pallas_all_to_all
from cafe_tpu.ops.sparse import init_slots as jinit_slots
from cafe_tpu.parallel import make_mesh as jmake_mesh
from cafe_tpu.parallel import exchange as jex
from cafe_tpu.sketch import sharded as jsh
from cafe_tpu.sketch.hotsketch import HotSketchConfig as JConfig
from cafe_tpu_torch.parallel import exchange as tex
from cafe_tpu_torch.sketch import sharded as tsh
from cafe_tpu_torch.sketch.hotsketch import HotSketchConfig as TConfig

torch.set_num_threads(1)

N = 4


def _route_case(kind, n, rows_l, m, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "overflow":               # every lane on owner 0
        flat = rng.integers(0, rows_l, m)
    else:
        flat = rng.integers(0, n * rows_l, m)
    flat = flat.astype(np.int32)
    flat[5::37] = jex.DROP_ROW           # padded lanes: never shipped
    return flat


@pytest.mark.parametrize("kind,n,rows_l,m", [
    ("uniform", 4, 256, 512), ("uniform", 8, 128, 256),
    ("uniform", 1, 1024, 300), ("overflow", 4, 256, 512)])
def test_route_to_owners_exact(kind, n, rows_l, m):
    flat = _route_case(kind, n, rows_l, m)
    cap = jex.a2a_cap(m, n)
    assert tex.a2a_cap(m, n) == cap
    want = jex.route_to_owners(jnp.asarray(flat), rows_l, n, cap)
    got = tex.route_to_owners(torch.from_numpy(flat), rows_l, n, cap)
    for name, g, j in zip(("reqs", "owner", "slot", "overflow"), got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(j),
                                      err_msg=name)
    assert bool(got[3]) == (kind == "overflow")


def test_caps_match():
    for m in (1, 64, 127, 128, 512, 13312, 53248):
        for n in (1, 2, 3, 4, 8):
            for slack in (0.2, 1.0, 1.5):
                assert tex.a2a_cap(m, n, slack) == jex.a2a_cap(m, n, slack)
        for frac in (0.0, 0.1, 0.5, 1.0):
            assert tex.unique_cap(m, frac) == jex.unique_cap(m, frac)


def test_shard_of_bit_exact():
    rng = np.random.default_rng(1)
    ids = np.concatenate([rng.integers(0, 2**31 - 1, 5000),
                          [0, 1, 2**31 - 2, 2**31 - 1, 65535, 65536]])
    ids = ids.astype(np.int32)
    for n in (1, 2, 3, 4, 8):
        np.testing.assert_array_equal(
            tsh.shard_of(torch.from_numpy(ids), n).numpy(),
            np.asarray(jsh.shard_of(jnp.asarray(ids), n)))


@pytest.mark.parametrize("buckets", [9646, 600, 1000])
@pytest.mark.parametrize("n", [1, 2, 4])
def test_local_config_and_init_sharded_sketch(buckets, n):
    tcfg = TConfig(buckets=buckets, threshold=3.0)
    jcfg = JConfig(buckets=buckets, threshold=3.0)
    tl, ts = tsh.local_config(tcfg, n)
    jl, js = jsh.local_config(jcfg, n)
    assert ts == js and tl.buckets == jl.buckets
    got = tsh.init_sharded_sketch(tcfg, n, device="cpu")
    want = jsh.init_sharded_sketch(jcfg, n)._asdict()
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                      err_msg=k)
        assert got[k].numpy().dtype == np.asarray(want[k]).dtype
    local = tsh.shard_local_view({k: v[:1] if v.dim() == 1 and
                                  v.shape[0] == n else v
                                  for k, v in got.items()})
    assert local["free_top"].dim() == 0 and local["tot"].dim() == 0
    back = tsh.shard_global_view(local)
    assert back["free_top"].shape == (1,)


def test_local_config_refuses_indivisible():
    for mod in (tsh, jsh):
        cfg = (TConfig if mod is tsh else JConfig)(buckets=600, threshold=1.)
        with pytest.raises(ValueError, match="not divisible"):
            mod.local_config(cfg, 3)


def test_query_sharded_exact():
    """A filled sharded layout (random ids, counts and slots in every
    shard's buckets): the one-process query routes like the JAX one."""
    rng = np.random.default_rng(2)
    n, buckets = 4, 1000
    cfg_t, cfg_j = TConfig(buckets, 3.0), JConfig(buckets, 3.0)
    st = {k: np.array(v) for k, v in
          jsh.init_sharded_sketch(cfg_j, n)._asdict().items()}
    ids = rng.integers(0, 50000, 4000).astype(np.int32)
    # place a third of the ids in their own bucket's first cell
    _, s_l = jsh.local_config(cfg_j, n)
    lcfg = cfg_j._replace(buckets=s_l)
    from cafe_tpu.sketch.hotsketch import _bucket_of
    rows = np.asarray(_bucket_of(lcfg, jnp.asarray(ids))
                      + jsh.shard_of(jnp.asarray(ids), n) * s_l)
    for i, (idv, r) in enumerate(zip(ids[::3], rows[::3])):
        cell = i % 4
        st["val"][r, cell] = idv
        st["cnt"][r, cell] = float(rng.integers(1, 9))
        st["dic"][r, cell] = int(rng.integers(0, s_l))
    want = jsh.query_sharded(cfg_j, n, jsh.HotSketchState(
        **{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(ids))
    got = tsh.query_sharded(cfg_t, n, {k: torch.from_numpy(v)
                                       for k, v in st.items()},
                            torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) < 0).any()


def test_sharded_plus_layout_and_query_exact():
    """The sharded CAFE+ layout: init bit-equal to the JAX package's
    (exact-size tiers, [n] scalar lanes), local_config_plus equal and
    refusing an indivisible lim, and the one-process query over a filled
    layout (ids placed in their shard's tier-1 or tier-2 bucket with
    random counts and slots) routes like the JAX one."""
    from cafe_tpu.sketch.hotsketch_plus import (CafePlusConfig as JPlus,
                                                _h1, _h2)
    from cafe_tpu_torch.sketch.hotsketch_plus import CafePlusConfig as TPlus
    rng = np.random.default_rng(3)
    n = 4
    cfg_j, cfg_t = JPlus(lim=1000, threshold=3.0), TPlus(lim=1000,
                                                        threshold=3.0)
    assert tsh.local_config_plus(cfg_t, n)[0]._asdict() == \
        jsh.local_config_plus(cfg_j, n)[0]._asdict()
    for mod, cfg in ((tsh, cfg_t), (jsh, cfg_j)):
        with pytest.raises(ValueError, match="not divisible"):
            mod.local_config_plus(cfg, 3)
    jst = jsh.init_sharded_sketch_plus(cfg_j, n)
    tst = tsh.init_sharded_sketch_plus(cfg_t, n, device="cpu")
    assert list(tst) == list(jst._fields)
    for f in jst._fields:
        np.testing.assert_array_equal(tst[f].numpy(),
                                      np.asarray(getattr(jst, f)), err_msg=f)
    st = {k: np.array(v) for k, v in jst._asdict().items()}
    lcfg, s_l = jsh.local_config_plus(cfg_j, n)
    ids = rng.integers(0, 50000, 4000).astype(np.int32)
    shard = np.asarray(jsh.shard_of(jnp.asarray(ids), n))
    r1 = np.asarray(_h1(lcfg, jnp.asarray(ids))) + shard * lcfg.n1
    r2 = np.asarray(_h2(lcfg, jnp.asarray(ids))) + shard * lcfg.n2
    for i, idv in enumerate(ids[::3]):
        tier, r = ("1", r1[3 * i]) if i % 2 else ("2", r2[3 * i])
        cell = i % 4
        st["val" + tier][r, cell] = idv
        st["cnt" + tier][r, cell] = float(rng.integers(0, 9))
        st["dic" + tier][r, cell] = int(rng.integers(0, s_l))
    want = jsh.query_sharded_plus(cfg_j, n, type(jst)(
        **{k: jnp.asarray(v) for k, v in st.items()}), jnp.asarray(ids))
    got = tsh.query_sharded_plus(cfg_t, n, {k: torch.from_numpy(v)
                                            for k, v in st.items()},
                                 torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (np.asarray(want) < 0).any()


def test_a2a_plain_bit_equal_to_pallas_interpret(tmp_path):
    """K5's plain version (the wrapper on CPU tensors, so no launch) in 4
    gloo ranks against the JAX Pallas kernel in interpret mode at
    (n, C, D) = (4, 8, 16): bit-equal."""
    n, c, d = 4, 8, 16
    rng = np.random.default_rng(0)
    x = rng.standard_normal((n * n, c, d), dtype=np.float32)
    jmesh = JMesh(np.array(jax.devices()[:n]), ("x",))
    want = np.asarray(pallas_all_to_all(
        jax.device_put(jnp.asarray(x), NamedSharding(jmesh, P("x"))),
        jmesh, "x", interpret=True))
    res = w.run_ranks(w.a2a_plain, n, tmp_path, x)
    got = np.concatenate([r["out"] for r in res])
    np.testing.assert_array_equal(got, want)
    for r in res:
        assert r["launches"] == 0
        np.testing.assert_array_equal(r["plain"], r["out"])


def _exchange_case(optimizer, skew, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (1024, 16)).astype(np.float32)
    hi = 256 if skew else 1024           # skew: every id on owner 0
    idx = rng.integers(0, hi, (256, 8)).astype(np.int32)
    grad = rng.normal(0, 1, (256, 8, 16)).astype(np.float32)
    return table, idx, grad, 0.1, optimizer, 1.5


CASES = [("sgd", False), ("adagrad", False), ("adam", False),
         ("sgd", True)]


@pytest.fixture(scope="module")
def exchange_runs(tmp_path_factory):
    cases = [_exchange_case(o, s, i) for i, (o, s) in enumerate(CASES)]
    ports = w.run_ranks(w.exchange_cases, N, tmp_path_factory.mktemp("ex"),
                        cases)
    jmesh = jmake_mesh(N)
    runs = []
    for k, (table, idx, grad, lr, opt, slack) in enumerate(cases):
        port = {key: [p[k][key] for p in ports] for key in ports[0][k]}

        def ref(jt, ji, jg):
            # one jitted program: eager shard_map calls compile one each
            return {"fetch": jex.sharded_fetch(jmesh, jt, ji),
                    "fetch_a2a": jex.sharded_fetch_a2a(jmesh, jt, ji,
                                                       slack=slack),
                    "apply": jex.sharded_apply(
                        jmesh, jt, jinit_slots(jt, opt), ji, jg, lr, opt),
                    "apply_a2a": jex.sharded_apply_a2a(
                        jmesh, jt, jinit_slots(jt, opt), ji, jg, lr, opt,
                        slack=slack)}

        want = jax.device_get(jax.jit(ref)(*map(jnp.asarray,
                                                (table, idx, grad))))
        runs.append((port, dict(want, rows=table[idx]), idx))
    return runs


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{o}{'-skew' if s else ''}" for o, s in CASES])
def test_fetches_bit_equal(exchange_runs, case):
    port, want, _ = exchange_runs[case]
    for key, ref in (("fetch", "fetch"), ("fetch_a2a_lax", "fetch_a2a"),
                     ("fetch_a2a_pallas", "fetch_a2a")):
        got = np.concatenate(port[key])
        np.testing.assert_array_equal(got, np.asarray(want[ref]),
                                      err_msg=key)
        np.testing.assert_array_equal(got, want["rows"], err_msg=key)
    # owner_lookup_1d: every rank gets the whole batch's values of a
    # row-sharded 1-D array
    for got in port["lookup"]:
        np.testing.assert_array_equal(got, want["rows"][..., 0].reshape(-1))


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{o}{'-skew' if s else ''}" for o, s in CASES])
def test_applies_match(exchange_runs, case):
    port, want, idx = exchange_runs[case]
    if CASES[case][1]:
        # the skewed ids overflow the per-peer capacity on every rank:
        # the a2a apply took the explicit path
        m = idx.size // N
        cap = tex.a2a_cap(m, N)
        flat = torch.from_numpy(idx[: idx.shape[0] // N].reshape(-1))
        assert bool(tex.route_to_owners(flat, 256, N, cap)[3])
    for key, ref in (("apply", "apply"), ("apply_a2a_lax", "apply_a2a"),
                     ("apply_a2a_pallas", "apply_a2a")):
        table = np.concatenate([t for t, _ in port[key]])
        np.testing.assert_allclose(table, np.asarray(want[ref][0]),
                                   rtol=1e-5, atol=1e-5, err_msg=key)
        for slot, ref_slot in want[ref][1].items():
            if np.ndim(ref_slot) == 0:
                # rows-Adam's step count: replicated, on every rank
                for _, s in port[key]:
                    assert s[slot] == ref_slot, (key, slot)
                continue
            got = np.concatenate([s[slot] for _, s in port[key]])
            np.testing.assert_allclose(got, np.asarray(ref_slot),
                                       rtol=1e-5, atol=1e-5, err_msg=slot)


def test_mesh_refusals(tmp_path):
    """make_mesh refuses a mesh_inner that does not divide the mesh, as
    the JAX package does, and a size other than the world's, as the JAX
    package refuses more devices than it has."""
    for res in w.run_ranks(w.mesh_errors, 2, tmp_path):
        assert res["inner"].startswith("ValueError") \
            and "does not divide" in res["inner"]
        assert res["size"].startswith("ValueError")
