"""The port's unique-compact exchange (ops/sparse.unique_compact /
coalesce_compact and the compact branches of parallel/exchange.py's
sharded_fetch / sharded_apply) against the JAX package, on the CPU.

The JAX functions run on the virtual CPU mesh of tests/conftest.py; the
port runs one gloo process per rank (tests/torch_dist_worker.py).

Tolerances: compacted ids, inverse positions, distinct counts, branches
and every fetch are EXACT (integer logic and data movement). Coalesced
gradients within 1e-6 (the same sorted-lane sums). Sparse applies and
whole steps within 1e-5 of the JAX package (the ranks' duplicate rows
and dense gradients sum in another order); the compact branch within
3e-6 of the full-size one in the port, as the JAX package's own test
holds it.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu.ops import sparse as jsp
from cafe_tpu.ops.sparse import init_slots as jinit_slots
from cafe_tpu.parallel import exchange as jex
from cafe_tpu.parallel import make_mesh as jmake_mesh
from cafe_tpu_torch.ops import sparse as tsp
from cafe_tpu_torch.parallel import exchange as tex
from test_torch_sharded import SHARD, STEPS, _jax_run

torch.set_num_threads(1)

N = 4
DROP = int(tex.DROP_ROW)


def _ids(kind, m, seed):
    rng = np.random.default_rng(seed)
    if kind == "skewed":              # 100 distinct rows over all owners
        pool = rng.choice(1024, 100, replace=False)
        ids = pool[(rng.zipf(1.3, m) - 1) % 100]
    else:                             # near-uniform: ~m/2 distinct
        ids = rng.integers(0, 1024, m)
    ids = ids.astype(np.int32)
    ids[7::41] = DROP                 # padded lanes
    return ids


@pytest.mark.parametrize("kind,m,cap", [("skewed", 512, 128),
                                        ("uniform", 512, 128),
                                        ("uniform", 300, 320)])
def test_unique_and_coalesce_compact_match_jax(kind, m, cap):
    """Exact ids, inverse positions and distinct counts (an overflowing
    buffer too: the groups past the capacity are dropped); the summed
    gradients within 1e-6."""
    ids = _ids(kind, m, seed=m)
    g = np.random.default_rng(1).normal(size=(m, 8)).astype(np.float32)
    want = jsp.unique_compact(jnp.asarray(ids), cap, DROP)
    got = tsp.unique_compact(torch.from_numpy(ids), cap, DROP)
    for name, a, b in zip(("uids", "inv", "n_unique"), got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b),
                                      err_msg=name)
        assert a.dtype == torch.int32, name
    wc = jsp.coalesce_compact(jnp.asarray(ids), jnp.asarray(g), cap, DROP)
    gc = tsp.coalesce_compact(torch.from_numpy(ids), torch.from_numpy(g),
                              cap, DROP)
    np.testing.assert_array_equal(gc[0].numpy(), np.asarray(wc[0]))
    np.testing.assert_allclose(gc[1].numpy(), np.asarray(wc[1]), rtol=1e-6,
                               atol=1e-6)
    assert int(gc[2]) == int(wc[2])
    assert (int(got[2]) > cap) == (kind == "uniform" and cap < m)


# (ids kind, optimizer, unique fraction): per rank m = 64 x 8 = 512
# lanes, so frac 0.25 gives C = 128 and frac 0.5 C = 256; the skewed
# ids have at most 100 distinct values a rank (the compact branch), the
# uniform ones ~200 (over C = 128: the full-size fallback)
CASES = [("skewed", "sgd", 0.25), ("skewed", "adagrad", 0.5),
         ("uniform", "sgd", 0.25)]


def _case(kind, optimizer, frac, seed):
    rng = np.random.default_rng(seed)
    table = rng.normal(0, 1, (1024, 16)).astype(np.float32)
    idx = _ids(kind, 256 * 8, seed).reshape(256, 8)
    grad = rng.normal(0, 1, (256, 8, 16)).astype(np.float32)
    return table, idx, grad, 0.1, optimizer, frac


@pytest.fixture(scope="module")
def compact_runs(tmp_path_factory):
    cases = [_case(*c, seed=i) for i, c in enumerate(CASES)]
    ports = w.run_ranks(w.unique_exchanges, N,
                        tmp_path_factory.mktemp("uc"), cases)
    jmesh = jmake_mesh(N)
    runs = []
    for k, (table, idx, grad, lr, opt, frac) in enumerate(cases):
        def ref(jt, ji, jg):
            return {"fetch": jex.sharded_fetch(jmesh, jt, ji, frac),
                    "apply": jex.sharded_apply(
                        jmesh, jt, jinit_slots(jt, opt), ji, jg, lr, opt,
                        frac)}

        want = jax.device_get(jax.jit(ref)(*map(jnp.asarray,
                                                (table, idx, grad))))
        rows = np.where((idx < len(table))[..., None],
                        table[np.minimum(idx, len(table) - 1)], 0.0)
        runs.append(([p[k] for p in ports], want, rows))
    return runs


def _joined(ranks, tag, key):
    return np.concatenate([r[tag][key] for r in ranks])


@pytest.mark.parametrize("case", range(len(CASES)),
                         ids=[f"{k}-{o}-{f}" for k, o, f in CASES])
def test_compact_exchange_matches_jax_and_full(compact_runs, case):
    """4 gloo ranks against the JAX package's flat compact exchange: the
    fetch exact (and equal to table[idx], zero on padded lanes), the
    apply within 1e-5; the port's compact call against its own full-size
    call; and the branch every rank took."""
    ranks, want, rows = compact_runs[case]
    fetch = _joined(ranks, "compact", "fetch")
    np.testing.assert_array_equal(fetch, np.asarray(want["fetch"]))
    np.testing.assert_array_equal(fetch, rows)
    np.testing.assert_array_equal(fetch, _joined(ranks, "full", "fetch"))
    table = _joined(ranks, "compact", "table")
    np.testing.assert_allclose(table, np.asarray(want["apply"][0]),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(table, _joined(ranks, "full", "table"),
                               rtol=0, atol=3e-6)
    for slot, ref in want["apply"][1].items():
        got = np.concatenate([r["compact"]["slots"][slot] for r in ranks])
        np.testing.assert_allclose(got, np.asarray(ref), rtol=1e-5,
                                   atol=1e-5, err_msg=slot)
    branch = "compact" if CASES[case][0] == "skewed" else "full"
    for r in ranks:
        assert r["compact"]["branches"] == {f"fetch_{branch}": 1,
                                            f"apply_{branch}": 1}
        assert r["full"]["branches"] == {}


def test_compact_exchange_shrinks_the_largest_all_gather(compact_runs):
    """The port's counterpart of the JAX package's HLO A/B: on the skewed
    case at C = 128 of 512 lanes, the largest all-gather of the compact
    fetch and of the compact apply is >= 2x smaller than the full-size
    call's (4x here: [4 x 128] against [4 x 512] lanes), and so is the
    fetch's reduce-scatter of rows."""
    ranks, _, _ = compact_runs[0]
    for r in ranks:
        for leg in ("fetch_sizes", "apply_sizes"):
            for prim in ("_all_gather_single", "_reduce_scatter_single"):
                full = [b for n, b in r["full"][leg] if n == prim]
                comp = [b for n, b in r["compact"][leg] if n == prim]
                if not full:
                    continue
                assert comp and 2 * max(comp) <= max(full), (leg, prim)
        # the apply's grads: [4 x 128, 16] f32 against [4 x 512, 16]
        assert max(b for _, b in r["compact"]["apply_sizes"]) \
            == N * 128 * 16 * 4
        assert max(b for _, b in r["full"]["apply_sizes"]) \
            == N * 512 * 16 * 4


# whole sharded steps at 4 ranks with the compact exchange on: the JAX
# package's skewed-stream and overflow configurations (hash, 512-row
# batches: m = 512 lanes a rank; ~140 distinct rows at Zipf 1.5 against
# C = 256, 255-278 at Zipf 1.2 against C = 128), and CAFE v1, whose row
# legs take the compact exchange with no change to its part
STEP_BASE = dict(dataset="synthetic", synthetic_rows=4096,
                 synthetic_fields=4, synthetic_dense=4, synthetic_zipf=1.2,
                 embedding_dim=16, learning_rate=0.1, mini_batch_size=512,
                 compress_method="hash", compress_rate=0.2,
                 shard_embeddings=True, mesh_shape=N)
STEP_CASES = {
    "hash_skewed": dict(STEP_BASE, synthetic_vocab=20000,
                        synthetic_zipf=1.5, shard_unique_frac=0.5),
    "hash_overflow": dict(STEP_BASE, synthetic_vocab=2 ** 16,
                          shard_unique_frac=0.25),
    "cafe": dict(SHARD, mesh_shape=N, synthetic_zipf=1.5,
                 shard_unique_frac=0.5),
}


@pytest.fixture(scope="module")
def compact_steps(tmp_path_factory):
    jax_out, runs = {}, []
    for name, kw in STEP_CASES.items():
        jax_out[name], batches = _jax_run(kw, N, "explicit", STEPS)
        init = jax_out[name]["init"]
        runs += [(kw, init, batches, ("explicit",)),
                 (dict(kw, shard_unique_frac=0.0), init, batches,
                  ("explicit",))]
    port = w.run_ranks(w.train_runs, N, tmp_path_factory.mktemp("ranks"),
                       runs)[0]
    return jax_out, {name: (port[2 * i]["explicit"],
                            port[2 * i + 1]["explicit"])
                     for i, name in enumerate(STEP_CASES)}


def _close_tree(a, b, tol, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close_tree(a[k], b[k], tol, f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _close_tree(x, y, tol, f"{path}[{i}]")
    elif a is not None:
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=path)


@pytest.mark.parametrize("name", list(STEP_CASES))
def test_compact_steps_match_jax_and_full(compact_steps, name):
    """STEPS sharded steps from one bridged state: the port's compact run
    against the JAX package's (loss, state, routing within 1e-5, integer
    state exact) and against the port's full-size run (state within
    3e-6, loss within 1e-5 relative, as the JAX package's test holds
    them); the skewed streams take the compact branch on every leg, the
    overflowing one the full-size branch."""
    jax_out, port = compact_steps
    compact, full = port[name]
    ref = jax_out[name]
    assert compact["parts"] == ref["parts"]
    assert any(on for _, on in compact["parts"])
    for pm, jm, fm in zip(compact["metrics"], ref["metrics"],
                          full["metrics"]):
        np.testing.assert_allclose(pm["loss"], jm["loss"], rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_allclose(pm["loss"], fm["loss"], rtol=1e-5)
    _close_tree(compact["state"], ref["state"], 1e-5)
    _close_tree(compact["state"]["embed"], full["state"]["embed"], 3e-6)
    _close_tree(compact["aux"], ref["aux"], 1e-5)
    np.testing.assert_allclose(compact["scores"], ref["scores"], rtol=1e-5,
                               atol=1e-5)
    sharded = sum(on for _, on in compact["parts"])
    branch = "full" if name == "hash_overflow" else "compact"
    assert compact["branches"] == {f"fetch_{branch}": STEPS * sharded,
                                   f"apply_{branch}": STEPS * sharded}
    assert full["branches"] == {}
