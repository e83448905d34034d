"""The port's device branches (utils/cond.cond, the counterpart of
`lax.cond`; a conditional node in a CUDA graph on the card) against the
JAX package on the CPU, from numpy-made inputs and bridged states:

* `cond` itself: both branches, nested, trees of outputs, a warm-up
  call that also runs the untaken branch on clones of its operands, no
  else branch, and the runs of a freed graph's bodies still counted;
* cafe_insert_interval 8 over 16 steps, v1 and CAFE+: every sketch
  field, the promotions and the tick exactly equal, tables within f32
  bounds; CAFE+ with its reset firing: the integer state exact;
* sparse_adagrad / sparse_adam at a fixed shape against
  cafe_tpu/ops/sparse.py with duplicate, negative (wrapping, as its
  mode="drop" scatters wrap them; the SGD arms drop them, as
  tests/test_torch_rowsum.py holds) and out-of-range ids: within 1e-6
  relative;
* AdaEmbed across a check step and a decay step: dic exact, grad_norm
  within f32 bounds, eagerly and in a warm-up call.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.ops import sparse as jsparse
from cafe_tpu_torch.embeddings.ada import CHECK_EVERY, DECAY_EVERY
from cafe_tpu_torch.ops import sparse as tsparse
from cafe_tpu_torch.utils.cond import branch_runs, cond, warming
from test_torch_cafe_plus import PLUS
from test_torch_methods import _ada_pair
from test_torch_train import SMALL, _close, _run

torch.set_num_threads(1)

# at least 16 train batches of 128 rows
IV8 = {"v1": dict(SMALL, synthetic_rows=2560, cafe_insert_interval=8),
       "plus": dict(PLUS, synthetic_rows=2560, cafe_insert_interval=8)}


# ---------------------------------------------------------------- cond

def _nested(x, flag):
    def inner(y):
        return cond(y.sum() > 0, lambda z: (z * 2.0, {"n": z.sum()}),
                    lambda z: (z - 1.0, {"n": -z.sum()}), (y,),
                    name="test_inner")

    return cond(flag > 0, inner,
                lambda y: (y * 0.5, {"n": torch.zeros(())}), (x,),
                name="test_outer")


@pytest.mark.parametrize("v,flag", [(1.0, 1), (-1.0, 1), (1.0, 0),
                                    (-2.0, 0)])
def test_cond_takes_each_branch_nested(v, flag):
    x = torch.full((3,), v)
    out, aux = _nested(x, torch.tensor(flag))
    if flag:
        want = (x * 2.0, x.sum()) if v > 0 else (x - 1.0, -x.sum())
    else:
        want = (x * 0.5, torch.zeros(()))
    assert torch.equal(out, want[0]) and torch.equal(aux["n"], want[1])


def test_cond_counts_its_runs_and_warms_the_other_branch():
    """An eager call counts the branch it took; a warm-up call also runs
    the untaken one, on clones, so an in-place branch leaves the
    operands as the taken branch left them."""
    def bump(t):
        t.add_(1.0)

    def keep(t):
        return None

    x = torch.zeros(2)
    runs0 = branch_runs()
    cond(torch.tensor(False), bump, keep, (x,), name="test_bump")
    assert torch.equal(x, torch.zeros(2))
    with warming():
        cond(torch.tensor(False), bump, keep, (x,), name="test_bump")
    assert torch.equal(x, torch.zeros(2))          # bump ran on a clone
    with warming():
        cond(torch.tensor(True), bump, keep, (x,), name="test_bump")
    assert torch.equal(x, torch.ones(2))
    runs = branch_runs()

    def delta(kind):
        return [a - b for a, b in zip(
            runs[kind]["test_bump"], runs0[kind].get("test_bump", [0, 0]))]

    assert delta("eager") == [2, 1]
    assert delta("spare") == [1, 1]


def test_cond_without_else_writes_in_place():
    """false_fn None: the true branch writes into its operands and
    returns None; the untaken branch runs nothing, and a warm-up call
    runs the true branch on clones when it is not taken."""
    def bump(t):
        t.add_(1.0)

    x = torch.zeros(2)
    runs0 = branch_runs()
    assert cond(torch.tensor(False), bump, None, (x,),
                name="test_noelse") is None
    with warming():
        cond(torch.tensor(False), bump, None, (x,), name="test_noelse")
    assert torch.equal(x, torch.zeros(2))          # bump ran on a clone
    with warming():
        cond(torch.tensor(True), bump, None, (x,), name="test_noelse")
    assert cond(torch.tensor(True), bump, None, (x,),
                name="test_noelse") is None
    assert torch.equal(x, torch.full((2,), 2.0))
    runs = branch_runs()
    delta = {k: [a - b for a, b in zip(runs[k]["test_noelse"], runs0[k].get(
        "test_noelse", [0, 0]))] for k in ("eager", "spare")}
    assert delta == {"eager": [2, 2], "spare": [0, 1]}


class _NoGraph:
    """A captured graph's stand-in: its replay runs nothing."""

    def replay(self):
        pass


def test_a_freed_graphs_body_runs_still_count():
    """A graph's branch bodies are credited at the next count read, even
    when the graph (and the step that held it) is gone by then."""
    import gc

    from cafe_tpu_torch.kernels import KERNELS
    from cafe_tpu_torch.train.capture import _Graph
    from cafe_tpu_torch.utils.cond import _Body, _Capture

    k1 = KERNELS["land_max"]
    launches0, in_graphs0 = k1.launches, k1.graph_launches
    runs0 = branch_runs()["graph"].get("test_freed", [0, 0])
    cap = _Capture("cpu")
    cap.bodies.append(_Body("test_freed", 1, 0, {k1: 2}))
    cap.slots = 1
    g = _Graph(_NoGraph(), [], None, {}, 0.0, cap)
    for _ in range(3):
        cap.hits[0] += 1             # the body ran in this replay
        g.replay()
    del g, cap
    gc.collect()
    try:
        assert k1.launches - launches0 == 6
        assert k1.graph_launches - in_graphs0 == 6
        assert branch_runs()["graph"]["test_freed"][1] - runs0[1] == 3
    finally:
        k1.launches, k1.graph_launches = launches0, in_graphs0


# ------------------------------------------------- the skipped insert

@pytest.fixture(scope="module", params=sorted(IV8))
def iv8_run(request):
    kw = IV8[request.param]
    runs0 = branch_runs()["eager"].get("cafe_insert", [0, 0])
    out = _run(kw, 16)
    runs = branch_runs()["eager"]["cafe_insert"]
    return request.param, out, [a - b for a, b in zip(runs, runs0)]


def test_interval8_matches_jax(iv8_run):
    name, (_, jout, tout, *_), runs = iv8_run
    assert len(tout) == 16
    assert runs == [14, 2]                       # inserts at ticks 0, 8
    for i, ((js, jm), (ts, tm)) in enumerate(zip(jout, tout)):
        jp, tp = js["embed"]["part0"], ts["embed"]["part0"]
        assert int(tp["tick"]) == int(jp["tick"]) == i + 1
        assert tm["cafe_promotions"] == jm["cafe_promotions"], i
        if i % 8:
            assert tm["cafe_promotions"] == 0
        assert set(tp["sketch"]) == set(jp["sketch"])
        for f, want in jp["sketch"].items():
            np.testing.assert_array_equal(tp["sketch"][f], want,
                                          err_msg=f"{name} {f} step {i}")
        np.testing.assert_allclose(tp["table"], jp["table"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i} table")
        _close(ts["params"], js["params"], 1e-5, f"step {i} params")
    assert sum(m["cafe_promotions"] for _, m in tout) > 0


def _int_leaves(tree, path=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _int_leaves(tree[k], f"{path}/{k}")]
    arr = np.asarray(tree)
    return [(path, arr)] if arr.dtype.kind in "iub" else []


def test_plus_reset_fires_and_integer_state_exact():
    """Threshold 1: every placed id crosses at once, real_n passes 1.2 x
    lim and the reset's branch runs; every integer leaf of the state
    equals the JAX package's at every step."""
    runs0 = branch_runs()["eager"].get("plus_reset", [0, 0])[1]
    _, jout, tout, *_ = _run(PLUS, 6)
    assert branch_runs()["eager"]["plus_reset"][1] > runs0
    for i, ((js, _), (ts, _)) in enumerate(zip(jout, tout)):
        jl, tl = _int_leaves(js["embed"]), _int_leaves(ts["embed"])
        assert [p for p, _ in jl] == [p for p, _ in tl]
        for (path, want), (_, got) in zip(jl, tl):
            np.testing.assert_array_equal(got, want,
                                          err_msg=f"{path} step {i}")


# ------------------------------------------------- Adagrad and Adam

@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_fixed_shape_rows_match_jax(optimizer):
    """Three updates of a 50-row table by 300 lanes drawn from [-60,
    60): duplicates, negative ids that wrap (some onto ids of the same
    batch) and ids past either end."""
    rng = np.random.default_rng(3)
    n, d, b, lr = 50, 4, 300, 0.05
    table = rng.normal(0, 1, (n, d)).astype(np.float32)
    jt = jnp.asarray(table)
    tt = torch.from_numpy(table.copy())
    js, ts = jsparse.init_slots(jt, optimizer), \
        tsparse.init_slots(tt, optimizer)
    for _ in range(3):
        ids = rng.integers(-n - 10, n + 10, b).astype(np.int32)
        assert (ids < -n).any() and (ids >= n).any()
        assert np.isin(ids[ids < 0] + n, ids).any()
        g = rng.normal(0, 1, (b, d)).astype(np.float32)
        ji, jg = jnp.asarray(ids), jnp.asarray(g)
        ti, tg = torch.from_numpy(ids), torch.from_numpy(g)
        if optimizer == "adagrad":
            jt, acc = jsparse.sparse_adagrad(jt, js["acc"], ji, jg, lr)
            js = {"acc": acc}
            tt, acc = tsparse.sparse_adagrad(tt, ts["acc"], ti, tg, lr)
            ts = {"acc": acc}
        else:
            jt, m, v, t = jsparse.sparse_adam(jt, js["m"], js["v"],
                                              js["t"], ji, jg, lr)
            js = {"m": m, "v": v, "t": t}
            tt, m, v, t = tsparse.sparse_adam(tt, ts["m"], ts["v"],
                                              ts["t"], ti, tg, lr)
            ts = {"m": m, "v": v, "t": t}
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6,
                               atol=1e-7)
    for k in js:
        np.testing.assert_allclose(ts[k].numpy(), np.asarray(js[k]),
                                   rtol=1e-6, atol=1e-7, err_msg=k)


# ------------------------------------------------------------ AdaEmbed

@pytest.mark.parametrize("warm", [False, True])
def test_ada_across_a_check_and_a_decay_step(warm):
    """From step DECAY_EVERY - 3 four apply_grads: the decay and the
    check (nothing admitted, so it rebuilds whatever the sample) fire at
    step 16,384 in both packages; a warm-up call, which also runs each
    untaken branch on clones, gives the same state."""
    assert DECAY_EVERY % CHECK_EVERY == 0
    jp, tp, jstate, tstate = _ada_pair([3000, 2000], hotn=400)
    rng = np.random.default_rng(5)
    gn = tstate["grad_norm"].numpy().copy()
    gn[:5000] = rng.random(5000).astype(np.float32)
    start = DECAY_EVERY - 3
    jstate = {**jstate, "grad_norm": jnp.asarray(gn),
              "step": jnp.asarray(start, jnp.int32)}
    tstate = {**tstate, "grad_norm": torch.from_numpy(gn.copy()),
              "step": torch.tensor(start, dtype=torch.int32)}
    japply = jax.jit(lambda s, ids, g, a: jp.apply_grads(s, ids, g, a, 0.1))
    for i in range(4):
        ids = rng.integers(0, 2000, (32, 2)).astype(np.int32)
        g = rng.normal(size=(32, 2, 4)).astype(np.float32)
        _, jaux = jp.gather(jstate, jnp.asarray(ids))
        jstate, jm = japply(jstate, jnp.asarray(ids), jnp.asarray(g), jaux)
        _, taux = tp.gather(tstate, torch.from_numpy(ids))
        if warm:
            with warming():
                tstate, tm = tp.apply_grads(tstate, torch.from_numpy(ids),
                                            torch.from_numpy(g), taux, 0.1)
        else:
            tstate, tm = tp.apply_grads(tstate, torch.from_numpy(ids),
                                        torch.from_numpy(g), taux, 0.1)
        step = start + i + 1
        assert int(tstate["step"]) == int(jstate["step"]) == step
        np.testing.assert_array_equal(tstate["dic"].numpy(),
                                      np.asarray(jstate["dic"]))
        np.testing.assert_allclose(tstate["grad_norm"].numpy(),
                                   np.asarray(jstate["grad_norm"]),
                                   rtol=1e-5, atol=1e-6, err_msg=str(i))
        np.testing.assert_allclose(tstate["weight"].numpy(),
                                   np.asarray(jstate["weight"]),
                                   rtol=1e-5, atol=1e-6)
        assert int(tm["ada_admitted"]) == int(jm["ada_admitted"])
        assert (int(tm["ada_admitted"]) > 0) is (step >= DECAY_EVERY)
