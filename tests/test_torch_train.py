"""The whole slice: the port's build_all + train step against the JAX
package's, from one bridged state, on a small synthetic CAFE config.

* init: the numpy-made tables and the fresh sketch are bit-equal;
* 3 steps with frequency scores (integers) and a low threshold, so ids
  promote and migrate: loss and dense params within 1e-5, tables within
  1e-5, sketch state and routed rows EXACTLY equal;
* 1 step with grad-norm scores: the same within f32 tolerance (the score
  normalisation and group totals sum in another order), sketch cells
  placed identically.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.data import batch_iterator as jbatches
from cafe_tpu.train.loop import build_all as jbuild_all, get_dataset as jdata
from cafe_tpu_torch.bridge import (from_reference, to_numpy, to_reference,
                                   to_torch)
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.train import build_all as tbuild_all, get_dataset

torch.set_num_threads(1)

SMALL = dict(dataset="synthetic", synthetic_rows=1024, synthetic_fields=4,
             synthetic_vocab=2000, synthetic_dense=4, synthetic_zipf=1.2,
             embedding_dim=8, mini_batch_size=128, compress_method="cafe",
             compress_rate=0.05, cafe_sketch_threshold=3.0,
             cafe_use_freq=True, learning_rate=0.1, cafe_mig_lanes=1)
SKETCH_EXACT = ("val", "cnt", "dic", "free", "free_top", "tot")


def _run(kw, steps):
    """Build both packages on `kw`, bridge the JAX state into the port,
    run `steps` batches through both. Returns ((port init embed, bridged
    embed), [(jax state, metrics)], [(port state, metrics)], the two
    embedding layers, the two final states, the batches)."""
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jtrain = jdata(jcfg, "train")
    _, jembed, jstate, jstep, _ = jbuild_all(jcfg, jtrain)
    ttrain = get_dataset(tcfg, "train")
    np.testing.assert_array_equal(ttrain.sparse, jtrain.sparse)
    _, tembed, tinit, tstep, _ = tbuild_all(tcfg, ttrain, device="cpu")
    tstate = from_reference(jstate, "cpu")
    init = (to_numpy(tinit.embed), to_numpy(tstate.embed))
    batches = list(jbatches(jtrain, kw["mini_batch_size"],
                            drop_last=True))[:steps]
    jout, tout = [], []
    for dense, sparse, label, valid in batches:
        jstate, jm = jstep(jstate, jnp.asarray(dense), jnp.asarray(sparse),
                           jnp.asarray(label), valid)
        tstate, tm = tstep(tstate, torch.from_numpy(dense),
                           torch.from_numpy(sparse), torch.from_numpy(label),
                           valid)
        jout.append((to_numpy(from_reference(jstate, "cpu")),
                     {k: float(v) for k, v in jm.items()}))
        tout.append((to_numpy(tstate), {k: float(v) for k, v in tm.items()}))
    return init, jout, tout, (jembed, tembed), (jstate, tstate), batches


@pytest.fixture(scope="module")
def freq_run():
    return _run(SMALL, steps=3)


def test_init_tables_and_sketch_bit_equal(freq_run):
    (tinit, jinit), *_ = freq_run
    part = jinit["part0"]
    np.testing.assert_array_equal(tinit["part0"]["table"], part["table"])
    for f in SKETCH_EXACT:
        np.testing.assert_array_equal(tinit["part0"]["sketch"][f],
                                      part["sketch"][f], err_msg=f)


def test_bridge_round_trip():
    """JAX state -> port -> JAX structure: every leaf unchanged, every
    NamedTuple rebuilt with its own type."""
    import jax
    jcfg = JConfig(**dict(SMALL, optimizer="adam"))
    *_, jstate, _, _ = jbuild_all(jcfg, jdata(jcfg, "train"))
    back = to_reference(from_reference(jstate, "cpu"), jstate)
    assert type(back) is type(jstate)
    assert type(back.embed["part0"]["sketch"]) is \
        type(jstate.embed["part0"]["sketch"])
    jl, bl = jax.tree.leaves(jstate), jax.tree.leaves(back)
    assert len(jl) == len(bl) > 0
    for j, b in zip(jl, bl):
        np.testing.assert_array_equal(b, np.asarray(j))
        assert b.dtype == np.asarray(j).dtype


@pytest.mark.parametrize("method,extra", [
    ("full", {}), ("hash", {}), ("cafe", {}),
    ("cafe", {"cafe_hot_separate_field": True}),
])
def test_embedding_layer_build_and_init_match(method, extra):
    """Same parts, fields, sizes and bit-equal numpy-made state for every
    ported method (mixed vocabularies, so some fields stay full)."""
    from cafe_tpu.embeddings import build_embedding_layer as jbuild
    from cafe_tpu_torch.embeddings import build_embedding_layer as tbuild
    kw = dict(SMALL, compress_method=method, **extra)
    counts = [3000, 40, 900, 5000]
    jl = jbuild(JConfig(**kw), counts, 8)
    tl = tbuild(TConfig(**kw), counts, 8, device="cpu")
    assert [type(p).__name__ for p in tl.parts] == \
        [type(p).__name__ for p in jl.parts]
    assert [p.field_idx for p in tl.parts] == [p.field_idx for p in jl.parts]
    jstate, _ = jl.init(5)
    tstate, _ = tl.init(5)
    np.testing.assert_equal(to_numpy(tstate),
                            to_numpy(to_torch(jstate, "cpu")))


def _close(a, b, tol, path=""):
    if isinstance(a, dict):
        for k in a:
            _close(a[k], b[k], tol, f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}[{i}]")
    else:
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=path)


def test_three_freq_steps_match(freq_run):
    _, jout, tout, _, _, _ = freq_run
    promotions = 0
    for i, ((js, jm), (ts, tm)) in enumerate(zip(jout, tout)):
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"metric {k}, step {i}")
        promotions += jm["cafe_promotions"]
        _close(ts["params"], js["params"], 1e-5, f"step {i} params")
        np.testing.assert_allclose(ts["embed"]["part0"]["table"],
                                   js["embed"]["part0"]["table"],
                                   rtol=1e-5, atol=1e-5)
        for f in SKETCH_EXACT:
            np.testing.assert_array_equal(ts["embed"]["part0"]["sketch"][f],
                                          js["embed"]["part0"]["sketch"][f],
                                          err_msg=f"sketch {f}, step {i}")
        assert int(ts["embed"]["part0"]["tick"]) == i + 1
        assert int(ts["step"]) == int(js["step"]) == i + 1
    assert promotions > 0          # migration and routing were exercised


def test_routing_after_steps_exact(freq_run):
    *_, (jembed, tembed), (jstate, tstate), batches = freq_run
    sparse = batches[0][1]
    _, jaux = jembed.gather(jstate.embed, jnp.asarray(sparse))
    _, taux = tembed.gather(tstate.embed, torch.from_numpy(sparse))
    for name, j, t in zip(("oids", "row", "hrow", "is_hot"),
                          jaux["part0"], taux["part0"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j),
                                      err_msg=name)
    assert taux["part0"][3].any()


def test_grad_norm_scores_step():
    kw = dict(SMALL, cafe_use_freq=False, cafe_sketch_threshold=500.0)
    _, jout, tout, *_ = _run(kw, steps=1)
    (js, jm), (ts, tm) = jout[0], tout[0]
    for k in jm:
        np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5)
    _close(ts["params"], js["params"], 1e-5)
    tsk, jsk = ts["embed"]["part0"]["sketch"], js["embed"]["part0"]["sketch"]
    for f in ("val", "dic", "free", "free_top"):
        np.testing.assert_array_equal(tsk[f], jsk[f], err_msg=f)
    # group totals are differences of a running f32 sum over the batch's
    # B*F = 512 scores (mean 1): a few ulps of 512 (2^-14 each) apart
    np.testing.assert_allclose(tsk["cnt"], jsk["cnt"], rtol=1e-5, atol=2e-4)
    np.testing.assert_allclose(tsk["tot"], jsk["tot"], rtol=1e-5)


def _mostly_close(a, b, tol, cap, path=""):
    """Adaptive updates are ~lr * g / |g|: an element whose gradient
    sits at the f32 cancellation floor moves by up to lr either way in
    either package. So: at most 1e-3 of the elements (or one) beyond
    `tol`, and none beyond `cap` (two such moves per step)."""
    if isinstance(a, dict):
        for k in a:
            _mostly_close(a[k], b[k], tol, cap, f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _mostly_close(x, y, tol, cap, f"{path}[{i}]")
    else:
        diff = np.abs(np.asarray(a) - np.asarray(b))
        far = diff > tol + tol * np.abs(np.asarray(b))
        assert far.sum() <= max(1, 1e-3 * far.size) and diff.max() <= cap, \
            (path, far.sum(), diff.max())


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_adagrad_adam_steps(optimizer):
    """Dense and sparse Adagrad / rows-Adam (with the promoted rows' slot
    reset) over 2 frequency-score steps."""
    steps, lr = 2, SMALL["learning_rate"]
    _, jout, tout, *_ = _run(dict(SMALL, optimizer=optimizer), steps=steps)
    for (js, jm), (ts, tm) in zip(jout, tout):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5)
        _mostly_close(ts["params"], js["params"], 1e-5, 2 * lr * steps)
        _close(ts["opt"], js["opt"], 1e-5)
        tp, jp = ts["embed"]["part0"], js["embed"]["part0"]
        for k in jp:
            if k != "sketch":
                np.testing.assert_allclose(tp[k], jp[k], rtol=1e-5,
                                           atol=1e-5, err_msg=k)
        for f in SKETCH_EXACT:
            np.testing.assert_array_equal(tp["sketch"][f], jp["sketch"][f])
