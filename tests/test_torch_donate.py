"""donate_state: un-donated, a step leaves the caller's state valid (the
JAX package's un-donated jit call); donated, the port updates it in
place. Both packages start from one bridged state on a small CAFE config
with frequency scores (integers, so the sketch states compare exactly)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.data import batch_iterator as jbatches
from cafe_tpu.train.loop import build_all as jbuild_all, get_dataset as jdata
from cafe_tpu.train.step import build_multi_step as jmulti
from cafe_tpu_torch.bridge import from_reference, to_numpy
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.train import build_all as tbuild_all, build_multi_step

torch.set_num_threads(1)

SMALL = dict(dataset="synthetic", synthetic_rows=1024, synthetic_fields=4,
             synthetic_vocab=2000, synthetic_dense=4, synthetic_zipf=1.2,
             embedding_dim=8, mini_batch_size=128, compress_method="cafe",
             compress_rate=0.05, cafe_sketch_threshold=3.0,
             cafe_use_freq=True, learning_rate=0.1, cafe_mig_lanes=1)


def _equal_trees(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _equal_trees(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _equal_trees(x, y, f"{path}[{i}]")
    else:
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b),
                                      err_msg=path)


def _build(donate, k=1):
    """JAX and port steps (k > 1: build_multi_step over k sub-batches) on
    one bridged start state; returns (jax step, jax state, port step, port
    state, the JAX batch as arrays, the same as tensors)."""
    kw = dict(SMALL, donate_state=donate)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    train = jdata(jcfg, "train")
    _, _, jstate, jstep, _ = jbuild_all(jcfg, train)
    _, _, _, tstep, _ = tbuild_all(tcfg, train, device="cpu")
    if k > 1:
        jstep, tstep = (jmulti(jstep, k, donate=donate),
                        build_multi_step(tstep, k, donate=donate))
    tstate = from_reference(jstate, "cpu")
    batches = list(jbatches(train, SMALL["mini_batch_size"] * k,
                            drop_last=True))
    dense, sparse, label, valid = batches[0]
    jargs = (jnp.asarray(dense), jnp.asarray(sparse), jnp.asarray(label),
             valid)
    targs = (torch.from_numpy(dense), torch.from_numpy(sparse),
             torch.from_numpy(label), valid)
    return jstep, jstate, tstep, tstate, jargs, targs


@pytest.mark.parametrize("k", [1, 2])
def test_undonated_step_leaves_the_callers_state(k):
    jstep, jstate0, tstep, tstate0, jargs, targs = _build(False, k)
    t_before = to_numpy(tstate0)
    j1, jm1 = jstep(jstate0, *jargs)
    j2, jm2 = jstep(jstate0, *jargs)        # the same state0 again
    t1, tm1 = tstep(tstate0, *targs)
    _equal_trees(to_numpy(tstate0), t_before)   # the caller's state
    t2, tm2 = tstep(tstate0, *targs)
    _equal_trees(to_numpy(tstate0), t_before)
    # JAX: the un-donated call twice gives one result; the port too
    _equal_trees(to_numpy(from_reference(j1, "cpu")),
                 to_numpy(from_reference(j2, "cpu")))
    _equal_trees(to_numpy(t1), to_numpy(t2))
    assert float(tm1["loss"]) == float(tm2["loss"])
    assert float(jm1["loss"]) == float(jm2["loss"])
    # and the port's result is the JAX one: sketch exact, floats close
    jn, tn = to_numpy(from_reference(j1, "cpu")), to_numpy(t1)
    for f in ("val", "cnt", "dic", "free", "free_top", "tot"):
        np.testing.assert_array_equal(tn["embed"]["part0"]["sketch"][f],
                                      jn["embed"]["part0"]["sketch"][f],
                                      err_msg=f)
    assert not np.array_equal(tn["embed"]["part0"]["sketch"]["cnt"],
                              t_before["embed"]["part0"]["sketch"]["cnt"])
    np.testing.assert_allclose(tn["embed"]["part0"]["table"],
                               jn["embed"]["part0"]["table"],
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(float(tm1["loss"]), float(jm1["loss"]),
                               rtol=1e-5)


@pytest.mark.parametrize("k", [1, 2])
def test_donated_step_updates_in_place(k):
    _, _, tstep, tstate0, _, targs = _build(True, k)
    table0 = tstate0.embed["part0"]["table"]
    before = table0.clone()
    w0 = tstate0.params["top"][0]["w"]
    w_before = w0.clone()
    t1, _ = tstep(tstate0, *targs)
    assert t1.embed["part0"]["table"] is table0     # the same storage
    assert not torch.equal(table0, before)          # moved in place
    assert not torch.equal(w0, w_before)
