"""The WDL and DCN towers against the JAX package, on the CPU.

* forward: from params carried by the bridge, the port's probabilities
  equal JAX's within rtol 1e-5 / atol 1e-6 in f32 (with and without
  dense features) and within 2e-3 under bf16 towers;
* init: the port's torch.Generator init has the JAX init's structure,
  shapes and distributions (normal 1e-4 wide / cross weights, zero cross
  biases, uniform last layers within their bound);
* one train step and a second through build_all / train/step.py equal
  the JAX package's from one bridged state, over CAFE (frequency scores:
  the sketch compares exactly) and hash;
* the tower steps read nothing back to the host (they replay a CUDA graph
  on the card), and main_torch.main trains and evaluates each tower.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.models import MODELS as JMODELS
from cafe_tpu_torch.bridge import to_numpy, to_torch
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.models import MODELS
from cafe_tpu_torch.train import build_all as tbuild_all, get_dataset
from cafe_tpu_torch.train.step import capture_blockers
from test_torch_capture import NoCaptureBreaks
from test_torch_methods import BF16_TOL, _np_close
from test_torch_train import SKETCH_EXACT, SMALL, _run

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
DIM, FIELDS, DENSE, B = 8, 5, 4, 64


def _pair(name, num_dense, bf16=False):
    jm = JMODELS[name](DIM, FIELDS, num_dense,
                       compute_dtype=jnp.bfloat16 if bf16 else jnp.float32)
    tm = MODELS[name](DIM, FIELDS, num_dense,
                      compute_dtype=torch.bfloat16 if bf16 else torch.float32,
                      device="cpu")
    return jm, tm, jm.init(jax.random.PRNGKey(3))


def _inputs(num_dense, seed=0):
    rng = np.random.default_rng(seed)
    feats = rng.normal(size=(B, FIELDS, DIM)).astype(np.float32)
    dense = (rng.normal(size=(B, num_dense)).astype(np.float32)
             if num_dense else None)
    return dense, feats


@pytest.mark.parametrize("name", ["wdl", "dcn"])
@pytest.mark.parametrize("num_dense", [0, DENSE])
@pytest.mark.parametrize("bf16", [False, True])
def test_forward_matches_jax(name, num_dense, bf16):
    jm, tm, jparams = _pair(name, num_dense, bf16)
    dense, feats = _inputs(num_dense)
    want = np.asarray(jm.apply(
        jparams, None if dense is None else jnp.asarray(dense),
        jnp.asarray(feats)))
    got = tm.apply(to_torch(jparams, "cpu"),
                   None if dense is None else torch.from_numpy(dense),
                   torch.from_numpy(feats))
    assert got.shape == (B,)
    tol = (BF16_TOL, BF16_TOL) if bf16 else (1e-5, 1e-6)
    np.testing.assert_allclose(got.numpy(), want, rtol=tol[0], atol=tol[1])


@pytest.mark.parametrize("name", ["wdl", "dcn"])
def test_init_structure_and_distributions(name):
    jm, tm, jparams = _pair(name, DENSE)
    tparams = tm.init(0)
    jshapes = jax.tree.map(lambda x: x.shape, jparams)
    tshapes = jax.tree.map(lambda x: tuple(x.shape), to_numpy(tparams))
    assert tshapes == jshapes
    big = MODELS[name](16, 26, 13, device="cpu").init(1)
    small = [big["wide"]["w"]] if name == "wdl" else \
        [c["w"] for c in big["cross"]]
    for w in small:
        assert 0.7e-4 < float(w.std()) < 1.3e-4
    last = big["wide"] if name == "wdl" else big["last"]
    fan_in = (16 * 26 + 13) + (0 if name == "wdl" else 256)
    for t in (last["b"],) + ((last["w"],) if name == "dcn" else ()):
        assert float(t.abs().max()) <= 1.0 / np.sqrt(fan_in)
    if name == "dcn":
        assert all(float(c["b"].abs().max()) == 0.0 for c in big["cross"])
    assert 0.7 < float(big["top"][0]["w"].std()) / np.sqrt(
        2.0 / (429 + 256)) < 1.3


@pytest.mark.parametrize("name", ["wdl", "dcn"])
@pytest.mark.parametrize("method", ["cafe", "hash"])
def test_two_steps_match_jax(name, method):
    kw = dict(SMALL, model=name, compress_method=method)
    _, jout, tout, _, _, _ = _run(kw, steps=2)
    for i, ((js, jm), (ts, tm)) in enumerate(zip(jout, tout)):
        assert set(tm) == set(jm)
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-6,
                                       err_msg=f"{k}, step {i}")
        _np_close(ts["params"], js["params"], path=f"step {i} params")
        for key, part in js["embed"].items():
            _np_close(ts["embed"][key], part, path=f"step {i} {key}")
            for f in SKETCH_EXACT if "sketch" in part else ():
                np.testing.assert_array_equal(ts["embed"][key]["sketch"][f],
                                              part["sketch"][f])


@pytest.mark.parametrize("name", ["wdl", "dcn"])
def test_tower_steps_read_nothing_back(name):
    cfg = TConfig(**dict(SMALL, model=name, mini_batch_size=16))
    _, embed, state, step, eval_step = tbuild_all(cfg, device="cpu")
    assert capture_blockers(cfg, embed) == []
    data = get_dataset(cfg, "train")
    batch = [torch.from_numpy(np.ascontiguousarray(a[:16]))
             for a in (data.dense, data.sparse, data.label)]
    valid = torch.tensor(13, dtype=torch.int32)
    state, _ = step(state, *batch, valid)
    with NoCaptureBreaks():
        state, m = step(state, *batch, valid)
        p = eval_step(state, batch[0], batch[1])
    assert torch.isfinite(m["loss"]) and p.shape == (16,)


@pytest.mark.parametrize("name", ["wdl", "dcn"])
def test_main_torch_runs_each_tower(name, capsys):
    sys.path.insert(0, str(REPO))
    import main_torch
    flags = dict(SMALL, model=name, synthetic_rows=1024, print_freq=3,
                 test_freq=7, tensor_board_filename="")
    argv = ["--force_platform", "cpu"] + [
        x for k, v in flags.items() for x in (f"--{k}", str(v))]
    res = main_torch.main(argv)
    out = capsys.readouterr().out
    losses = [float(ln.split()[-1]) for ln in out.splitlines()
              if ln.startswith("Finished training it ")]
    assert len(losses) == 7 and np.isfinite(losses).all()
    assert out.count(" accuracy") == 1 and "roc_auc" in res["metrics"]
