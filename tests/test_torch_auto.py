"""--shard_exchange auto at 4 gloo ranks: every part keeps its
single-device semantics on the global batch, with its big row tables
row-sharded and everything else whole on every rank.

* CAFE v1, CAFE+, hash and full against the JAX package's auto-sharded
  step (shard_train_step with shard_exchange 'auto' on 4 CPU devices),
  from one bridged state.
* QR, Off, AdaEmbed and MDE against the port's own single-device step
  on the global batches.
* The layout: which leaves shard, their local shapes.
* A checkpoint round trip through main_torch.main: run B resumes from
  run A's mid-run slot with A's losses; an auto file loaded in the
  explicit layout raises; one device serves it in its own layout.

Tolerances: integer state (the sketch's fields, routed rows, hot flags,
Off's hot_dict, AdaEmbed's dic and step, promotion counts) EXACT. The
loss within 2e-4 relative and tables within 2e-5 of the JAX package
(tests/test_sharding.py's bounds: XLA's partitioned sums run in another
order); against the port's one device, floats within 1e-5 (the ranks'
dense gradients sum in another order).
"""

import contextlib
import io
import json
import os
import re

import numpy as np
import pytest
import torch

import main_torch
import torch_dist_worker as w
from cafe_tpu_torch.bridge import to_numpy
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.data import batch_iterator
from cafe_tpu_torch.train import build_all, get_dataset
from test_torch_mesh_checkpoint import _argv, _losses
from test_torch_sharded import SHARD, STEPS, _jax_run

torch.set_num_threads(1)

N = 4
AUTO = dict(SHARD, mesh_shape=N, shard_exchange="auto")
BIG = dict(AUTO, synthetic_vocab=20000)
JAXED = {
    "cafe": AUTO,
    "cafe_plus": dict(AUTO, cafe_plus=True),
    "hash": dict(BIG, compress_method="hash", compress_rate=0.2),
    "full": dict(BIG, compress_method="full"),
}
OWN = {
    "qr": dict(BIG, compress_method="qr", compress_rate=0.05),
    "off": dict(BIG, compress_method="off", compress_rate=0.05),
    # ada needs cr > 2 / dim
    "ada": dict(BIG, compress_method="ada", compress_rate=0.3),
    "mde": dict(BIG, compress_method="mde", compress_rate=0.05),
}
CLI = dict(AUTO, synthetic_rows=1718, test_mini_batch_size=128,
           force_platform="cpu")
CLI.pop("shard_exchange")
ARGV = _argv(CLI) + ["--shard_exchange", "auto"]


def _batches(kw):
    cfg = TConfig(**kw)
    return list(batch_iterator(get_dataset(cfg, "train"),
                               kw["mini_batch_size"], drop_last=True))[:STEPS]


@pytest.fixture(scope="module")
def auto4(tmp_path_factory):
    jax_out, runs = {}, []
    for name, kw in JAXED.items():
        jax_out[name], batches = _jax_run(kw, N, "auto", STEPS)
        runs.append((kw, jax_out[name]["init"], batches, ("auto",)))
    for kw in OWN.values():
        runs.append((kw, None, _batches(kw), ("auto",)))
    root = tmp_path_factory.mktemp("auto")
    port = w.run_ranks(w.calls, N, root, [
        ("train_runs", (runs,)),
        ("save_resume_runs", (ARGV, str(root), (1, 4))),
        ("load_error", (ARGV[:-2], str(root / "k1" / "a.latest"))),
        ("latency_calls", (ARGV,)),
        ("cli_text", (ARGV + ["--inference_only", "true", "--load_model",
                              str(root / "k4" / "a"),
                              "--quantize_emb_bits", "4"],))])[0]
    return jax_out, port, root


def _same(a, b, tol, path=""):
    """Integer leaves exact, float leaves within `tol`."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _same(a[k], b[k], tol, f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, tol, f"{path}[{i}]")
    elif a is not None:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=tol, atol=tol,
                                       err_msg=path)


@pytest.mark.parametrize("name", list(JAXED))
def test_auto_matches_the_jax_auto_step(auto4, name):
    jax_out, port, _ = auto4
    got, ref = port[0][list(JAXED).index(name)]["auto"], jax_out[name]
    assert got["parts"] == ref["parts"]
    for i, (pm, jm) in enumerate(zip(got["metrics"], ref["metrics"])):
        assert set(pm) == set(jm)
        for k in jm:
            if k == "loss":
                np.testing.assert_allclose(pm[k], jm[k], rtol=2e-4,
                                           err_msg=f"step {i}")
            elif k.endswith("_frac"):
                np.testing.assert_allclose(pm[k], jm[k], rtol=2.4e-7)
            else:
                assert pm[k] == jm[k], (k, i, pm[k], jm[k])
    _same(got["state"]["embed"], ref["state"]["embed"], 2e-5, "embed")
    _same(got["state"]["params"], ref["state"]["params"], 2e-5, "params")
    for key in ref["routing"]:
        np.testing.assert_array_equal(got["routing"][key],
                                      ref["routing"][key])
    if name.startswith("cafe"):
        assert sum(m["cafe_promotions"] for m in got["metrics"]) > 0


def _one_device(kw, batches):
    cfg = TConfig(**kw)
    _, _, state, step, _ = build_all(cfg, get_dataset(cfg, "train"),
                                     device="cpu", capture=False)
    metrics = []
    for dense, sparse, label, valid in batches:
        state, m = step(state, *(torch.from_numpy(x)
                                 for x in (dense, sparse, label)), valid)
        metrics.append({k: float(v) for k, v in m.items()})
    return metrics, to_numpy(state)


@pytest.mark.parametrize("name", list(OWN))
def test_auto_matches_the_ports_one_device(auto4, name):
    _, port, _ = auto4
    kw = OWN[name]
    got = port[0][len(JAXED) + list(OWN).index(name)]["auto"]
    metrics, state = _one_device(kw, _batches(kw))
    for pm, om in zip(got["metrics"], metrics):
        assert set(pm) == set(om)
        for k in om:
            if k == "loss" or k.endswith("_frac"):
                np.testing.assert_allclose(pm[k], om[k], rtol=1e-5)
            else:
                assert pm[k] == om[k], (k, pm[k], om[k])
    _same(got["state"]["embed"], state["embed"], 1e-5, "embed")
    _same(got["state"]["params"], state["params"], 1e-5, "params")
    if name == "ada":
        part = next(iter(state["embed"].values()))
        assert (part["dic"] > 0).sum() > 0     # the step-1 rebuild ran


def test_the_auto_layout(auto4):
    """Row tables and their slots with >= 512 rows that divide by 4 are
    sharded (a quarter on each rank); the sketch, hot dicts, AdaEmbed's
    dic and importance and small tables stay whole."""
    from cafe_tpu_torch.parallel.sharding import _ROW_SHARDED_2D
    _, port, _ = auto4
    runs = dict(zip(list(JAXED) + list(OWN), port[0]))
    for name, res in runs.items():
        run = res["auto"]
        for (key, local), keys in zip(run["local_shapes"].items(),
                                      run["auto_keys"]):
            full = run["state"]["embed"][key]
            want = sorted(k for k, v in full.items()
                          if isinstance(v, np.ndarray) and v.ndim == 2
                          and k in _ROW_SHARDED_2D and v.shape[0] >= 512
                          and v.shape[0] % N == 0)
            assert keys == want, (name, key)
            for leaf, shape in local.items():
                rows = full[leaf].shape
                assert shape == ((rows[0] // N,) + rows[1:] if leaf in keys
                                 else rows), (name, key, leaf)
    assert runs["cafe"]["auto"]["auto_keys"][-1] == ["table"]
    assert runs["ada"]["auto"]["auto_keys"][-1] == ["weight"]
    sketch = runs["cafe"]["auto"]["state"]["embed"]["part1"]["sketch"]
    assert sketch["free_top"].shape == ()        # the single-device sketch


def test_auto_checkpoint_round_trip(auto4):
    """Run B resumes from run A's mid-run slot and prints A's losses, at
    --steps_per_dispatch 1 and 4; the sidecar records the auto layout;
    loading it in the explicit layout raises; one device serves it in
    its own (single-device) layout; the mesh serves it at int4 and runs
    the latency protocol."""
    _, port, root = auto4
    for k in (1, 4):
        run = port[1][k]
        a, b = _losses(run["a"]), _losses(run["b"])
        common = sorted(set(a) & set(b))
        assert common and all(a[i] == b[i] for i in common), k
    calls, ms = port[3]
    assert calls == 1024 and ms > 0
    assert re.search(r"^accuracy=[\d.]+ .*roc_auc=[\d.]+$", port[4], re.M)
    assert "saved at layout 'auto'" in port[2] \
        and "loaded at layout 'explicit'" in port[2]
    with open(os.path.realpath(str(root / "k1" / "a.latest"))
              + ".meta.json") as f:
        meta = json.load(f)
    assert (meta["mesh_size"], meta["mesh_inner"], meta["layout"]) == \
        (N, 0, "auto")
    out = io.StringIO()
    serve = _argv({k: v for k, v in CLI.items()
                   if k not in ("mesh_shape", "shard_embeddings")})
    with contextlib.redirect_stdout(out):
        main_torch.main(serve + ["--inference_only", "true", "--load_model",
                                 str(root / "k1" / "a")])
    assert re.search(r"^accuracy=[\d.]+ .*roc_auc=[\d.]+$", out.getvalue(),
                     re.M)
