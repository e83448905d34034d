"""A mesh run that saves, resumes and serves: the port's train/checkpoint
and train/loop under a mesh of 4 gloo ranks (tests/torch_dist_worker.py).

* The file a mesh run saves is the GLOBAL state, equal to the JAX
  package's `jax.device_get` of its sharded state after the same steps
  from one bridged state (tests/test_sharding.py:729's setup at mesh 4,
  explicit exchange): the sketch's integer fields exact (frequency
  scores), floats within 1e-5 (the ranks' gradients and duplicate-row
  updates sum in another order than XLA's).
* A run resumed from the mid-run rolling slot prints the same losses at
  the iterations both runs cover, and its final save is bit-equal to the
  first run's, at --steps_per_dispatch 1 and 4.
* K = 4 on the mesh equals K = 1 on the mesh step for step (bit-equal
  states after every dispatch), over an epoch whose last global batch is
  padded; at K = 5 the last dispatch runs past the data's end, and its
  empty sub-steps leave the state as K = 1 plus those steps does, on the
  mesh as on one device.
* A checkpoint from world size 4 loaded at world size 2 raises, naming
  both; one device serves it with --inference_only only.
* The latency protocol returns on the mesh with the same call count on
  every rank.
"""

import json
import os
import re
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu.config import Config as JConfig
from cafe_tpu.data import batch_iterator as jbatches
from cafe_tpu.parallel import make_mesh as jmake_mesh, shard_train_step
from cafe_tpu.train.loop import build_all as jbuild_all, get_dataset as jdata
from cafe_tpu_torch.bridge import from_reference, to_numpy

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# 1,718 rows: 1,472 train rows, 11.5 global batches of 128 (a padded
# tail), and 2 test batches (the latency protocol cycles them)
KW = dict(dataset="synthetic", synthetic_rows=1718, synthetic_fields=4,
          synthetic_vocab=2000, synthetic_vocab_spread=0.04,
          synthetic_dense=4, synthetic_zipf=1.2, embedding_dim=8,
          mini_batch_size=128, test_mini_batch_size=128,
          compress_method="cafe", compress_rate=0.05,
          cafe_sketch_threshold=3.0, cafe_use_freq=True,
          learning_rate=0.1, cafe_mig_lanes=2, shard_embeddings=True,
          mesh_shape=4, force_platform="cpu")


def _argv(kw):
    return [a for k, v in kw.items()
            for a in (f"--{k}", str(v).lower() if isinstance(v, bool)
                      else str(v))] + [
        "--print_freq", "4", "--test_freq", "0",
        "--tensor_board_filename", ""]


ARGV = _argv(KW)
STEPS = 3


def _saved_size(path):
    with open(path + ".meta.json") as f:
        return json.load(f)["mesh_size"]


def _losses(text):
    return {int(it): loss for it, loss in re.findall(
        r"^Finished training it (\d+)/\d+ of epoch 0, [\d.]+ ms/it, "
        r"loss ([\d.]+)$", text, re.M)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    root = tmp_path_factory.mktemp("mesh_ck")
    return root, w.run_ranks(w.save_resume_runs, 4, root, ARGV,
                             str(root), (1, 4))[0]


@pytest.mark.parametrize("k", [1, 4])
def test_resume_from_the_mid_run_slot_is_exact(runs, k):
    root, out = runs
    run = out[k]
    a, b = _losses(run["a"]), _losses(run["b"])
    assert "loaded" in run["b"] and run["b"].count("loaded") == 1
    common = sorted(set(a) & set(b))
    assert common and common[-1] == 12 and min(b) > 8, (sorted(a), b)
    for it in common:
        assert a[it] == b[it], (it, a[it], b[it])
    slot_b = os.path.realpath(str(root / f"k{k}" / "b.latest"))
    final_a = torch.load(run["latest"], weights_only=True)
    final_b = torch.load(slot_b, weights_only=True)
    assert _saved_size(run["latest"]) == _saved_size(slot_b) == 4
    np.testing.assert_equal(to_numpy(final_b), to_numpy(final_a))
    resumed = torch.load(run["resumed_from"], weights_only=True)
    assert int(resumed["step"]) == 8 and int(final_a["step"]) == 12


def test_dispatch_of_4_equals_4_steps_on_the_mesh(tmp_path):
    out = w.run_ranks(w.dispatch_trajectories, 4, tmp_path, KW, 4)[0]
    one, four = out[1], out[4]
    assert one["valids"] == [128] * 11 + [64]
    assert four["valids"] == [512, 512, 448]
    assert len(one["states"]) == len(four["states"]) == 3
    for i, (s1, s4) in enumerate(zip(one["states"], four["states"])):
        np.testing.assert_equal(s4, s1, err_msg=f"dispatch {i}")
    for i, m4 in enumerate(four["metrics"]):
        sub = one["metrics"][4 * i:4 * i + 4]
        weight = sum(m["weight"] for m in sub)
        assert m4["weight"] == weight
        assert m4["cafe_promotions"] == sum(m["cafe_promotions"]
                                            for m in sub)
        np.testing.assert_allclose(
            m4["loss"], sum(m["loss"] * m["weight"] for m in sub) / weight,
            rtol=1e-6)
    assert sum(m["cafe_promotions"] for m in four["metrics"]) > 0


def test_dispatch_past_the_data_end_on_the_mesh(tmp_path):
    # K = 5 over 12 global batches: the last dispatch holds 2 batches
    # (one padded) and 3 empty sub-steps; on the mesh and on one device
    # alike it equals K = 1 followed by those empty steps
    out = w.run_ranks(w.dispatch_past_the_end, 4, tmp_path, KW, 5)[0]
    assert out["valids"] == [640, 640, 192] and out["empty_steps"] == 3
    np.testing.assert_equal(out["k"], out["one"])
    one_kw = {k: v for k, v in KW.items()
              if k not in ("mesh_shape", "shard_embeddings")}
    one = w.dispatch_past_the_end(None, one_kw, 5)
    assert one["valids"] == [640, 640, 192] and one["empty_steps"] == 3
    np.testing.assert_equal(one["k"], one["one"])
    assert int(one["k"]["step"]) == int(out["k"]["step"]) == 15


def test_saved_global_state_equals_the_jax_sharded_state(tmp_path):
    kw = {k: v for k, v in KW.items() if k != "force_platform"}
    cfg = JConfig(**kw)
    train = jdata(cfg, "train")
    mesh = jmake_mesh(4)
    _, _, state, step, _ = jbuild_all(cfg, train, mesh=mesh)
    sharded, st = shard_train_step(step, mesh, state,
                                   shard_embeddings=True)
    init = to_numpy(from_reference(jax.device_get(st), "cpu"))
    batches = list(jbatches(train, 128, drop_last=True))[:STEPS]
    jm = []
    for dense, sparse, label, valid in batches:
        st, m = sharded(st, dense, sparse, label, valid)
        jm.append({k: float(v) for k, v in m.items()})
    want = to_numpy(from_reference(jax.device_get(st), "cpu"))
    path = str(tmp_path / "m")
    pm = w.run_ranks(w.mesh_steps_saved, 4, tmp_path, KW, init, batches,
                     path)[0]
    assert _saved_size(path) == 4
    got = to_numpy(torch.load(path, weights_only=True))
    assert [m["cafe_promotions"] for m in pm] == \
        [m["cafe_promotions"] for m in jm]
    assert sum(m["cafe_promotions"] for m in pm) > 0
    np.testing.assert_allclose([m["loss"] for m in pm],
                               [m["loss"] for m in jm], rtol=1e-5)
    assert int(got["step"]) == int(want["step"]) == STEPS
    assert got["embed"]["part1"]["sketch"]["free_top"].shape == (4,)
    for key, part in want["embed"].items():
        mine = got["embed"][key]
        assert set(mine) == set(part)
        for f, v in part.get("sketch", {}).items():
            np.testing.assert_array_equal(mine["sketch"][f], v,
                                          err_msg=f"{key} sketch {f}")
        for f, v in part.items():
            if f == "tick":
                np.testing.assert_array_equal(mine[f], v)
            elif f != "sketch":
                np.testing.assert_allclose(mine[f], v, rtol=1e-5,
                                           atol=1e-5, err_msg=f"{key} {f}")
    for a, b in zip(jax.tree.leaves(got["params"]),
                    jax.tree.leaves(want["params"])):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5)


def test_other_world_size_raises_and_one_device_serves(runs, tmp_path,
                                                       capsys):
    root, out = runs
    path = out[1]["latest"]
    errors = w.run_ranks(w.load_error, 2, tmp_path, ARGV, path)
    for e in errors:
        assert e is not None and "world size 4" in e \
            and "world size 2" in e, e
    sys.path.insert(0, str(REPO))
    import main_torch
    one = _argv({k: v for k, v in KW.items() if k != "mesh_shape"}
                | {"shard_embeddings": False})
    with pytest.raises(ValueError, match="world size 4"):
        main_torch.main(one + ["--load_model", path])
    capsys.readouterr()
    main_torch.main(one + ["--load_model", path, "--inference_only", "true"])
    printed = capsys.readouterr().out
    assert re.search(r"^accuracy=[\d.]+ .*roc_auc=[\d.]+$", printed, re.M)


def test_latency_protocol_on_the_mesh(tmp_path):
    res = w.run_ranks(w.latency_calls, 4, tmp_path, ARGV)
    calls = {c for c, _ in res}
    assert calls == {1024}, res
    assert all(ms > 0 for _, ms in res)
