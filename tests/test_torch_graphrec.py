"""The graph recommenders on the port (cafe_tpu_torch/models/graphrec,
cafe_tpu_torch/native.py, main_graphrec_torch.py) against the JAX
package's, on the CPU, from the same numpy-made state.

Tolerances: floats (propagation, losses, tables, Adam slots, conv params)
within 1e-5 (torch's index_add_ and matmuls sum in another order than
XLA's segment_sum and dots); the sketch's integer fields, tick and counts
exact (frequency scores, a threshold that promotes, so promotion and
migration run). The whole drivers: printed losses within 1e-4 relative,
recall, hit and NDCG within 0.01. Samplers and native components: equal
outputs for equal seeds.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu import native as jnative
from cafe_tpu.models.graphrec import (LightGCN as JLightGCN,
                                      LightGCNConfig as JLCfg,
                                      PinSAGE as JPinSAGE,
                                      PinSAGEConfig as JPCfg,
                                      RandomWalkSampler as JSampler,
                                      build_bipartite_graph as jgraph,
                                      sample_negative as jsample)
from cafe_tpu_torch import native as tnative
from cafe_tpu_torch.bridge import to_numpy, to_reference, to_torch
from cafe_tpu_torch.models.graphrec import (LightGCN, LightGCNConfig,
                                            PinSAGE, PinSAGEConfig,
                                            RandomWalkSampler,
                                            build_bipartite_graph,
                                            sample_negative)

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import main_graphrec  # noqa: E402
import main_graphrec_torch  # noqa: E402

TOL = 1e-5


def _graph(n_users=60, n_items=40, seed=0):
    train, test, n_items = main_graphrec.make_synthetic_interactions(
        n_users, n_items, blocks=4, per_user=8, seed=seed)
    users = np.concatenate([np.full(len(p), u, np.int32)
                            for u, p in enumerate(train)])
    return train, test, n_items, users, np.concatenate(train)


def _jnp_tree(tree):
    return jax.tree.map(np.asarray, tree)


def _close_tree(got, want, what):
    """Port state (numpy via to_numpy) against a JAX state: integer
    leaves exact, float leaves within TOL."""
    want = to_numpy(to_torch(_jnp_tree(want), "cpu"))
    flat_g, flat_w = jax.tree.leaves(got), jax.tree.leaves(want)
    assert jax.tree.structure(got) == jax.tree.structure(want), what
    for g, w in zip(flat_g, flat_w):
        assert g.shape == w.shape and g.dtype == w.dtype, what
        if np.issubdtype(w.dtype, np.integer):
            np.testing.assert_array_equal(g, w, err_msg=what)
        else:
            np.testing.assert_allclose(g, w, rtol=TOL, atol=TOL,
                                       err_msg=what)


# ------------------------------------------------------------ samplers

def test_sample_negative_equals_the_jax_package():
    train, _, n_items, _, items = _graph()
    for seed in (0, 3):
        np.testing.assert_array_equal(
            sample_negative(len(train), n_items, len(items), train,
                            neg_num=2, seed=seed),
            jsample(len(train), n_items, len(items), train, neg_num=2,
                    seed=seed))


def _item_users(train, n_items):
    iu = [[] for _ in range(n_items)]
    for u, its in enumerate(train):
        for it in its:
            iu[int(it)].append(u)
    return [np.asarray(x, dtype=np.int32) for x in iu]


def test_random_walk_sampler_and_blocks_equal_the_jax_package():
    train, _, n_items, _, _ = _graph()
    iu = _item_users(train, n_items)
    ts = RandomWalkSampler(train, iu, walks=5, top_t=3, seed=7)
    js = JSampler(train, iu, walks=5, top_t=3, seed=7)
    seeds = np.arange(n_items, dtype=np.int32)
    for a, b in zip(ts.sample(seeds), js.sample(seeds)):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(ts.pos_pairs(16), js.pos_pairs(16)):
        np.testing.assert_array_equal(a, b)
    tm = PinSAGE(PinSAGEConfig(), n_items, device="cpu")
    jm = JPinSAGE(JPCfg(), n_items)
    tb, jb = tm.make_batch(ts, 16), jm.make_batch(js, 16)
    assert tb.keys() == jb.keys()
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)
    assert tb["ids"].shape == (16 * 3 * (1 + 3 + 9), 1)


# ------------------------------------------------------------ LightGCN

def _lightgcn_pair(compress_rate, threshold=2.0, layers=2):
    train, test, n_items, users, items = _graph()
    kw = dict(latent_dim=8, n_layers=layers, lr=0.01,
              compress_rate=compress_rate, sketch_threshold=threshold,
              seed=3)
    jm = JLightGCN(JLCfg(**kw), jgraph(users, items, len(train), n_items))
    tm = LightGCN(LightGCNConfig(**kw),
                  build_bipartite_graph(users, items, len(train), n_items),
                  device="cpu")
    for m in (jm, tm):
        m.part.use_freq = True
    return train, test, n_items, items, jm, tm


def test_graph_and_propagate_equal_the_jax_package():
    _, _, _, _, jm, tm = _lightgcn_pair(1.0, layers=3)
    for a, b in zip(tm.graph[:3], jm.graph[:3]):
        np.testing.assert_array_equal(a, b)
    emb = np.random.default_rng(0).normal(
        0, 0.1, (tm.n_nodes, 8)).astype(np.float32)
    np.testing.assert_allclose(
        tm.propagate(torch.from_numpy(emb)).numpy(),
        np.asarray(jm.propagate(jnp.asarray(emb))), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("compress_rate", [1.0, 0.5])
def test_bpr_steps_equal_the_jax_package(compress_rate):
    """Init draws, then 3 BPR steps (rows-Adam) from one state: table,
    Adam slots and the sketch; at CAFE the ids promote and migrate."""
    train, _, n_items, items, jm, tm = _lightgcn_pair(compress_rate)
    js = jm.init()
    ts = tm.init()
    _close_tree(to_numpy(ts), js, "init")
    step = jm.jit_step()
    trip = sample_negative(len(train), n_items, len(items), train, seed=1)
    for i in range(3):
        b = trip[i * 64:(i + 1) * 64]
        js, jl = step(js, jnp.asarray(b[:, 0]), jnp.asarray(b[:, 1]),
                      jnp.asarray(b[:, 2]))
        ts, tl = tm.bpr_step(ts, b[:, 0], b[:, 1], b[:, 2])
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
        _close_tree(to_numpy(ts), js, f"step {i}")
    if compress_rate < 1.0:
        assert int((ts["sketch"]["dic"] != 0).sum()) > 0, "nothing hot"


def test_recall_equals_the_jax_package():
    train, test, _, items, jm, tm = _lightgcn_pair(0.5)
    js = jm.init()
    ts = to_torch(_jnp_tree(js), "cpu")
    want = jm.recall_at_k(js, train, test, k=5)
    got = tm.recall_at_k(ts, train, test, k=5)
    assert got == pytest.approx(want, abs=1e-12)
    np.testing.assert_allclose(
        tm.scores(ts, np.arange(10)).numpy(),
        np.asarray(jm.scores(js, np.arange(10))), rtol=TOL, atol=TOL)


# ------------------------------------------------------------- PinSAGE

def _adam_table_close(got, want, lr):
    """A rows-Adam table after one step: rows whose gradient is float
    noise in either package (|m| < 1e-6 after the step; such a row moves
    by up to lr, whatever the noise's size, in Adam's first steps) within
    lr of each other, every other row within TOL."""
    noise = (np.abs(got["table_m"]).max(1) < 1e-6) \
        | (np.abs(want["table_m"]).max(1) < 1e-6)
    np.testing.assert_allclose(got["table"][~noise], want["table"][~noise],
                               rtol=TOL, atol=TOL)
    assert np.abs(got["table"][noise] - want["table"][noise]).max(
        initial=0.0) <= lr + TOL


@pytest.mark.parametrize("ratio", [1, 2])
@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_pinsage_train_step_equals_the_jax_package(ratio, optimizer):
    """Xavier draws after the part's, then a max-margin step (the dense
    optimizer on the convs, the sparse one on the padded unique ids) from
    one state, twice (the second from the JAX package's state after the
    first). Under Adam the table's noise-gradient rows are held within
    lr (_adam_table_close)."""
    train, _, n_items, _, _ = _graph()
    iu = _item_users(train, n_items)
    lr = 0.01
    kw = dict(hidden_dims=8, compress_ratio=ratio, sketch_threshold=2.0,
              seed=5, optimizer=optimizer)
    jm, tm = JPinSAGE(JPCfg(**kw), n_items), PinSAGE(PinSAGEConfig(**kw),
                                                     n_items, device="cpu")
    for m in (jm, tm):
        m.part.use_freq = True
    js = jm.init()
    _close_tree(to_numpy(tm.init()), js, "init")
    jsam = JSampler(train, iu, walks=5, top_t=3, seed=1)
    tsam = RandomWalkSampler(train, iu, walks=5, top_t=3, seed=1)
    for i in range(2):
        ts = to_torch(_jnp_tree(js), "cpu")
        js, jl = jm.train_step(js, jm.make_batch(jsam, 8), lr)
        ts, tl = tm.train_step(ts, tm.make_batch(tsam, 8), lr)
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
        got = to_numpy(ts)
        want = to_numpy(to_torch(_jnp_tree(js), "cpu"))
        if optimizer == "adam":
            _adam_table_close(got["embed"], want["embed"], lr)
            got["embed"]["table"] = want["embed"]["table"]
        _close_tree(got, js, f"step {i}")
    if ratio > 1:
        assert int((ts["embed"]["sketch"]["dic"] != 0).sum()) > 0
    ts = to_torch(_jnp_tree(js), "cpu")
    np.testing.assert_allclose(
        tm.represent_items(ts, RandomWalkSampler(train, iu, seed=2),
                           batch=16),
        jm.represent_items(js, JSampler(train, iu, seed=2), batch=16),
        rtol=TOL, atol=TOL)


def test_bridge_carries_graphrec_states_both_ways():
    train, _, n_items, _, _ = _graph()
    jm = JPinSAGE(JPCfg(hidden_dims=8, compress_ratio=2), n_items)
    js = jm.init()
    back = to_reference(to_torch(js, "cpu"), js)
    assert jax.tree.structure(back) == jax.tree.structure(js)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(js)):
        np.testing.assert_array_equal(a, np.asarray(b))


# ------------------------- main_graphrec.py and main_graphrec_torch.py

SMALL = ["--synthetic_users", "120", "--synthetic_items", "160",
         "--epochs", "2", "--force_platform", "cpu"]


def _epoch_lines(text):
    return [tuple(float(x) if x else None for x in m) for m in re.findall(
        r"^epoch \d+: \w+_loss ([\d.]+) \w+@\d+ ([\d.]+)(?: ndcg ([\d.]+))?",
        text, re.M)]


@pytest.mark.parametrize("flags", [
    ["--model", "lightgcn", "--dim", "16", "--layers", "2"],
    ["--model", "lightgcn", "--dim", "16", "--layers", "2",
     "--compress_rate", "0.5"],
    ["--model", "pinsage", "--dim", "16", "--layers", "2",
     "--compress_ratio", "2", "--bpr_batch", "32",
     "--steps_per_epoch", "4"]], ids=["lightgcn", "lightgcn_cafe",
                                      "pinsage_cafe"])
def test_driver_prints_what_the_jax_driver_prints(flags, capsys):
    main_graphrec.main(SMALL + flags)
    want = capsys.readouterr().out
    res = main_graphrec_torch.main(SMALL + flags)
    got = capsys.readouterr().out
    assert got.splitlines()[0] == want.splitlines()[0]
    g, w = _epoch_lines(got), _epoch_lines(want)
    assert len(g) == len(w) == 2
    for a, b in zip(g, w):
        np.testing.assert_allclose(a[0], b[0], rtol=1e-4)
        np.testing.assert_allclose(
            [x for x in a[1:] if x is not None],
            [x for x in b[1:] if x is not None], atol=0.01)
    assert len(res["epochs"]) == 2


def test_driver_auto_resumes_from_the_newest_epoch(tmp_path, capsys):
    flags = SMALL + ["--model", "lightgcn", "--dim", "8", "--layers", "2",
                     "--compress_rate", "0.5"]
    straight = main_graphrec_torch.main(flags)
    capsys.readouterr()
    save = ["--save_dir", str(tmp_path)]
    main_graphrec_torch.main(flags + save + ["--epochs", "1"])
    assert (tmp_path / "lightgcn_epoch_0.ckpt").exists()
    assert (tmp_path / "lightgcn_epoch_0.ckpt.meta.json").exists()
    resumed = main_graphrec_torch.main(flags + save)
    out = capsys.readouterr().out
    assert "resumed from" in out and "lightgcn_epoch_0.ckpt (epoch 0)" in out
    assert [e["epoch"] for e in resumed["epochs"]] == [1]
    assert resumed["epochs"][0]["loss"] == straight["epochs"][1]["loss"]
    assert resumed["recall"] == straight["recall"]
    # the newest of epochs 0 and 1 wins; nothing is left to train
    again = main_graphrec_torch.main(flags + save)
    assert "lightgcn_epoch_1.ckpt (epoch 1)" in capsys.readouterr().out
    assert again["epochs"] == [] and again["recall"] == straight["recall"]


def test_pinsage_driver_resumes(tmp_path, capsys):
    flags = SMALL[:-4] + ["--force_platform", "cpu", "--model", "pinsage",
                          "--dim", "8", "--layers", "2",
                          "--compress_ratio", "2", "--bpr_batch", "16",
                          "--steps_per_epoch", "2",
                          "--save_dir", str(tmp_path)]
    main_graphrec_torch.main(flags + ["--epochs", "1"])
    res = main_graphrec_torch.main(flags + ["--epochs", "2"])
    assert "pinsage_epoch_0.ckpt (epoch 0)" in capsys.readouterr().out
    assert [e["epoch"] for e in res["epochs"]] == [1]
    assert (tmp_path / "pinsage_epoch_1.ckpt").exists()


def test_driver_needs_cuda_unless_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        main_graphrec_torch.main(SMALL[:-2])
    with pytest.raises(RuntimeError, match="CUDA"):
        LightGCN(LightGCNConfig(), build_bipartite_graph(
            np.zeros(1), np.zeros(1), 1, 1))


# -------------------------------------------------------------- native

def test_native_builds_under_build_and_equals_the_jax_package():
    path = Path(tnative.build())
    assert path.parent == REPO / "build" / "cafe_tpu_torch"
    assert not str(path).startswith(str(REPO / "native"))
    all_pos = [np.array([0, 1, 2]), np.array([5]), np.array([], np.int32),
               np.arange(7)]
    for seed in (0, 9):
        np.testing.assert_array_equal(
            tnative.bpr_sample(4, 30, 40, all_pos, neg_num=2, seed=seed),
            jnative.bpr_sample(4, 30, 40, all_pos, neg_num=2, seed=seed))
    rng = np.random.default_rng(0)
    stream = (rng.random(6000) ** 3 * 500).astype(np.int32)
    ts, js = tnative.HostSketch(64, 4.0), jnative.HostSketch(64, 4.0)
    for lo in range(0, len(stream), 256):
        np.testing.assert_array_equal(ts.insert(stream[lo:lo + 256]),
                                      js.insert(stream[lo:lo + 256]))
    ids = np.arange(500, dtype=np.int32)
    np.testing.assert_array_equal(ts.query(ids), js.query(ids))
    assert ts.num_hot() == js.num_hot() > 0
    for a, b in zip(ts.hot_items(), js.hot_items()):
        np.testing.assert_array_equal(a, b)


def test_native_raises_without_gpp(monkeypatch, tmp_path):
    monkeypatch.setattr(tnative, "_BUILD_DIR", tmp_path)
    monkeypatch.setenv("PATH", str(tmp_path))
    with pytest.raises(RuntimeError, match="g\\+\\+"):
        tnative.build()
