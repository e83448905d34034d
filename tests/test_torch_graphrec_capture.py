"""The graph recommenders' steps as main_graphrec_torch builds them
(LightGCN.build_step, PinSAGE.build_train_step and
build_representation_step over train/step.build_graphrec_step), on the
CPU, on main_graphrec's default synthetic graph (600 users x 1,200
items), dim 8, B <= 128.

* (a) no host reads: one step of every configuration that
  train/step.graphrec_capture_blockers lets replay a graph on the card
  runs under tests/torch_capture_mode.NoCaptureBreaks: LightGCN's BPR
  step at cr 1.0 and 0.5 with SGD, Adagrad and Adam, PinSAGE's train
  step at compress ratio 1 and 4 with Adagrad and Adam, and its
  representation step;
* (b) equal to the JAX package: K = 4 steps of the positional forms
  main_graphrec_torch calls against `jm.jit_step()` and
  `jax.jit(pinsage.train_step)` (from one bridged state; PinSAGE's Adam
  steps each from the JAX package's state, as
  tests/test_torch_graphrec.py's), and represent_items through the
  built representation step against the
  JAX package's `_rep_jit`, within tests/test_torch_graphrec.py's
  tolerances (floats 1e-5; a rows-Adam table's float-noise rows within
  lr, _adam_table_close; the sketch's integers exact on frequency
  scores);
* (c) the blockers name "not on CUDA" on the CPU and nothing on the card
  for these parts; main_graphrec_torch builds graphed steps where the
  blockers are empty (a stand-in GraphedStep) and eager ones on the
  CPU; a PinSAGE train step built for one lr raises on another.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.models.graphrec import (LightGCN as JLightGCN,
                                      LightGCNConfig as JLCfg,
                                      PinSAGE as JPinSAGE,
                                      PinSAGEConfig as JPCfg,
                                      RandomWalkSampler as JSampler,
                                      build_bipartite_graph as jgraph)
from cafe_tpu_torch.bridge import to_numpy, to_torch
from cafe_tpu_torch.models.graphrec import (LightGCN, LightGCNConfig,
                                            PinSAGE, PinSAGEConfig,
                                            RandomWalkSampler,
                                            build_bipartite_graph,
                                            sample_negative)
from cafe_tpu_torch.models.graphrec.pinsage import block_args
from cafe_tpu_torch.train import step as step_mod
from cafe_tpu_torch.train.capture import GraphedStep
from cafe_tpu_torch.train.step import graphrec_capture_blockers
from test_torch_graphrec import (TOL, _adam_table_close, _close_tree,
                                 _item_users, _jnp_tree)
from torch_capture_mode import NoCaptureBreaks
import main_graphrec_torch

torch.set_num_threads(1)

B = 128
K = 4
LR = 0.01
DIM = 8


@pytest.fixture(scope="module")
def data():
    """The default synthetic graph: (train lists, n_items, user of each
    interaction, item of each interaction, item -> users)."""
    train, _, n_items = main_graphrec_torch.make_synthetic_interactions()
    users = np.concatenate([np.full(len(p), u, np.int32)
                            for u, p in enumerate(train)])
    items = np.concatenate(train)
    return train, n_items, users, items, _item_users(train, n_items)


def _lightgcn(data, cr, optimizer="adam", jax_too=False):
    train, n_items, users, items, _ = data
    kw = dict(latent_dim=DIM, n_layers=2, lr=LR, compress_rate=cr,
              sketch_threshold=2.0, seed=3, optimizer=optimizer)
    tm = LightGCN(LightGCNConfig(**kw), build_bipartite_graph(
        users, items, len(train), n_items), device="cpu")
    models = [tm]
    if jax_too:
        models.append(JLightGCN(JLCfg(**kw), jgraph(users, items,
                                                    len(train), n_items)))
    for m in models:
        m.part.use_freq = True
    return models


def _bpr_batches(data, n):
    """n (users, pos, neg) batches of B triples as int64 tensors, the
    form main_graphrec_torch gives them."""
    train, n_items, _, items, _ = data
    trip = sample_negative(len(train), n_items, len(items), train, seed=1)
    cols = torch.from_numpy(np.ascontiguousarray(trip[:, :3].T)).long()
    return [tuple(cols[:, i * B:(i + 1) * B]) for i in range(n)]


def _pinsage(data, ratio, optimizer="adam", jax_too=False):
    _, n_items, _, _, _ = data
    kw = dict(hidden_dims=DIM, compress_ratio=ratio, sketch_threshold=2.0,
              seed=5, optimizer=optimizer)
    models = [PinSAGE(PinSAGEConfig(**kw), n_items, device="cpu")]
    if jax_too:
        models.append(JPinSAGE(JPCfg(**kw), n_items))
    for m in models:
        m.part.use_freq = True
    return models


def _samplers(data, seed, jax_too=False):
    train, _, _, _, iu = data
    out = [RandomWalkSampler(train, iu, walks=5, top_t=3, seed=seed)]
    if jax_too:
        out.append(JSampler(train, iu, walks=5, top_t=3, seed=seed))
    return out


# ---------------------------------------------------------------- (a)

@pytest.mark.parametrize("optimizer", ["sgd", "adagrad", "adam"])
@pytest.mark.parametrize("cr", [1.0, 0.5])
def test_lightgcn_step_runs_under_the_mode(data, cr, optimizer):
    (tm,) = _lightgcn(data, cr, optimizer)
    assert graphrec_capture_blockers(tm.part, "cuda") == []
    step = tm.build_step()
    assert step.graphed is False
    state = tm.init()
    batch = _bpr_batches(data, 1)[0]
    # one eager call first, as the graph's warm-up makes its constants
    state, _ = step(state, *batch)
    with NoCaptureBreaks():
        state, loss = step(state, *batch)
    assert torch.isfinite(loss) and loss.shape == ()


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("ratio", [1, 4])
def test_pinsage_train_step_runs_under_the_mode(data, ratio, optimizer):
    (tm,) = _pinsage(data, ratio, optimizer)
    assert graphrec_capture_blockers(tm.part, "cuda") == []
    step = tm.build_train_step(LR)
    assert step.graphed is False
    (sampler,) = _samplers(data, 1)
    block = block_args(tm.make_batch(sampler, B // 4))
    state, _ = step(tm.init(), *block, LR)
    with NoCaptureBreaks():
        state, loss = step(state, *block, LR)
    assert torch.isfinite(loss) and loss.shape == ()


@pytest.mark.parametrize("ratio", [1, 4])
def test_pinsage_representation_step_runs_under_the_mode(data, ratio):
    (tm,) = _pinsage(data, ratio)
    rep = tm.build_representation_step()
    assert rep.graphed is False
    (sampler,) = _samplers(data, 2)
    block = block_args(tm.make_block(sampler, np.arange(B, dtype=np.int32)))
    state = tm.init()
    rep(state, *block)
    with NoCaptureBreaks():
        z = rep(state, *block)
    assert z.shape == (B, DIM) and bool(torch.isfinite(z).all())


# ---------------------------------------------------------------- (b)

@pytest.mark.parametrize("cr", [1.0, 0.5])
def test_lightgcn_built_step_equals_jit_step(data, cr):
    """K = 4 BPR steps (rows-Adam) of the built step from one bridged
    state against the JAX package's jitted step: loss every step, the
    table, its Adam slots and the sketch after each."""
    tm, jm = _lightgcn(data, cr, jax_too=True)
    js = jm.init()
    ts = to_torch(_jnp_tree(js), "cpu")
    jstep, tstep = jm.jit_step(), tm.build_step()
    for i, batch in enumerate(_bpr_batches(data, K)):
        js, jl = jstep(js, *(jnp.asarray(x.numpy().astype(np.int32))
                             for x in batch))
        ts, tl = tstep(ts, *batch)
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL)
        _close_tree(to_numpy(ts), js, f"step {i}")
    if cr < 1.0:
        assert int((ts["sketch"]["dic"] != 0).sum()) > 0, "nothing hot"


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("ratio", [1, 4])
def test_pinsage_built_steps_equal_the_jitted_steps(data, ratio, optimizer):
    """K = 4 max-margin steps of the built train step against
    `jax.jit(pinsage.train_step)` on the same blocks, then every item's
    representation through the built representation step against the
    JAX package's `_rep_jit`. SGD runs the 4 steps from one bridged
    state. Under Adam a row whose gradient is float noise moves by up to
    lr in either package (_adam_table_close), and the next step's blocks
    read it, so each Adam step starts from the JAX package's state, as
    tests/test_torch_graphrec.py's do (the built step copies a foreign
    state in, as a graphed one does)."""
    tm, jm = _pinsage(data, ratio, optimizer, jax_too=True)
    js = jm.init()
    ts = to_torch(_jnp_tree(js), "cpu")
    tsam, jsam = _samplers(data, 1, jax_too=True)
    jstep, tstep = jax.jit(jm.train_step), tm.build_train_step(LR)
    for i in range(K):
        if optimizer == "adam":
            ts = to_torch(_jnp_tree(js), "cpu")
        js, jl = jstep(js, jm.make_batch(jsam, B // 4), LR)
        ts, tl = tstep(ts, *block_args(tm.make_batch(tsam, B // 4)), LR)
        np.testing.assert_allclose(float(tl), float(jl), rtol=TOL,
                                   err_msg=f"step {i}")
        got = to_numpy(ts)
        if optimizer == "adam":
            want = to_numpy(to_torch(_jnp_tree(js), "cpu"))
            _adam_table_close(got["embed"], want["embed"], LR)
            got["embed"]["table"] = want["embed"]["table"]
        _close_tree(got, js, f"step {i}")
    if ratio > 1:
        assert int((ts["embed"]["sketch"]["dic"] != 0).sum()) > 0
    tsam, jsam = _samplers(data, 2, jax_too=True)
    np.testing.assert_allclose(
        tm.represent_items(to_torch(_jnp_tree(js), "cpu"), tsam, batch=B,
                           step=tm.build_representation_step()),
        jm.represent_items(js, jsam, batch=B), rtol=TOL, atol=TOL)


# ---------------------------------------------------------------- (c)

def test_blockers_name_the_cpu_and_nothing_else(data, monkeypatch):
    (lg,) = _lightgcn(data, 0.5)
    (ps,) = _pinsage(data, 4)
    for part in (lg.part, ps.part):
        (why,) = graphrec_capture_blockers(part, "cpu")
        assert why.startswith("not on CUDA")
        assert graphrec_capture_blockers(part, "cuda") == []
    for built in (lg.build_step(), ps.build_train_step(LR),
                  ps.build_representation_step()):
        assert built.graphed is False
        assert [b.split(":")[0] for b in built.capture_blockers] == \
            ["not on CUDA"]
    # a part with device branches on a torch that cannot hold them
    monkeypatch.setattr(lg.part, "conds", True)
    monkeypatch.setattr(step_mod, "conditional_node_blocker",
                        lambda device: "no conditional nodes")
    assert graphrec_capture_blockers(lg.part, "cuda") == \
        ["no conditional nodes"]


class StandIn:
    """A GraphedStep stand-in that runs its step eagerly and counts its
    calls as replays."""

    graphed = True
    capture_blockers = ()
    capture_s = 0.0
    built = 0

    def __init__(self, fn, carry):
        self.fn = fn
        self.replays = 0
        StandIn.built += 1

    def __call__(self, state, *batch):
        self.replays += 1
        return self.fn(state, *batch)


FLAGS = ["--force_platform", "cpu", "--epochs", "2", "--dim", "8",
         "--layers", "2", "--synthetic_users", "120", "--synthetic_items",
         "160"]


@pytest.mark.parametrize("model", [
    ["--model", "lightgcn", "--compress_rate", "0.5"],
    ["--model", "pinsage", "--compress_ratio", "2", "--bpr_batch", "16",
     "--steps_per_epoch", "3"]], ids=["lightgcn", "pinsage"])
def test_main_graphs_where_nothing_blocks(model, monkeypatch, capsys):
    eager = main_graphrec_torch.main(FLAGS + model)
    assert eager["graphed"] is False
    assert [b.split(":")[0] for b in eager["capture_blockers"]] == \
        ["not on CUDA"]
    assert not any(e["graphed"] for e in eager["epochs"])
    # as on the card: nothing blocks, so main builds graphed steps
    monkeypatch.setattr(step_mod, "graphrec_capture_blockers",
                        lambda part, device: [])
    monkeypatch.setattr(step_mod, "GraphedStep", StandIn)
    StandIn.built = 0
    graphed = main_graphrec_torch.main(FLAGS + model)
    assert StandIn.built == (1 if model[1] == "lightgcn" else 2)
    assert graphed["graphed"] is True and graphed["capture_blockers"] == []
    assert graphed["replays"] == sum(e["steps"] for e in graphed["epochs"])
    assert all(e["graphed"] and e["capture_s"] == 0.0
               for e in graphed["epochs"])
    assert [e["loss"] for e in graphed["epochs"]] == \
        [e["loss"] for e in eager["epochs"]]
    if model[1] == "pinsage":
        assert graphed["representation"]["graphed"] is True
    StandIn.built = 0
    off = main_graphrec_torch.main(FLAGS + model, capture=False)
    assert StandIn.built == 0 and off["graphed"] is False
    assert off["capture_blockers"] == []
    capsys.readouterr()


def test_pinsage_step_built_for_one_lr_raises_on_another(data,
                                                         monkeypatch):
    (tm,) = _pinsage(data, 4)
    (sampler,) = _samplers(data, 1)
    block = block_args(tm.make_batch(sampler, 8))
    eager = tm.build_train_step(LR)
    with pytest.raises(ValueError, match="built for lr"):
        eager(tm.init(), *block, 2 * LR)
    state, loss = eager(tm.init(), *block, LR)
    assert torch.isfinite(loss)
    # the graphed step raises before it replays (or captures) anything
    monkeypatch.setattr(step_mod, "graphrec_capture_blockers",
                        lambda part, device: [])
    graphed = tm.build_train_step(LR)
    assert isinstance(graphed.step, GraphedStep) and graphed.graphed
    with pytest.raises(ValueError, match="built for lr"):
        graphed(state, *block, LR / 2)
    assert graphed.replays == 0
