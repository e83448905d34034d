"""The step the port captures in CUDA graphs, on the CPU.

* (a) `valid` as a device tensor: from one bridged state, the port's
  step and build_multi_step(k = 4) match the JAX package's jitted steps
  on the same batches at valid = B, a tail and 0 (integer scores, so the
  sketch compares exactly; floats within tests/test_torch_train.py's
  1e-5), and the port gives the same bits for an int and a tensor valid;
* (b) a TorchDispatchMode (tests/torch_capture_mode.py) that raises on
  every value read back to the host (`aten._local_scalar_dense`:
  `.item()`, `int()`, `float()`, `bool()` of a tensor) other than a
  branch predicate's
  (utils/cond.host_pred, which a graph takes on the card), and on every
  op whose output shape depends on the data (nonzero, masked_select,
  unique, boolean indexing): one step of each configuration that
  train/step.capture_blockers lets replay a graph runs under it (train,
  multi-step and eval), and a step that a graph runs eagerly (AdaEmbed's
  check step) trips it; only donate_state False and a torch without
  conditional nodes block the capture, on one device or a mesh of one
  rank;
* (c) the eval loop keeps each batch's scores when the eval step returns
  one reused output tensor, as a graphed eval step does.
"""

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
from cafe_tpu_torch.data import CTRArrays
from cafe_tpu_torch.train import build_all as tbuild_all, get_dataset
from cafe_tpu_torch.train import inference
from cafe_tpu_torch.train.metrics import binary_metrics
from cafe_tpu_torch.train.step import build_multi_step, capture_blockers
from cafe_tpu_torch.utils.cond import cond, host_pred
from test_torch_train import SKETCH_EXACT, SMALL, _close
from torch_capture_mode import CaptureBreak, NoCaptureBreaks

torch.set_num_threads(1)

B = SMALL["mini_batch_size"]


# ---------------------------------------------------------------- (a)

def _pair(k):
    """JAX and port steps (k > 1: build_multi_step, donated) on one
    bridged start state, and k * B batches of the train split."""
    kw = dict(SMALL, donate_state=True)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    train = jdata(jcfg, "train")
    _, _, jstate, jstep, _ = jbuild_all(jcfg, train)
    _, _, _, tstep, _ = tbuild_all(tcfg, train, device="cpu")
    if k > 1:
        jstep = jmulti(jstep, k, donate=True)
        tstep = build_multi_step(tstep, k, donate=True)
    batches = list(jbatches(train, B * k, drop_last=True))
    return jstep, jstate, tstep, from_reference(jstate, "cpu"), batches


@pytest.mark.parametrize("k,valids", [
    (1, [B, B - 37, 0, B]),
    (4, [4 * B, 2 * B + 17, 0, B - 5]),
])
def test_device_valid_matches_jax(k, valids):
    jstep, jstate, tstep, tstate, batches = _pair(k)
    promotions = 0
    for i, v in enumerate(valids):
        dense, sparse, label, _ = batches[i % len(batches)]
        jstate, jm = jstep(jstate, jnp.asarray(dense), jnp.asarray(sparse),
                           jnp.asarray(label), v)
        tstate, tm = tstep(tstate, torch.from_numpy(dense),
                           torch.from_numpy(sparse), torch.from_numpy(label),
                           torch.tensor(v, dtype=torch.int32))
        assert float(tm["weight"]) == float(jm["weight"]) == v
        for name in jm:
            np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                       rtol=1e-5, atol=1e-5,
                                       err_msg=f"{name}, step {i}")
        js, ts = to_numpy(from_reference(jstate, "cpu")), to_numpy(tstate)
        for f in SKETCH_EXACT:
            np.testing.assert_array_equal(
                ts["embed"]["part0"]["sketch"][f],
                js["embed"]["part0"]["sketch"][f], err_msg=f"{f}, step {i}")
        assert int(ts["embed"]["part0"]["tick"]) == \
            int(js["embed"]["part0"]["tick"]) == (i + 1) * k
        assert int(ts["step"]) == int(js["step"]) == (i + 1) * k
        _close(ts["params"], js["params"], 1e-5, f"step {i} params")
        np.testing.assert_allclose(ts["embed"]["part0"]["table"],
                                   js["embed"]["part0"]["table"],
                                   rtol=1e-5, atol=1e-5)
        promotions += float(jm["cafe_promotions"])
    assert promotions > 0


@pytest.mark.parametrize("k", [1, 4])
def test_int_and_tensor_valid_give_the_same_bits(k):
    """One graph serves every valid: the step computes the weights from
    the tensor, and an int takes the same path."""
    _, jstate, tstep, _, batches = _pair(k)
    runs = []
    for as_tensor in (False, True):
        state = from_reference(jstate, "cpu")
        out = []
        for i, v in enumerate([k * B, k * B - 37, 0]):
            dense, sparse, label, _ = batches[i % len(batches)]
            vv = torch.tensor(v, dtype=torch.int32) if as_tensor else v
            state, m = tstep(state, torch.from_numpy(dense),
                             torch.from_numpy(sparse),
                             torch.from_numpy(label), vv)
            out.append({name: float(x) for name, x in m.items()})
        runs.append((to_numpy(state), out))
    (s_int, m_int), (s_t, m_t) = runs
    assert m_int == m_t
    np.testing.assert_equal(s_int, s_t)


# ---------------------------------------------------------------- (b)

def test_the_mode_catches_each_kind():
    x = torch.arange(6.0)
    for bad in (lambda: x.sum().item(), lambda: int(x[2]),
                lambda: bool(x[1] > 0), lambda: x[x > 2],
                lambda: torch.nonzero(x), lambda: torch.unique(x),
                lambda: x.masked_fill(x > 2, 0)[x > 3],
                lambda: cond(x[1] > 0, lambda: x.sum().item(),
                             lambda: 0.0)):
        with pytest.raises(CaptureBreak), NoCaptureBreaks():
            bad()
    with NoCaptureBreaks():       # masks as data, not as shapes, pass
        torch.where(x > 2, x, 0.0).sum()
        x.masked_fill(x > 2, 0.0)
        # a branch predicate, which a graph takes on the card
        assert host_pred(x[1] > 0)
        cond(x[1] > 0, lambda: x + 1, lambda: x - 1)


# batch 16 over 4 fields: the CAFE table's 1,024 rows exceed 8 rows an
# update lane, so Adagrad / Adam take the per-row arm (ops/sparse.py)
BC = 16
CAPTURE_KW = dict(SMALL, mini_batch_size=BC)
GRAPHED = {
    "headline": {},                                  # index_add_
    "dense_k3": {"sparse_apply_impl": "dense"},      # K3's plain version
    "k2": {"sparse_apply_impl": "pallas"},           # K2's plain version
    "grad_norm_scores": {"cafe_use_freq": False,
                         "cafe_sketch_threshold": 50.0},
    "lr_schedule": {"lr_num_warmup_steps": 4, "lr_decay_start_step": 6,
                    "lr_num_decay_steps": 8},
    "hash": {"compress_method": "hash"},
    # CAFE+: its decay and reset are device branches
    "cafe_plus": {"cafe_plus": True, "cafe_sketch_threshold": 1.0,
                  "cafe_alpha": 12.0},
    # fixed-shape coalesced rows (ops/sparse.py)
    "adagrad": {"optimizer": "adagrad"},
    "adam": {"optimizer": "adam"},
    # the skipped insert is a device branch
    "insert_interval": {"cafe_insert_interval": 2},
    "plus_insert_interval": {"cafe_plus": True, "cafe_insert_interval": 2},
}
# a step that a graphed step runs eagerly: AdaEmbed's check step (step
# 1) draws its sample on the host and rebuilds through data-shaped ops
EAGER = {
    "ada_check": {"compress_method": "ada", "compress_rate": 0.5},
}


def _cpu_build(extra, mesh=None):
    cfg = TConfig(**dict(CAPTURE_KW, **extra))
    _, embed, state, step, eval_step = tbuild_all(cfg, device="cpu",
                                                  mesh=mesh)
    data = get_dataset(cfg, "train")
    batch = [torch.from_numpy(np.ascontiguousarray(a)) for a in
             (data.dense[:BC], data.sparse[:BC], data.label[:BC])]
    return cfg, embed, state, step, eval_step, batch


@pytest.mark.parametrize("name", sorted(GRAPHED))
def test_graphable_steps_run_under_the_mode(name):
    cfg, embed, state, step, eval_step, batch = _cpu_build(GRAPHED[name])
    assert capture_blockers(cfg, embed) == []
    assert step.graphed is False           # the CPU has no graphs
    multi = build_multi_step(step, 2, donate=True)
    multi_batch = [torch.cat([x, x]) for x in batch]
    valid = torch.tensor(BC - 3, dtype=torch.int32)
    # one eager call first, as the graph's warm-up makes its constants
    state, _ = step(state, *batch, valid)
    state, _ = multi(state, *multi_batch, valid)
    eval_step(state, batch[0], batch[1])
    with NoCaptureBreaks():
        state, m = step(state, *batch, valid)
        state, _ = multi(state, *multi_batch, valid)
        p = eval_step(state, batch[0], batch[1])
    assert torch.isfinite(m["loss"]) and p.shape == (BC,)


@pytest.mark.parametrize("name", sorted(EAGER))
def test_eager_steps_trip_the_mode(name):
    cfg, embed, state, step, _, batch = _cpu_build(EAGER[name])
    assert capture_blockers(cfg, embed) == []
    (part,) = [p for p in embed.parts if p.host_step is not None]
    assert part.host_step(1) and not part.host_step(2)
    valid = torch.tensor(BC, dtype=torch.int32)
    with pytest.raises(CaptureBreak), NoCaptureBreaks():
        step(state, *batch, valid)


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
def test_per_row_arm_in_graphed_optimizer_cases(optimizer):
    """The Adagrad / Adam cases of GRAPHED take the per-row arm, not the
    table pass: the CAFE table's rows exceed 8 rows an update lane."""
    _, embed, *_ = _cpu_build(GRAPHED[optimizer])
    for part in embed.parts:
        assert part.total_rows > 8 * BC * len(part.field_idx)


@pytest.mark.parametrize("name", sorted(GRAPHED) + sorted(EAGER))
def test_only_donate_off_blocks_on_one_device(name):
    """On one device the optimizer, the insert interval, CAFE+ and
    AdaEmbed block nothing; donate_state False does, with its reason."""
    extra = dict(GRAPHED[name] if name in GRAPHED else EAGER[name],
                 donate_state=False)
    cfg, embed, *_ = _cpu_build(extra)
    assert [b.split(":")[0] for b in capture_blockers(cfg, embed)] == \
        ["donate_state False"]


def test_sharded_a2a_step_trips_the_mode(monkeypatch):
    """The mesh step at world size 1 (a gloo group in this process): the
    a2a legs' overflow flag is a device branch (exchange.any_rank feeds
    utils/cond.cond), so the mesh blocks no capture and the step runs
    under the mode; the same step with that flag read on the host
    outside the branch's predicate trips it."""
    import torch.distributed as dist
    from cafe_tpu_torch.parallel import exchange
    from cafe_tpu_torch.parallel import make_mesh, maybe_init_distributed
    own = maybe_init_distributed(TConfig(), "cpu")
    mesh = make_mesh(1, device="cpu")
    try:
        cfg, embed, state, step, eval_step, batch = _cpu_build(
            {"mesh_shape": 1, "shard_embeddings": True,
             "shard_exchange": "a2a"}, mesh=mesh)
        assert capture_blockers(cfg, embed, mesh) == []
        assert step.graphed is False and eval_step.graphed is False
        valid = torch.tensor(BC, dtype=torch.int32)
        state, _ = step(state, *batch, valid)
        with NoCaptureBreaks():
            state, _ = step(state, *batch, valid)
        monkeypatch.setattr(
            exchange, "cond", lambda pred, t, f, ops, name: (
                t if bool(pred) else f)(*ops))
        with pytest.raises(CaptureBreak), NoCaptureBreaks():
            step(state, *batch, valid)
    finally:
        mesh.close()
        if own:
            dist.destroy_process_group()


def test_donate_off_is_eager_with_its_reason():
    cfg, embed, _, step, _, _ = _cpu_build({"donate_state": False})
    assert [b.split(":")[0] for b in capture_blockers(cfg, embed)] == \
        ["donate_state False"]
    assert build_multi_step(step, 2, donate=False).graphed is False


# ---------------------------------------------------------------- (c)

def test_eval_loop_keeps_each_batch_with_a_reused_output():
    """An eval step that writes every batch's scores into one tensor and
    returns it: inference must still see each batch's own scores."""
    rng = np.random.default_rng(0)
    n, bs = 200, 64
    data = CTRArrays(rng.integers(0, 50, (n, 3)).astype(np.int32),
                     rng.random((n, 2)).astype(np.float32),
                     rng.integers(0, 2, n).astype(np.int32),
                     np.full(3, 50, np.int32))
    out = torch.zeros(bs)

    def reused(state, dense, sparse):
        return out.copy_(sparse[:, 0].float() / 50.0)

    state = type("S", (), {"step": torch.zeros((), dtype=torch.int32)})()
    cfg = TConfig(test_mini_batch_size=bs)
    got, _ = inference(cfg, reused, state, data)
    want = binary_metrics(data.label.astype(np.float32),
                          data.sparse[:, 0].astype(np.float32) / 50.0)
    assert got == pytest.approx(want, rel=1e-6)
