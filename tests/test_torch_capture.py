"""The step the port captures in CUDA graphs, on the CPU.

* (a) `valid` as a device tensor: from one bridged state, the port's
  step and build_multi_step(k = 4) match the JAX package's jitted steps
  on the same batches at valid = B, a tail and 0 (integer scores, so the
  sketch compares exactly; floats within tests/test_torch_train.py's
  1e-5), and the port gives the same bits for an int and a tensor valid;
* (b) a TorchDispatchMode that raises on every value read back to the
  host (`aten._local_scalar_dense`: `.item()`, `int()`, `float()`,
  `bool()` of a tensor) and on every op whose output shape depends on
  the data (nonzero, masked_select, unique, boolean indexing): one step
  of each configuration that train/step.capture_blockers lets replay a
  graph runs under it (train, multi-step and eval), and each
  configuration it keeps eager for a host read or such an op trips it;
* (c) the eval loop keeps each batch's scores when the eval step returns
  one reused output tensor, as a graphed eval step does.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

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
from test_torch_train import SKETCH_EXACT, SMALL, _close

torch.set_num_threads(1)

B = SMALL["mini_batch_size"]
aten = torch.ops.aten


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

class CaptureBreak(AssertionError):
    """An op that a CUDA graph cannot hold."""


# reads of a value to the host: .item(), int(), float() and bool() all
# reach _local_scalar_dense
_HOST_READS = {aten._local_scalar_dense.default}
# output shapes that depend on the data
_DATA_SHAPED = {aten.nonzero, aten.masked_select, aten._unique,
                aten._unique2, aten.unique_dim, aten.unique_consecutive,
                aten.argwhere, aten.bincount, aten.masked_scatter}
_INDEXING = {aten.index, aten.index_put, aten.index_put_,
             aten._index_put_impl_}


class NoCaptureBreaks(TorchDispatchMode):
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        packet = func.overloadpacket
        if func in _HOST_READS:
            raise CaptureBreak(f"host read: {func}")
        if packet in _DATA_SHAPED or (
                packet is aten.repeat_interleave
                and "output_size" not in (kwargs or {})):
            raise CaptureBreak(f"data-dependent shape: {func}")
        if packet in _INDEXING and any(
                i is not None and i.dtype == torch.bool for i in args[1]):
            raise CaptureBreak(f"boolean indexing: {func}")
        return func(*args, **(kwargs or {}))


def test_the_mode_catches_each_kind():
    x = torch.arange(6.0)
    for bad in (lambda: x.sum().item(), lambda: int(x[2]),
                lambda: bool(x[1] > 0), lambda: x[x > 2],
                lambda: torch.nonzero(x), lambda: torch.unique(x),
                lambda: x.masked_fill(x > 2, 0)[x > 3]):
        with pytest.raises(CaptureBreak), NoCaptureBreaks():
            bad()
    with NoCaptureBreaks():       # masks as data, not as shapes, pass
        torch.where(x > 2, x, 0.0).sum()
        x.masked_fill(x > 2, 0.0)


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
    # CAFE+: its decay and reset are selected on the device every step
    "cafe_plus": {"cafe_plus": True, "cafe_sketch_threshold": 1.0,
                  "cafe_alpha": 12.0},
}
# kept eager for a host read or a data-shaped op
EAGER = {
    "adagrad": {"optimizer": "adagrad"},
    "adam": {"optimizer": "adam"},
    "insert_interval": {"cafe_insert_interval": 2},
    "plus_insert_interval": {"cafe_plus": True, "cafe_insert_interval": 2},
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
    assert capture_blockers(cfg, embed)
    valid = torch.tensor(BC, dtype=torch.int32)
    for part in embed.parts:      # the per-row arm, not the table pass
        if name in ("adagrad", "adam"):
            assert part.total_rows > 8 * BC * len(part.field_idx)
    state, _ = step(state, *batch, valid)
    with pytest.raises(CaptureBreak), NoCaptureBreaks():
        step(state, *batch, valid)


def test_sharded_a2a_step_trips_the_mode():
    """The mesh step at world size 1 (a gloo group in this process): the
    a2a legs read their overflow flag back to the host."""
    import torch.distributed as dist
    from cafe_tpu_torch.parallel import make_mesh, maybe_init_distributed
    own = maybe_init_distributed(TConfig(), "cpu")
    mesh = make_mesh(1, device="cpu")
    try:
        cfg, embed, state, step, eval_step, batch = _cpu_build(
            {"mesh_shape": 1, "shard_embeddings": True,
             "shard_exchange": "a2a"}, mesh=mesh)
        assert capture_blockers(cfg, embed, mesh)
        assert step.graphed is False and eval_step.graphed is False
        valid = torch.tensor(BC, dtype=torch.int32)
        state, _ = step(state, *batch, valid)
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
