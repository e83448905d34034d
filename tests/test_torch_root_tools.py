"""The port's root measurement tools (tools/*_torch.py) on the CPU at small
sizes, each held against its JAX twin: the JAX tool's own function where
it has one (profile_step.summarize, sweep_cafe_vs_hash.split and
train_eval), else the JAX package functions its main() calls, on the
same numpy-made inputs.

* latency_grid: memory_rows() of each method's layer equals the JAX
  package's; the record holds the JAX record's keys; --boards writes
  what visualization.plot_latency reads;
* step_breakdown / profile_step / profile_lines / profile_train: the
  grids and configs, summarize's table, the line attribution on a
  hand-built trace, the per-line total against the trace's busy time;
* sweep / variance: split and train_eval from the JAX package's state
  (bridge.from_reference, integer scores) against the JAX tool's
  train_eval: AUC within 1e-4;
* ab_interact: every arm's output and gradient against the JAX
  einsum's, within the bf16 bound (2e-3 of the largest value, less one
  bf16 rounding step of each value for the bf16 arms);
* ab_scatter_vs_sorted: arms B1 and B2 against each other and the JAX
  package's apply_rows; reset_cost: the fire count equals the JAX
  sketch_insert_plus's exactly; the probes' keys and op names.
"""

import ast
import dataclasses
import gzip
import importlib.util
import json
import math
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.data import make_synthetic_arrays as jarrays
from cafe_tpu.train.loop import build_all as jbuild_all
from cafe_tpu_torch import bridge
from cafe_tpu_torch.config import Config
from cafe_tpu_torch.data import make_synthetic_arrays

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
AUC_TOL = 1e-4
BF16_TOL = 2e-3


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _modded_criteo(mod, batch=2048, n_batches=8):
    """make_criteo_batches on the CPU with every id taken modulo `mod` and
    the vocabularies capped at it (a CPU-sized run of a full-width tool,
    as --max_ind_range makes the loader's)."""
    from cafe_tpu_torch.data import CTRArrays, make_criteo_batches
    data, batches = make_criteo_batches(batch, n_batches, device="cpu")
    return (CTRArrays(data.sparse % mod, data.dense, data.label,
                      np.minimum(data.counts, mod)),
            [(d, s % mod, lab, v) for d, s, lab, v in batches])


def _dict_keys(path, var):
    """The keys of the dict literal assigned to `var` in a tool's source."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Dict) \
                and any(getattr(t, "id", None) == var for t in node.targets):
            return {k.value for k in node.value.keys
                    if isinstance(k, ast.Constant)}
    raise LookupError(f"{path}: no dict assigned to {var}")


# ---- latency_grid ----------------------------------------------------------

@pytest.mark.parametrize("method", ["hash", "qr", "mde", "ada", "cafe"])
def test_latency_memory_rows_match_jax(method):
    from cafe_tpu.embeddings import build_embedding_layer as jbuild
    from cafe_tpu_torch.data import CRITEO_COUNTS
    from cafe_tpu_torch.embeddings import build_embedding_layer
    lg = _load("latency_grid_torch")
    cfg = lg.grid_config(method)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    got = build_embedding_layer(cfg, CRITEO_COUNTS, 128,
                                device="cpu").memory_rows()
    want = jbuild(jcfg, CRITEO_COUNTS, 128).memory_rows()
    assert got == want > 0


def test_latency_record_holds_the_jax_keys(tmp_path):
    from cafe_tpu_torch.tools import visualization
    from cafe_tpu_torch.train.capture import WARMUP_CALLS
    lg = _load("latency_grid_torch")
    data, batches = _modded_criteo(500, batch=128)
    tb = lg.eval_batches(data, "cpu", batch=256)
    recs = lg.run_grid(["hash", "cafe"], data, batches, tb, 1, 1, "cpu",
                       out=str(tmp_path / "grid.jsonl"),
                       boards=str(tmp_path / "b"),
                       config=lambda m: lg.grid_config(m, 128,
                                                       max_ind_range=500))
    want = _dict_keys("tools/latency_grid.py", "rec")
    assert len(want) == 11
    for rec in recs:
        assert want <= set(rec)
        assert rec["device"] == "cpu" and rec["graphed"] is False
        assert rec["train_steps"] == lg.WARMUP + 1
        assert rec["eval_calls"] == WARMUP_CALLS + 1 + 8
        assert rec["train_batch"] == 128 and rec["test_batch"] == 256
        assert rec["train_ms_per_it"] > 0 and rec["test_ms_per_it"] > 0
        board = json.loads((tmp_path / "b" / rec["method"] /
                            "latency.json").read_text())
        assert board == {"train": rec["train_ms_per_it"],
                         "test": rec["test_ms_per_it"]}
    assert recs[1]["launches"]["land_max"] == 0   # the plain version
    assert len((tmp_path / "grid.jsonl").read_text().splitlines()) == 2
    png = tmp_path / "lat.png"
    visualization.plot_latency(str(tmp_path / "b"), str(png))
    assert png.read_bytes()[:4] == b"\x89PNG"


class _CountedStep:
    """A CPU step standing in for a GraphedStep: counts its calls and, as
    GraphedStep does, has replayed once it has been called WARMUP_CALLS
    + 1 times (the eager calls, then the capture)."""

    graphed = True

    def __init__(self, fn):
        self.fn, self.calls = fn, 0

    @property
    def replays(self):
        from cafe_tpu_torch.train.capture import WARMUP_CALLS
        return max(0, self.calls - WARMUP_CALLS)

    def __call__(self, *args):
        self.calls += 1
        return self.fn(*args)


def test_latency_grid_captures_both_steps_before_timing(monkeypatch):
    """Every timed call replays: the warm-up calls the eval step WARMUP_CALLS
    + 1 times, so its capture never lands in the first eval window."""
    from cafe_tpu_torch.train.capture import WARMUP_CALLS
    lg = _load("latency_grid_torch")
    real, seen = lg.build_all, {}

    def counted(cfg, data, device):
        built = real(cfg, data, device=device)
        seen["train"] = _CountedStep(built[3])
        seen["eval"] = _CountedStep(built[4])
        return (*built[:3], seen["train"], seen["eval"])
    monkeypatch.setattr(lg, "build_all", counted)
    data, batches = _modded_criteo(500, batch=128)
    tb = lg.eval_batches(data, "cpu", batch=256)
    rec, _, _ = lg.run_method("hash", data, batches, tb, 2, 1, "cpu",
                              lg.grid_config("hash", 128, max_ind_range=500))
    assert seen["eval"].calls == rec["eval_calls"] == WARMUP_CALLS + 1 + 8
    assert seen["train"].calls == rec["train_steps"] == lg.WARMUP + 2
    assert rec["graphed"] is True and rec["eval_graphed"] is True


# ---- step_breakdown, profile_step, profile_lines, profile_train -----------

def test_step_breakdown_grids_and_configs_match_the_jax_tool():
    sb = _load("step_breakdown_torch")
    assert sb.grid("criteotb") == ([("cafe", "cafe", 0.1),
                                    ("hash", "hash", 0.1)], 128, "criteotb")
    entries, dim, dataset = sb.grid("criteo")
    assert entries == [("cafe", "cafe", 0.001), ("cafe_iv8", "cafe", 0.001),
                       ("hash", "hash", 0.001), ("full", None, 1.0)]
    for name, method, cr in entries:
        # tools/step_breakdown.py:74-79
        want = JConfig(dataset=dataset, model="dlrm", embedding_dim=dim,
                       compress_method=method, compress_rate=cr,
                       cafe_sketch_threshold=500.0, cafe_hash_rate=0.5,
                       mini_batch_size=2048, learning_rate=0.1,
                       optimizer="sgd", bf16=True,
                       cafe_insert_interval=8 if name.endswith("iv8") else 1)
        got = sb.arm_config(name, method, cr, dim, dataset)
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_step_breakdown_runs_every_arm_eager_on_the_cpu(capsys):
    sb = _load("step_breakdown_torch")
    res = sb.run("criteo", steps=1, warmup=1, device="cpu",
                 data=_modded_criteo(300), max_ind_range=300)
    sb.report(res)
    names = ["cafe", "cafe_iv8", "hash", "full"]
    assert list(res["eager"]) == [n + s for n in names for s in ("", "_fwd")]
    assert "graphed" not in res and all(v > 0 for v in res["eager"].values())
    out = capsys.readouterr().out
    assert "== eager" in out and "sketch+migration overhead" in out
    assert "at the bench protocol (insert_interval=8)" in out


def _trace(path, events):
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)


TRACE = [
    {"ph": "M", "name": "thread_name", "pid": 1, "tid": 1,
     "args": {"name": "/device:TPU:0 XLA Ops"}},
    {"ph": "M", "name": "thread_name", "pid": 2, "tid": 9,
     "args": {"name": "python3"}},
    *[{"ph": "X", "pid": 1, "tid": 1, "name": n, "ts": i, "dur": d}
      for i, (n, d) in enumerate([("fusion.1", 30), ("fusion.2", 12),
                                  ("fusion.1", 5), ("scatter", 40)])],
    *[{"ph": "X", "pid": 2, "tid": 9, "name": n, "ts": i, "dur": d}
      for i, (n, d) in enumerate([("dispatch", 500), ("fence", 7),
                                  ("noop", 0)])],
    {"ph": "X", "pid": 3, "tid": 3, "name": "unnamed lane", "ts": 0,
     "dur": 4},
]


def test_profile_step_summarize_prints_the_jax_table(tmp_path, capsys):
    jps, tps = _load("profile_step"), _load("profile_step_torch")
    run = tmp_path / "plugins" / "profile" / "r1"
    run.mkdir(parents=True)
    _trace(run / "host.trace.json.gz", TRACE)
    assert tps.newest_trace(str(tmp_path)) == jps.newest_trace(str(tmp_path))
    path = tps.newest_trace(str(tmp_path))
    for top in (2, 25):
        jps.summarize(path, top)
        want = capsys.readouterr().out
        tps.summarize(path, top)
        assert capsys.readouterr().out == want
    assert "== thread: /device:TPU:0 XLA Ops  total 0.09 ms" in want


def test_profile_step_puts_cuda_streams_first(tmp_path):
    tps = _load("profile_step_torch")
    events = [{"ph": "M", "name": "thread_name", "pid": 0, "tid": 7,
               "args": {"name": "stream 7 "}},
              {"ph": "M", "name": "thread_name", "pid": 5, "tid": 5,
               "args": {"name": "thread 5 (python3)"}},
              {"ph": "X", "pid": 0, "tid": 7, "name": "land_max_kernel",
               "cat": "kernel", "ts": 0, "dur": 9},
              {"ph": "X", "pid": 5, "tid": 5, "name": "aten::sort",
               "cat": "cpu_op", "ts": 0, "dur": 900}]
    path = tmp_path / "t.json"          # torch writes plain JSON too
    path.write_text(json.dumps({"traceEvents": events}))
    table = tps.summarize(str(path), 5)
    assert list(table) == ["stream 7 ", "thread 5 (python3)"]
    assert tps.device_kernels(str(path)) == {"land_max_kernel": 1}


def test_profile_lines_attributes_kernels_to_lines():
    pl = _load("profile_lines_torch")
    fwd, bwd, dev = (1, 1), (1, 2), (0, 7)

    def x(cat, name, thread, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "pid": thread[0],
                "tid": thread[1], "ts": ts, "dur": dur, "args": args}
    events = [
        x("python_function", "/r/cafe_tpu_torch/train/step.py(220): step",
          fwd, 0, 1000),
        x("user_annotation", "@cafe_tpu_torch/models/mlp.py:50", fwd, 10,
          20),
        x("cpu_op", "aten::mm", fwd, 12, 15, **{"Sequence number": 5,
                                                "Fwd thread id": 0}),
        x("cuda_runtime", "cudaLaunchKernel", fwd, 14, 2, correlation=1),
        x("python_function",
          "/r/cafe_tpu_torch/kernels/land.py(60): land_max", fwd, 100, 50),
        x("cuda_runtime", "cudaLaunchKernel", fwd, 110, 2, correlation=2),
        # the backward of the mm, on autograd's device thread
        x("cpu_op", "MmBackward0", bwd, 300, 40, **{"Sequence number": 5,
                                                    "Fwd thread id": 1}),
        x("cuda_runtime", "cudaLaunchKernel", bwd, 310, 2, correlation=3),
        x("cuda_runtime", "cudaLaunchKernel", (9, 9), 5000, 2,
          correlation=4),
        x("kernel", "sgemm", dev, 20, 7.0, correlation=1),
        x("kernel", "land_max_kernel", dev, 120, 3.0, correlation=2),
        x("kernel", "sgemm_bwd", dev, 320, 11.0, correlation=3),
        x("kernel", "stray", dev, 5100, 1.0, correlation=4),
        # a launch known only by its ac2g flow
        {"ph": "s", "cat": "ac2g", "id": 6, "pid": 1, "tid": 1, "ts": 15},
        x("gpu_memset", "Memset", dev, 30, 2.0, correlation=6),
    ]
    got = pl.attribute(events)
    assert got == [("cafe_tpu_torch/models/mlp.py:50", 7.0),
                   ("cafe_tpu_torch/kernels/land.py(60): land_max", 3.0),
                   ("cafe_tpu_torch/models/mlp.py:50", 11.0),
                   ("?", 1.0),
                   ("cafe_tpu_torch/models/mlp.py:50", 2.0)]
    rec = pl.report(got, reps=1)
    assert rec["total_us_per_rep"] == 24.0
    assert math.isclose(rec["unattributed_share"], 1.0 / 24.0)


def test_profile_train_attributes_the_eager_step():
    pt = _load("profile_train_torch")
    rec = pt.profile(reps=1, device="cpu", data=_modded_criteo(5000),
                     max_ind_range=5000)
    assert rec["attributed_share"] >= pt.MIN_ATTRIBUTED
    assert rec["total_us_per_rep"] > 0 and rec["graphed"] is False
    lines = set(rec["lines"])
    assert any(k.startswith("cafe_tpu_torch/sketch/hotsketch.py:")
               for k in lines)
    assert any(k.startswith("cafe_tpu_torch/models/") for k in lines)


# ---- sweep and variance ----------------------------------------------------

def test_sweep_split_equals_the_jax_tools():
    jsw, tsw = _load("sweep_cafe_vs_hash"), _load("sweep_cafe_vs_hash_torch")
    kw = dict(rows=700, fields=4, vocab=300, dense=4, zipf=1.2, seed=7)
    got, want = tsw.split(make_synthetic_arrays(**kw)), \
        jsw.split(jarrays(**kw))
    for g, w in zip(got, want):
        for f in ("sparse", "dense", "label", "counts"):
            np.testing.assert_array_equal(getattr(g, f), getattr(w, f))
    assert len(got[0]) == int(700 * 6 / 7)
    assert list(itertools_grid(tsw)) == list(itertools_grid(jsw))


def itertools_grid(mod):
    """The sweep's grid as the JAX tool's main() builds it (its list
    literals) or the port's GRID."""
    import itertools
    if hasattr(mod, "GRID"):
        return itertools.product(*mod.GRID)
    tree = ast.parse((REPO / "tools/sweep_cafe_vs_hash.py").read_text())
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "attr", "") == "product")
    return itertools.product(*[ast.literal_eval(a) for a in call.args])


@pytest.mark.parametrize("method", ["hash", "cafe"])
def test_train_eval_from_the_jax_state_matches_the_jax_tool(method):
    jsw, tsw = _load("sweep_cafe_vs_hash"), _load("sweep_cafe_vs_hash_torch")
    kw = dict(rows=2100, fields=4, vocab=2000, dense=4, zipf=1.2, seed=7)
    train, test = tsw.split(make_synthetic_arrays(**kw))
    jtrain, jtest = jsw.split(jarrays(**kw))
    cfg = Config(dataset="synthetic", embedding_dim=16, learning_rate=0.1,
                 compress_rate=0.05, cafe_sketch_threshold=5.0,
                 cafe_hash_rate=0.3, test_mini_batch_size=512,
                 compress_method=method, cafe_use_freq=True)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    state = bridge.from_reference(jbuild_all(jcfg, jtrain)[2], "cpu")
    info = {}
    got, gx = tsw.train_eval(cfg, train, test, 2, device="cpu", state=state,
                             info=info)
    want, wx = jsw.train_eval(jcfg, jtrain, jtest, 2)
    assert abs(got - want) <= AUC_TOL, (got, want)
    assert set(gx) == set(wx) and gx.get("cafe_promotions") == wx.get(
        "cafe_promotions")
    assert info == {"graphed": False, "steps": 2 * (1800 // 256)}


def test_variance_config_and_split_match_the_jax_tool():
    from cafe_tpu.data.datasets import CTRArrays as JArrays
    var = _load("variance_cafe_vs_hash_torch")
    assert var.SEEDS == [11, 23, 37]
    # tools/variance_cafe_vs_hash.py:40-44
    want = JConfig(dataset="synthetic", embedding_dim=16, learning_rate=0.1,
                   compress_rate=0.003, cafe_sketch_threshold=30,
                   cafe_hash_rate=0.3, mini_batch_size=256,
                   test_mini_batch_size=16384, numpy_rand_seed=23)
    assert dataclasses.asdict(var.base_config(23)) == \
        dataclasses.asdict(want)
    data = jarrays(rows=1400, fields=6, vocab=500, dense=8, zipf=1.2,
                   seed=11)
    cut = len(data) * 6 // 7
    jtrain = JArrays(data.sparse[:cut], data.dense[:cut], data.label[:cut],
                     data.counts)
    train, test = var.seed_split(11, rows=1400, vocab=500)
    np.testing.assert_array_equal(train.sparse, jtrain.sparse)
    np.testing.assert_array_equal(train.label, jtrain.label)
    assert len(test) == 1400 - cut


# ---- ab_interact -----------------------------------------------------------

def _jax_arms():
    """tools/ab_interact.py's four formulations."""
    import jax

    def a(t):
        tb = t.astype(jnp.bfloat16)
        return jnp.einsum("bfd,bgd->bfg", tb, tb,
                          preferred_element_type=jnp.float32)

    def b(t):
        return jnp.sum(t[:, :, None, :] * t[:, None, :, :], axis=-1)

    def c(t):
        return jnp.einsum("bfd,bgd->bfg", t, t,
                          preferred_element_type=jnp.float32)

    def d(t):
        tt = jnp.transpose(t, (1, 2, 0)).astype(jnp.bfloat16)
        return jax.lax.dot_general(
            tt, tt, dimension_numbers=(((1,), (1,)), ((2,), (2,))),
            preferred_element_type=jnp.float32)
    arms = {"A_einsum_bf16": a, "B_mulreduce_f32": b, "C_einsum_f32": c,
            "D_batchminor_bf16": d}
    return {k: (f, jax.grad(lambda t, f=f: jnp.sum(f(t))))
            for k, f in arms.items()}


def test_ab_interact_arms_match_the_jax_einsums():
    ai = _load("ab_interact_torch")
    t = np.random.default_rng(3).standard_normal((64, ai.F, ai.D)).astype(
        np.float32)
    jarms = _jax_arms()
    assert list(jarms) == list(ai.ARMS)
    for name, fn in ai.ARMS.items():
        bf16 = name.endswith("bf16")
        z, g = ai.value_and_grad(fn, torch.from_numpy(t))
        jf, jg = jarms[name]
        for got, want in ((z, jf(jnp.asarray(t))), (g, jg(jnp.asarray(t)))):
            err = ai.rel_err(got, torch.from_numpy(np.array(want)), bf16)
            assert err <= BF16_TOL, (name, err)
    assert ai.check(torch.from_numpy(t))


def test_ab_interact_runs_on_the_cpu():
    ai = _load("ab_interact_torch")
    rec = ai.run(windows=1, reps=1, device="cpu", batch=32)
    assert set(rec["median_us"]) == set(ai.ARMS)
    assert rec["graphed"] is False and rec["device"] == "cpu"


# ---- ab_apply128, ab_scatter_vs_sorted, reset_cost -------------------------

def test_ab_apply128_levels_and_arms():
    ab = _load("ab_apply128_torch")
    assert ab.LEVELS == (("us_criteotb", 3376453, 128), ("us_dim16", 33792,
                                                         16))
    lines = ab.run(windows=1, steps=2, lanes=256, device="cpu",
                   levels=(("us_criteotb", 3376, 128), ("us_dim16", 33, 16)))
    assert lines[0]["pass"] and lines[0]["max_abs_err"] < ab.NUMERICS_TOL
    for rec in lines[1:]:
        assert {"level", "lanes", "rows", "dim", *ab.ARMS} <= set(rec)
        assert rec["graphed"] is False and rec["device"] == "cpu"
    assert set(ab.ARMS) | set(ab.NO_COUNTERPART) == {
        "scatter", "scatter_donated", "pallas", "pallas512"}


@pytest.mark.parametrize("impl", ["auto", "dense"])
@pytest.mark.parametrize("opt", ["sgd", "adagrad"])
def test_apply_arms_match_each_other_and_jax(monkeypatch, impl, opt):
    from cafe_tpu.ops import sparse as jsparse
    from cafe_tpu_torch.ops.sparse import init_slots
    monkeypatch.setattr(jsparse, "APPLY_IMPL", "auto")
    sv = _load("ab_scatter_vs_sorted_torch")
    x = sv.inputs("cpu", b=4096, ntab=1000, nbig=5000)
    arms = sv.b_arms(x, impl)
    outs = {}
    for kind in ("pass", "scat"):
        t = x["tab"].clone()
        outs[kind] = arms[f"apply27k_{kind}_{opt}"](t, init_slots(t, opt))
    jt, js = jsparse.apply_rows(
        jnp.asarray(x["tab"].numpy()),
        {k: jnp.asarray(v.numpy()) for k, v in
         init_slots(x["tab"], opt).items()},
        jnp.asarray(x["ridx"].numpy()), jnp.asarray(x["grad"].numpy()), 0.05,
        opt)
    for kind, (t, sl) in outs.items():
        np.testing.assert_allclose(t.numpy(), np.asarray(jt), atol=2e-6)
        for k in js:
            np.testing.assert_allclose(sl[k].numpy(), np.asarray(js[k]),
                                       rtol=1e-5, atol=1e-7)
    np.testing.assert_allclose(outs["pass"][0].numpy(),
                               outs["scat"][0].numpy(), atol=2e-6)


def test_ab_scatter_vs_sorted_inputs_are_the_jax_tools():
    sv = _load("ab_scatter_vs_sorted_torch")
    x = sv.inputs("cpu")
    rng = np.random.default_rng(0)          # tools/ab_scatter_vs_sorted.py
    rng.random(sv.B)
    rng.random(sv.B)
    np.testing.assert_array_equal(
        x["ridx"].numpy(), rng.integers(0, sv.NTAB, sv.B).astype(np.int32))
    np.testing.assert_array_equal(
        x["bigidx"].numpy(), rng.integers(0, sv.NBIG, sv.B).astype(np.int32))
    np.testing.assert_array_equal(
        x["grad"].numpy(),
        rng.standard_normal((sv.B, sv.D)).astype(np.float32) * .01)
    rec = sv.run(reps=1, windows=1, device="cpu", impl="dense", nbig=5000)
    assert set(rec["median_us"]) == {
        "null", "apply27k_pass_sgd", "apply27k_scat_sgd",
        "apply27k_pass_adagrad", "apply27k_scat_adagrad",
        "applyBIG_scat_sgd"}


def test_reset_cost_fires_equal_the_jax_insert():
    from cafe_tpu.sketch import hotsketch_plus as jhp
    from cafe_tpu_torch.sketch.hotsketch_plus import (CafePlusConfig,
                                                      init_sketch_plus)
    rc = _load("reset_cost_torch")
    cfg = CafePlusConfig(lim=64, threshold=2.0)
    jcfg = jhp.CafePlusConfig(lim=64, threshold=2.0)
    rng = np.random.default_rng(0)
    stream = [np.minimum(rng.zipf(1.1, size=(512,)), 3000)
              for _ in range(30)]
    scores = np.floor(rng.random(512) * 4.0).astype(np.float32)
    fires, st = rc.count_fires(cfg, init_sketch_plus(cfg, device="cpu"),
                               stream, torch.from_numpy(scores), "cpu")
    jst, jfires, trip = jhp.init_sketch_plus(jcfg), 0, int(64 * 1.2)
    for z in stream:
        before = int(jst.real_n)
        jst, _ = jhp.sketch_insert_plus(jcfg, jst,
                                        jnp.asarray(z.astype(np.int32)),
                                        jnp.asarray(scores))
        jfires += before > trip
    assert fires == jfires > 0
    assert int(st["real_n"]) == int(jst.real_n)
    rec = rc.run(lim=64, batch=256, vocab=3000, stream_steps=3, windows=1,
                 device="cpu")
    assert _dict_keys("tools/reset_cost.py", "res") <= set(rec)
    assert rec["reset_paid_every_step"] is False
    assert rec["no_reset_us"] > 0


# ---- the probes ------------------------------------------------------------

def test_probes_keep_the_jax_tools_keys_and_ops(capsys):
    ko = _load("kernel_overhead_probe_torch")
    assert ko.SHAPES == [(4, 53248), (8, 53248), (53248,), (256, 256),
                         (33792, 8)]
    (rec,) = ko.run(windows=1, calls=1, device="cpu", shapes=[(4, 512)])
    assert set(rec) == {"shape", "us_k16", "us_k128", "us_per_kernel",
                        "bandwidth_us_expected", "mode", "device"}
    mo = _load("micro_ops_torch")
    src = (REPO / "tools/micro_ops.py").read_text()
    jax_ops = {ln.strip().split('"')[1] for ln in src.splitlines()
               if ln.strip().startswith('add("')}
    ops = mo.build_ops("cpu", B=8192, S=97, N=271)
    assert set(ops) | set(mo.NO_COUNTERPART) == jax_ops
    assert not set(ops) & set(mo.NO_COUNTERPART)
    got = mo.run("cpu", B=8192, S=97, N=271)
    assert set(got["us_per_op"]) == set(ops)
    assert all(v > 0 for v in got["us_per_op"].values())
    cp = _load("clock_probe_torch")
    rec = cp.run(n=64, k=2, repeats=1, device="cpu")
    assert set(rec["tflops"]) == {"scan_host_sync", "chain_host_sync"}
    capsys.readouterr()
