"""The port's driver against the JAX package's: lr schedule, multi-step,
checkpoints and exact-batch resume, the memmap datasets, streaming and
throughput eval, and main_torch.main against the JAX run.

Whole-step comparisons start from one bridged state (torch cannot
reproduce jax.random); float tolerances are those of
tests/test_torch_train.py (f32 towers, 1e-5).
"""

import dataclasses
import os
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.data import datasets as jds
from cafe_tpu.train import loop as jloop
from cafe_tpu.train.lr_schedule import lr_policy as jlr
from cafe_tpu.train.step import build_multi_step as jmulti
from cafe_tpu_torch.bridge import from_reference, to_numpy
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.data import datasets as tds
from cafe_tpu_torch.data.loader import device_prefetch
from cafe_tpu_torch.train import loop as tloop
from cafe_tpu_torch.train.checkpoint import (load_checkpoint,
                                             save_checkpoint, save_rolling)
from cafe_tpu_torch.train.lr_schedule import lr_policy as tlr
from cafe_tpu_torch.train.step import TrainState
from cafe_tpu_torch.train.step import build_multi_step as tmulti
from test_torch_train import SKETCH_EXACT, SMALL, _close, _run

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SCHEDULES = [(0.1, 8, 24, 24), (0.1, 0, 10, 30), (0.37, 5, 5, 0),
             (0.3, 7, 13, 29)]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_lr_policy_bit_equal(sched):
    base, warm, start, decay = sched
    for s in range(81):
        want = np.asarray(jlr(base, jnp.asarray(s, jnp.int32), warm, start,
                              decay))
        got = tlr(base, torch.tensor(s, dtype=torch.int32), warm, start,
                  decay)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=str(s))


def test_timed_window_and_queue_bound():
    from cafe_tpu_torch.utils.timing import queue_bound, timed_window
    calls = []
    secs = timed_window(lambda: calls.append(1) or torch.ones(2), 5)
    assert len(calls) == 5 and secs >= 0.0
    assert queue_bound() >= 1


def test_lr_policy_warmup_after_decay_raises():
    with pytest.raises(ValueError, match="warmup"):
        tlr(0.1, torch.tensor(0), 10, 5, 3)


def test_scheduled_steps_match_jax():
    kw = dict(SMALL, lr_num_warmup_steps=2, lr_decay_start_step=2,
              lr_num_decay_steps=3)
    _, jout, tout, *_ = _run(kw, steps=3)
    for i, ((js, jm), (ts, tm)) in enumerate(zip(jout, tout)):
        for k in jm:
            np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5, atol=1e-5,
                                       err_msg=f"metric {k}, step {i}")
        _close(ts["params"], js["params"], 1e-5, f"step {i} params")
        np.testing.assert_allclose(ts["embed"]["part0"]["table"],
                                   js["embed"]["part0"]["table"],
                                   rtol=1e-5, atol=1e-5)
        for f in SKETCH_EXACT:
            np.testing.assert_array_equal(ts["embed"]["part0"]["sketch"][f],
                                          js["embed"]["part0"]["sketch"][f])


def _build_pair(kw):
    """The JAX build and the port's, the port's state bridged from the
    JAX one: ((state, step, eval) of each, the JAX train arrays)."""
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jtrain = jloop.get_dataset(jcfg, "train")
    _, _, jstate, jstep, jeval = jloop.build_all(jcfg, jtrain)
    _, _, _, tstep, teval = tloop.build_all(
        tcfg, tloop.get_dataset(tcfg, "train"), device="cpu")
    return (jstate, jstep, jeval), (from_reference(jstate, "cpu"), tstep,
                                    teval), jtrain


def _flat(data, lo, rows):
    sl = slice(lo, lo + rows)
    return data.dense[sl], data.sparse[sl], data.label[sl].astype(
        np.float32)


def _torch(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _copy(state):
    """A TrainState-shaped tree of numpy copies (the step updates in
    place, so a second run needs its own copy)."""
    return TrainState(**to_numpy(state))


def test_multi_step_equals_single_steps_and_jax():
    """k=4 over a flat batch whose last sub-batch is part padding: the
    port's multi-step is bit-equal to 4 single steps, and its metrics
    and state match the JAX package's multi-step."""
    k, b = 4, SMALL["mini_batch_size"]
    (jstate, jstep, _), (tstate, tstep, _), train = _build_pair(
        dict(SMALL, donate_state=False))
    valid = 3 * b + b // 2
    dense, sparse, label = _flat(train, 0, k * b)
    jstate, jm = jmulti(jstep, k)(jstate, jnp.asarray(dense),
                                  jnp.asarray(sparse), jnp.asarray(label),
                                  jnp.asarray(valid, jnp.int32))
    singles = from_reference(_copy(tstate), "cpu")
    tstate, tm = tmulti(tstep, k)(tstate, *_torch(dense, sparse, label),
                                  valid)
    for i in range(k):
        sl = slice(i * b, (i + 1) * b)
        singles, _ = tstep(singles, *_torch(dense[sl], sparse[sl],
                                            label[sl]),
                           min(max(valid - i * b, 0), b))
    np.testing.assert_equal(to_numpy(singles), to_numpy(tstate))
    assert set(tm) == set(jm)
    for name in jm:
        np.testing.assert_allclose(float(tm[name]), float(jm[name]),
                                   rtol=1e-5, atol=1e-5, err_msg=name)
    js = to_numpy(from_reference(jstate, "cpu"))
    ts = to_numpy(tstate)
    _close(ts["params"], js["params"], 1e-5)
    for f in SKETCH_EXACT:
        np.testing.assert_array_equal(ts["embed"]["part0"]["sketch"][f],
                                      js["embed"]["part0"]["sketch"][f])


def test_multi_step_zero_weight_subbatches_no_nan():
    tcfg = TConfig(**SMALL)
    train = tloop.get_dataset(tcfg, "train")
    *_, state, step, _ = tloop.build_all(tcfg, train, device="cpu")
    b = tcfg.mini_batch_size
    dense, sparse, label = _flat(train, 0, 4 * b)
    _, m = tmulti(step, 4)(state, *_torch(dense, sparse, label), b // 2)
    for name, v in m.items():
        assert torch.isfinite(torch.as_tensor(v, dtype=torch.float32)), name
    assert float(m["weight"]) == b // 2
    assert 0.0 <= float(m["cafe_hot_frac"]) <= 1.0


def _trained_port_state(optimizer="adam", steps=2):
    tcfg = TConfig(**dict(SMALL, optimizer=optimizer))
    train = tloop.get_dataset(tcfg, "train")
    *_, state, step, _ = tloop.build_all(tcfg, train, device="cpu")
    b = tcfg.mini_batch_size
    for i in range(steps):
        state, _ = step(state, *_torch(*_flat(train, i * b, b)), b)
    return tcfg, train, state


def test_checkpoint_round_trip_bit_equal(tmp_path):
    tcfg, train, state = _trained_port_state()
    assert int(state.embed["part0"]["sketch"]["free_top"]) > 0
    path = str(tmp_path / "ck" / "m")
    save_checkpoint(path, state, {"test_acc": 0.5, "epoch": 0, "iter": 2})
    *_, fresh, _, _ = tloop.build_all(tcfg, train, device="cpu")
    loaded, extra = load_checkpoint(path, fresh)
    assert extra == {"test_acc": 0.5, "epoch": 0, "iter": 2}
    np.testing.assert_equal(to_numpy(loaded), to_numpy(state))
    assert int(loaded.embed["part0"]["tick"]) == 2
    assert int(loaded.step) == 2
    # a state of another shape, or with another optimizer, is refused
    for other in (dict(SMALL, embedding_dim=16), dict(SMALL)):
        *_, wrong, _, _ = tloop.build_all(TConfig(**other), train,
                                          device="cpu")
        with pytest.raises(ValueError, match="checkpoint"):
            load_checkpoint(path, wrong)


def test_save_rolling_alternates_and_latest_resumes(tmp_path):
    tcfg, train, state = _trained_port_state(optimizer="sgd", steps=1)
    path = str(tmp_path / "m")
    slots = []
    for it in (1, 2, 3):
        save_rolling(path, state, {"test_acc": 0.0, "epoch": 0, "iter": it})
        slots.append(os.readlink(path + ".latest"))
    assert slots == ["m.ra", "m.rb", "m.ra"]
    *_, fresh, _, _ = tloop.build_all(tcfg, train, device="cpu")
    loaded, extra = load_checkpoint(path + ".latest", fresh)
    assert extra["iter"] == 3
    np.testing.assert_equal(to_numpy(loaded), to_numpy(state))


def test_resume_mid_dispatch_exact(tmp_path):
    """Checkpoint at an iter that is not a multiple of the resuming run's
    steps_per_dispatch, resume with k=4 via start_row, and land bit-equal
    with an uninterrupted single-step run (tests/test_train.py)."""
    from cafe_tpu_torch.data import CTRArrays, make_synthetic_arrays
    data = make_synthetic_arrays(rows=2400, fields=4, vocab=20000, dense=4,
                                 zipf=1.3, seed=7)
    train = CTRArrays(data.sparse, data.dense, data.label, data.counts)
    cfg = TConfig(dataset="synthetic", compress_method="cafe",
                  compress_rate=0.01, cafe_sketch_threshold=5.0,
                  embedding_dim=8, learning_rate=0.1)
    b, k, stop, total = 64, 4, 11, 27

    def fresh():
        return tloop.build_all(cfg, train, device="cpu")[2:4]

    def batches(size, start_row=0):
        return device_prefetch(tds.batch_iterator(
            train, size, start_row=start_row, drop_last=True), "cpu")

    s_ref, step = fresh()
    for i, (dense, sparse, label, valid) in enumerate(batches(b)):
        if i == total:
            break
        s_ref, _ = step(s_ref, dense, sparse, label, valid)
    s, step = fresh()
    for i, (dense, sparse, label, valid) in enumerate(batches(b)):
        if i == stop:
            break
        s, _ = step(s, dense, sparse, label, valid)
    path = str(tmp_path / "mid")
    save_checkpoint(path, s, {"test_acc": 0.0, "epoch": 0, "iter": stop})
    s2, step = fresh()
    s2, extra = load_checkpoint(path, s2)
    multi = tmulti(step, k)
    done = stop
    for dense, sparse, label, valid in batches(k * b, extra["iter"] * b):
        if done + k > total:
            break
        s2, _ = multi(s2, dense, sparse, label, valid)
        done += k
    for dense, sparse, label, valid in batches(b, done * b):
        if done == total:
            break
        s2, _ = step(s2, dense, sparse, label, valid)
        done += 1
    np.testing.assert_equal(to_numpy(s2), to_numpy(s_ref))


def _write_flat(path, rows, n_sparse, n_dense, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    counts = rng.integers(5, 300, n_sparse).astype(np.int32)
    sparse = (rng.random((rows, n_sparse)) * counts).astype(np.int32)
    sparse.tofile(os.path.join(path, "processed_sparse_sep.bin"))
    if n_dense:
        rng.random((rows, n_dense)).astype(np.float32).tofile(
            os.path.join(path, "processed_dense.bin"))
    rng.integers(0, 2, rows).astype(np.int32).tofile(
        os.path.join(path, "processed_label.bin"))
    counts.tofile(os.path.join(path, "processed_count.bin"))


def _write_criteotb(path, rows_per_day, seed):
    rng = np.random.default_rng(seed)
    os.makedirs(path, exist_ok=True)
    counts = rng.integers(5, 300, 26).astype(np.int32)
    counts.tofile(os.path.join(path, "processed_count.bin"))
    for day in range(24):
        r = rows_per_day + day % 3
        (rng.random((r, 26)) * counts).astype(np.int32).tofile(
            os.path.join(path, f"sparse_{day}_sep.bin"))
        rng.random((r, 13)).astype(np.float32).tofile(
            os.path.join(path, f"dense_{day}.bin"))
        rng.integers(0, 2, r).astype(np.int32).tofile(
            os.path.join(path, f"label_{day}.bin"))


@pytest.mark.parametrize("name", ["criteo", "avazu", "kdd12", "criteotb"])
def test_memmap_datasets_match_jax(tmp_path, name):
    path = str(tmp_path / name)
    if name == "criteotb":
        _write_criteotb(path, 20, seed=3)
    else:
        shape = {"criteo": (26, 13), "avazu": (22, 0), "kdd12": (11, 0)}
        _write_flat(path, 301, *shape[name], seed=len(name))
    for phase in ("train", "test"):
        for mir in (-1, 50):
            j = jds.load_dataset(name, path, phase, mir)
            t = tds.load_dataset(name, path, phase, mir)
            assert len(t) == len(j) > 0
            np.testing.assert_array_equal(t.counts, j.counts)
            assert tds.num_batches(t, 16) == jds.num_batches(j, 16)
            for kw in (dict(), dict(drop_last=True),
                       dict(start_row=5, start_batch=1)):
                got = list(tds.batch_iterator(t, 16, **kw))
                want = list(jds.batch_iterator(j, 16, **kw))
                assert len(got) == len(want) > 0
                for g, w in zip(got, want):
                    assert g[3] == w[3]
                    for a, c in zip(g[:3], w[:3]):
                        np.testing.assert_array_equal(a, c)
    tcfg = TConfig(dataset=name, data_path=path, max_ind_range=50)
    jcfg = JConfig(dataset=name, data_path=path, max_ind_range=50)
    t, j = tloop.get_dataset(tcfg, "train"), jloop.get_dataset(jcfg, "train")
    np.testing.assert_array_equal(next(tds.batch_iterator(t, 8))[1],
                                  next(jds.batch_iterator(j, 8))[1])
    assert int(np.max(next(tds.batch_iterator(t, 8))[1])) < 50


def test_inference_matches_jax():
    kw = dict(SMALL, test_mini_batch_size=64)
    (jstate, _, jeval), (tstate, _, teval), _ = _build_pair(kw)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    test_j = jloop.get_dataset(jcfg, "test")
    test_t = tloop.get_dataset(tcfg, "test")
    want, _ = jloop.inference(jcfg, jeval, jstate, test_j)
    got, ms = tloop.inference(tcfg, teval, tstate, test_t)
    assert set(got) == set(want) and ms == 0.0
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)


def test_inference_throughput_cycles_small_test_set():
    tcfg = TConfig(**dict(SMALL, test_mini_batch_size=48))
    train = tloop.get_dataset(tcfg, "train")
    *_, state, _, eval_step = tloop.build_all(tcfg, train, device="cpu")
    test = tloop.get_dataset(tcfg, "test")
    assert tds.num_batches(test, 48) == 4
    small = tds.CTRArrays(test.sparse[:144], test.dense[:144],
                          test.label[:144], test.counts)
    seen = []

    def counting(st, dense, ids):
        seen.append(ids.data_ptr())
        return eval_step(st, dense, ids)

    metrics, ms = tloop.inference(tcfg, counting, state, small,
                                  throughput=True)
    assert metrics == {} and ms > 0.0
    assert len(seen) == 1024
    # the 3 batches were staged once and cycled
    assert len(set(seen)) == 3


@pytest.mark.parametrize("flag", [
    ["--mesh_shape", "2", "--mesh_inner", "2"],
    ["--shard_embeddings", "true", "--shard_exchange", "auto"],
    ["--dist_num_processes", "2", "--shard_unique_frac", "0.25"],
    ["--quantize_emb_bits", "8"],
    ["--compress_method", "qr", "--shard_embeddings", "true"],
    ["--compress_method", "off", "--shard_embeddings", "true"],
    ["--compress_method", "ada", "--shard_embeddings", "true"]])
def test_missing_configurations_raise(flag):
    import main_torch
    base = ["--force_platform", "cpu", "--dataset", "synthetic",
            "--synthetic_rows", "256", "--synthetic_fields", "2",
            "--synthetic_vocab", "3000", "--compress_method", "cafe",
            "--compress_rate", "0.01", "--tensor_board_filename", ""]
    with pytest.raises(NotImplementedError, match="ROADMAP queue"):
        main_torch.main(base + flag)


def _events(out: str):
    """(kind, it) for every train print and test event, in order."""
    ev = []
    for ln in out.splitlines():
        if ln.startswith("Finished training it "):
            w = ln.split()
            assert np.isfinite(float(w[-1])), ln
            ev.append(("train", w[3]))
        elif ln.startswith(" accuracy"):
            ev.append(("test", ""))
    return ev


def test_main_torch_matches_jax_run(tmp_path, capsys):
    sys.path.insert(0, str(REPO))
    import main_torch
    flags = dict(dataset="synthetic", synthetic_rows=1024,
                 synthetic_fields=4, synthetic_vocab=2000,
                 synthetic_dense=4, embedding_dim=8, mini_batch_size=128,
                 test_mini_batch_size=256, compress_method="cafe",
                 compress_rate=0.05, learning_rate=0.1, print_freq=2,
                 test_freq=3, sparse_apply_impl="dense",
                 lr_num_warmup_steps=2, lr_decay_start_step=3,
                 lr_num_decay_steps=4)
    jres = jloop.run(JConfig(**dict(
        flags, force_platform="",
        tensor_board_filename=str(tmp_path / "j"))))
    jout = capsys.readouterr().out
    argv = [x for k, v in flags.items() for x in (f"--{k}", str(v))]
    tres = main_torch.main(argv + [
        "--force_platform", "cpu",
        "--tensor_board_filename", str(tmp_path / "t"),
        "--save_model", str(tmp_path / "t" / "m")])
    tout = capsys.readouterr().out
    jev, tev = _events(jout), _events(tout)
    assert tev == jev
    assert ("train", "7/7") in tev and tev.count(("test", "")) == 3
    assert set(tres["metrics"]) == set(jres["metrics"])
    assert os.path.exists(tmp_path / "t" / "m")
    assert (tmp_path / "t" / "scalars.jsonl").stat().st_size > 0
    assert dataclasses.asdict(TConfig(**flags)) == \
        dataclasses.asdict(JConfig(**flags))


def test_main_torch_multi_step_profile_and_resume(tmp_path, capsys):
    """k=2 dispatch, the profiler window, rolling saves, then a resume
    from the rolling slot that continues at the saved iteration."""
    sys.path.insert(0, str(REPO))
    import main_torch
    out = tmp_path / "run"
    argv = ["--force_platform", "cpu", "--dataset", "synthetic",
            "--synthetic_rows", "4096", "--synthetic_fields", "4",
            "--synthetic_vocab", "2000", "--embedding_dim", "8",
            "--mini_batch_size", "128", "--compress_method", "cafe",
            "--compress_rate", "0.05", "--steps_per_dispatch", "2",
            "--print_freq", "4", "--tensor_board_filename", str(out),
            "--save_model", str(out / "m"), "--save_freq", "6"]
    main_torch.main(argv + ["--test_freq", "10", "--enable_profiling",
                            "true", "--profile_steps", "2"])
    ev = _events(capsys.readouterr().out)
    assert [it for kind, it in ev if kind == "train"] == \
        [f"{i}/28" for i in range(2, 29, 2)]
    assert ev.count(("test", "")) == 3
    assert (out / "profile" / "trace.json").stat().st_size > 0
    assert os.readlink(out / "m.latest") == "m.ra"    # saves at 6..24, 28
    (out / "m").unlink()       # no best checkpoint: resume from .latest
    main_torch.main(argv + ["--load_model", str(out / "m")])
    text = capsys.readouterr().out
    assert "resuming from the rolling checkpoint" in text
    assert "loaded" in text and "iter=28" in text
    assert _events(text) == []       # nothing left to train
