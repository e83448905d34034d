"""DLRM + CAFE+ through the port's build_all, train step, checkpoints and
main_torch.main, against the JAX package from one bridged state.

Frequency scores (integers) throughout the exact cases: the whole CAFE+
sketch state (all 13 fields), the routed rows, the promotion counts and
the hot fraction are EXACTLY equal after every step; the loss, dense
params and tables within 1e-5 (tests/test_torch_train.py's f32 bound:
duplicate-row updates and the towers' sums run in another order). The
threshold of 1 makes every placed id cross at once, so real_n passes
1.2 x lim and the adaptive reset fires; alpha 12 fires the decay at the
4th step. One CafePart step at 26 fields x 256 promotes more than 4,096
ids, so its migration cap reverts the rest.
"""

import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.train import loop as jloop
from cafe_tpu_torch.bridge import (from_reference, to_numpy, to_reference,
                                   to_torch)
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.embeddings import build_embedding_layer
from cafe_tpu_torch.train import loop as tloop
from cafe_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from cafe_tpu_torch.train.step import capture_blockers
from test_torch_train import SMALL, _close, _run

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PLUS = dict(SMALL, cafe_plus=True, cafe_sketch_threshold=1.0)
STEPS = 5
CASES = {
    "auto": {},
    "dense_decay": {"sparse_apply_impl": "dense", "cafe_alpha": 12.0},
    # about 21 ids a step per hot slot: the auto share leaves 0.1
    "auto_staging": {"cafe_plus_staging_frac": -1.0,
                     "compress_rate": 0.02},
    "interval2": {"cafe_insert_interval": 2},
    "inherit": {"cafe_plus_inherit": True, "cafe_sketch_threshold": 2.0},
}


def _check_steps(jout, tout, exact_cnt=True):
    for i, ((js, jm), (ts, tm)) in enumerate(zip(jout, tout)):
        assert set(tm) == set(jm)
        for k in jm:
            if k == "loss":
                np.testing.assert_allclose(tm[k], jm[k], rtol=1e-5,
                                           atol=1e-5, err_msg=f"step {i}")
            else:
                assert tm[k] == jm[k], (k, i)
        _close(ts["params"], js["params"], 1e-5, f"step {i} params")
        jp, tp = js["embed"]["part0"], ts["embed"]["part0"]
        np.testing.assert_allclose(tp["table"], jp["table"], rtol=1e-5,
                                   atol=1e-5, err_msg=f"step {i} table")
        assert int(tp["tick"]) == int(jp["tick"]) == i + 1
        assert set(tp["sketch"]) == set(jp["sketch"])
        for f, want in jp["sketch"].items():
            if f in ("cnt1", "cnt2") and not exact_cnt:
                np.testing.assert_allclose(tp["sketch"][f], want,
                                           rtol=1e-5, atol=1e-4)
            else:
                np.testing.assert_array_equal(tp["sketch"][f], want,
                                              err_msg=f"{f} step {i}")


@pytest.fixture(scope="module", params=sorted(CASES))
def case(request):
    kw = dict(PLUS, **CASES[request.param])
    return request.param, kw, _run(kw, STEPS)


def test_plus_steps_match_jax(case):
    name, kw, (init, jout, tout, (jembed, tembed), (jst, tst),
               batches) = case
    np.testing.assert_equal(init[0], init[1])     # the port's own init
    part = tembed.parts[0]
    assert part.plus and type(part).__name__ == "CafePart"
    jpart = jembed.parts[0]
    assert part.sketch_cfg._asdict() == jpart.sketch_cfg._asdict()
    _check_steps(jout, tout)
    sk = tout[-1][0]["embed"]["part0"]["sketch"]
    promos = sum(m["cafe_promotions"] for _, m in tout)
    assert promos > 0
    if name == "auto":      # a step began past the trip: the reset fired
        trip = int(part.hotn * 1.2)
        assert any(int(ts["embed"]["part0"]["sketch"]["real_n"]) > trip
                   for ts, _ in tout[:-1])
    if name == "dense_decay":
        assert float(sk["decay_acc"]) < 12.0 ** STEPS
    if name == "auto_staging":
        assert part.sketch_cfg.staging_frac != 0.1
    if name == "interval2":
        assert int(sk["step"]) == (STEPS + 1) // 2
    # the routed rows of the first batch after the run
    _, jaux = jembed.gather(jst.embed, batches[0][1])
    _, taux = tembed.gather(tst.embed, torch.from_numpy(batches[0][1]))
    for j, t in zip(jaux["part0"], taux["part0"]):
        np.testing.assert_array_equal(t.numpy(), np.asarray(j))


def test_part_step_past_the_promotion_cap():
    """One CafePart step (26 fields x 256 lanes, threshold 0.5, half the
    buckets staging) promotes more than 4,096 ids: the cap (min(B*F,
    hotn, 4096)) reverts the rest and migrates 4,096 rows, as in the JAX
    package: sketch, table and stats equal."""
    from cafe_tpu.embeddings.cafe import CafePart as JPart
    from cafe_tpu_torch.embeddings.cafe import CafePart as TPart
    f, b, vocab = 26, 256, 4000
    args = (list(range(f)), [vocab] * f, [i * vocab for i in range(f)],
            8192, [400] * f, 4, 0.5, 0.99, vocab)
    kw = dict(use_freq=True, plus=True, plus_staging_frac=0.5)
    jpart, tpart = JPart(*args, **kw), TPart(*args, **kw)
    tpart.device = torch.device("cpu")
    jst = jpart.init(np.random.default_rng(0))
    tst = tpart.init(np.random.default_rng(0))
    ids = np.random.default_rng(1).integers(0, vocab, (b, f)).astype(
        np.int32)
    g = np.random.default_rng(2).normal(0, 0.1, (b, f, 4)).astype(
        np.float32)
    _, jaux = jpart.gather(jst, jnp.asarray(ids))
    jst, jm = jpart.apply_grads(jst, jnp.asarray(ids), jnp.asarray(g), jaux,
                                lr=0.1)
    _, taux = tpart.gather(tst, torch.from_numpy(ids))
    tst, tm = tpart.apply_grads(tst, torch.from_numpy(ids),
                                torch.from_numpy(g), taux, lr=0.1)
    assert int(tm["cafe_promotions"]) == int(jm["cafe_promotions"]) == 4096
    sk = tst["sketch"]
    held = int((sk["dic1"] != 0).sum() + (sk["dic2"] != 0).sum())
    assert held == 4096 == 8191 - int(sk["free_top"])
    assert int(sk["real_n"]) > 4096              # more crossed than kept
    for fld, want in jst["sketch"]._asdict().items():
        np.testing.assert_array_equal(sk[fld].numpy(), np.asarray(want),
                                      err_msg=fld)
    np.testing.assert_allclose(tst["table"].numpy(), np.asarray(jst["table"]),
                               rtol=1e-6, atol=1e-7)


def test_grad_norm_scores_match_jax():
    """Gradient-norm scores: the normalised norms sum in another order
    in the two packages, so the counts agree within 1e-4 over two steps;
    every placement, slot and report exactly."""
    kw = dict(PLUS, cafe_use_freq=False, cafe_sketch_threshold=1.5)
    _, jout, tout, *_ = _run(kw, 2)
    _check_steps(jout, tout, exact_cnt=False)
    assert sum(m["cafe_promotions"] for _, m in tout) > 0


def test_build_embedding_layer_passes_the_plus_arguments():
    """Per field and shared: the plus part's sketch config (alpha,
    adjust_threshold, inherit, the auto staging share) is the JAX
    package's."""
    from cafe_tpu.embeddings import build_embedding_layer as jbuild
    counts = [3000, 40, 900, 5000]
    for extra in ({}, {"cafe_hot_separate_field": True},
                  {"cafe_plus_staging_frac": -1.0, "compress_rate": 0.01,
                   "cafe_alpha": 1.5, "cafe_adjust_threshold": False,
                   "cafe_plus_inherit": True},
                  {"cafe_plus_staging_frac": -1.0, "compress_rate": 0.02,
                   "cafe_hot_separate_field": True}):
        kw = dict(PLUS, **extra)
        jl = jbuild(JConfig(**kw), counts, 8)
        tl = build_embedding_layer(TConfig(**kw), counts, 8, device="cpu")
        assert [type(p).__name__ for p in tl.parts] == \
            [type(p).__name__ for p in jl.parts]
        for jp, tp in zip(jl.parts, tl.parts):
            if type(tp).__name__ == "CafePart":
                assert tp.plus and jp.plus
                assert tp.sketch_cfg._asdict() == jp.sketch_cfg._asdict()
        np.testing.assert_equal(to_numpy(tl.init(3)[0]),
                                to_numpy(to_torch(jl.init(3)[0], "cpu")))


def test_bridge_round_trip_keeps_the_sketch_step():
    """The CafePlusState NamedTuple crosses both ways; its `step` field
    stays the sketch's, apart from the train state's step."""
    import jax
    jcfg = JConfig(**PLUS)
    *_, jstate, jstep, _ = jloop.build_all(jcfg, jloop.get_dataset(
        jcfg, "train"))
    sk = jstate.embed["part0"]["sketch"]
    assert type(sk).__name__ == "CafePlusState"
    jstate = jstate._replace(step=jstate.step + 7)
    tstate = from_reference(jstate, "cpu")
    assert int(tstate.step) == 7
    assert int(tstate.embed["part0"]["sketch"]["step"]) == 0
    back = to_reference(tstate, jstate)
    assert type(back.embed["part0"]["sketch"]) is type(sk)
    for j, b in zip(jax.tree.leaves(jstate), jax.tree.leaves(back)):
        np.testing.assert_array_equal(b, np.asarray(j))
        assert b.dtype == np.asarray(j).dtype


def test_capture_blockers_add_nothing_for_plus():
    """The CAFE+ step graphs wherever v1's does: no entry of its own,
    only the insert interval's (tests/test_torch_capture.py runs it under
    the no-host-read mode)."""
    for extra, want in (({}, []), ({"cafe_insert_interval": 2},
                                   ["cafe_insert_interval > 1"])):
        cfg = TConfig(**dict(PLUS, **extra))
        embed = tloop.build_all(cfg, device="cpu")[1]
        assert [b.split(":")[0] for b in capture_blockers(cfg, embed)] == \
            want


def test_checkpoint_round_trip(tmp_path):
    """A trained CAFE+ state saved and loaded into a fresh build is
    bit-equal, and the next step from either gives the same state."""
    cfg = TConfig(**PLUS)
    train = tloop.get_dataset(cfg, "train")
    *_, state, step, _ = tloop.build_all(cfg, train, device="cpu")
    b = cfg.mini_batch_size

    def batch(i):
        return (torch.from_numpy(train.dense[i * b:(i + 1) * b]),
                torch.from_numpy(train.sparse[i * b:(i + 1) * b]),
                torch.from_numpy(train.label[i * b:(i + 1) * b]), b)

    for i in range(3):
        state, _ = step(state, *batch(i))
    assert int(state.embed["part0"]["sketch"]["step"]) == 3
    path = str(tmp_path / "m")
    save_checkpoint(path, state, {"test_acc": 0.5, "epoch": 0, "iter": 3})
    *_, fresh, _, _ = tloop.build_all(cfg, train, device="cpu")
    loaded, extra = load_checkpoint(path, fresh)
    assert extra["iter"] == 3
    np.testing.assert_equal(to_numpy(loaded), to_numpy(state))
    a, _ = step(loaded, *batch(3))
    a = to_numpy(a)
    c, _ = step(state, *batch(3))
    np.testing.assert_equal(a, to_numpy(c))
    # a v1 state is refused
    *_, v1, _, _ = tloop.build_all(TConfig(**SMALL), train, device="cpu")
    with pytest.raises(ValueError, match="checkpoint"):
        load_checkpoint(path, v1)


def _events(out):
    ev = []
    for ln in out.splitlines():
        if ln.startswith("Finished training it "):
            w = ln.split()
            assert np.isfinite(float(w[-1])), ln
            ev.append(("train", w[3]))
        elif ln.startswith(" accuracy"):
            ev.append(("test", ""))
    return ev


def test_main_torch_cafe_plus(tmp_path, capsys):
    """main_torch.main --cafe_plus true trains, evaluates and checkpoints
    (every it printed up to 100, a test event every 3 its and at the
    end, as the JAX driver prints them);
    a reload of the best checkpoint reproduces its best test accuracy."""
    sys.path.insert(0, str(REPO))
    import main_torch
    flags = dict(dataset="synthetic", synthetic_rows=1024,
                 synthetic_fields=4, synthetic_vocab=2000,
                 synthetic_dense=4, embedding_dim=8, mini_batch_size=128,
                 test_mini_batch_size=256, compress_method="cafe",
                 compress_rate=0.05, cafe_plus="true",
                 cafe_sketch_threshold=2.0, learning_rate=0.1,
                 print_freq=2, test_freq=3)
    argv = [x for k, v in flags.items() for x in (f"--{k}", str(v))]
    argv += ["--force_platform", "cpu"]
    argv += ["--tensor_board_filename", ""]
    res = main_torch.main(argv + ["--save_model", str(tmp_path / "t" / "m")])
    ev = _events(capsys.readouterr().out)
    train = [("train", f"{i}/7") for i in range(1, 8)]
    test = [("test", "")]
    assert ev == train[:3] + test + train[3:6] + test + train[6:] + test
    assert (tmp_path / "t" / "m").exists()
    again = main_torch.main(argv + ["--load_model", str(tmp_path / "t" / "m"),
                                    "--inference_only", "true"])
    capsys.readouterr()
    assert again["metrics"]["accuracy"] == res["best_acc"] > 0
