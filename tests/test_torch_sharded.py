"""The sharded slice as a whole: the port's build_all(mesh=...) train step
on gloo ranks against the JAX package's sharded step on its virtual CPU
mesh, from one bridged state; and main_torch.py under torch.distributed
against that same port step driven directly.

The config promotes ids every step (frequency scores, a low threshold,
two migration lanes a shard, so the per-shard revert runs too) and has a
field small enough to stay a replicated full table next to the sharded
CafePart, so the replicated-part rule runs too.

Tolerances: sketch state (val/cnt/dic/free/free_top/tot), routed rows,
hot flags, promotion counts, weights and correct counts are EXACT (integer
scores, integer logic); the hot fraction within one f32 ulp. Tables,
dense params, loss and eval scores within 1e-5: the ranks' dense
gradients and duplicate-row updates sum in another order than XLA's.
With gradient-norm scores the sketch counts are f32 sums of normalised
norms: within 2e-4 (a few ulps of the batch's B*F = 512 summed scores),
placements and slots exact.
"""

import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu.config import Config as JConfig
from cafe_tpu.data import batch_iterator as jbatches
from cafe_tpu.parallel import make_mesh as jmake_mesh, shard_train_step
from cafe_tpu.train.loop import build_all as jbuild_all, get_dataset as jdata
from cafe_tpu_torch.bridge import from_reference, to_numpy
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.train.loop import check_supported

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SHARD = dict(dataset="synthetic", synthetic_rows=1024, synthetic_fields=4,
             synthetic_vocab=2000, synthetic_vocab_spread=0.04,
             synthetic_dense=4, synthetic_zipf=1.2, embedding_dim=8,
             mini_batch_size=128, compress_method="cafe",
             compress_rate=0.05, cafe_sketch_threshold=3.0,
             cafe_use_freq=True, learning_rate=0.1, cafe_mig_lanes=2,
             shard_embeddings=True)
STEPS = 3


def _jax_run(kw, n, mode, steps):
    """The JAX package's sharded step at mesh n: (bridged init state,
    per-step metrics, final state, first batch's routing and scores,
    the batches)."""
    cfg = JConfig(**dict(kw, shard_exchange=mode))
    train = jdata(cfg, "train")
    mesh = jmake_mesh(n)
    _, embed, state, step, eval_step = jbuild_all(cfg, train, mesh=mesh)
    sharded, st = shard_train_step(step, mesh, state,
                                   shard_embeddings=cfg.shard_embeddings)
    init = to_numpy(from_reference(jax.device_get(st), "cpu"))
    batches = list(jbatches(train, kw["mini_batch_size"],
                            drop_last=True))[:steps]
    metrics = []
    for dense, sparse, label, valid in batches:
        st, m = sharded(st, dense, sparse, label, valid)
        metrics.append({k: float(v) for k, v in m.items()})
    aux = jax.jit(lambda e, s: embed.gather(e, s)[1])(st.embed,
                                                       batches[0][1])
    return {"init": init, "metrics": metrics,
            "state": to_numpy(from_reference(jax.device_get(st), "cpu")),
            "routing": {k: np.asarray(v[1]) for k, v in aux.items()
                        if isinstance(v, tuple)},
            "hot": {k: np.asarray(v[-1]) for k, v in aux.items()
                    if isinstance(v, tuple)},
            "scores": np.asarray(eval_step(st, batches[0][0],
                                           batches[0][1])),
            "parts": [(type(p).__name__, p.mesh is not None)
                      for p in embed.parts]}, batches


def _both(tmp_path_factory, kw, n, jax_modes, port_modes):
    jax_out = {}
    for mode in jax_modes:
        jax_out[mode], batches = _jax_run(kw, n, mode, STEPS)
    ref = jax_out[jax_modes[0]]["init"]
    for mode in jax_modes[1:]:       # one init state serves every mode
        np.testing.assert_equal(jax_out[mode]["init"], ref)
    port = w.run_ranks(w.train_steps, n, tmp_path_factory.mktemp("ranks"),
                       kw, ref, batches, port_modes)
    return jax_out, port[0]


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    return _both(tmp_path_factory, dict(SHARD, mesh_shape=4), 4,
                 ("explicit", "a2a"), ("explicit", "a2a", "pallas"))


@pytest.fixture(scope="module")
def world1(tmp_path_factory):
    return _both(tmp_path_factory, dict(SHARD, mesh_shape=1), 1,
                 ("explicit", "a2a"), ("explicit", "a2a"))


def _close(a, b, tol, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close(a[k], b[k], tol, f"{path}/{k}")
    elif isinstance(a, list):
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, tol, f"{path}[{i}]")
    elif a is not None:
        np.testing.assert_allclose(a, b, rtol=tol, atol=tol, err_msg=path)


def _check(port, ref, exact_cnt=True):
    assert port["parts"] == ref["parts"]
    for i, (pm, jm) in enumerate(zip(port["metrics"], ref["metrics"])):
        assert set(pm) == set(jm)
        for k in jm:
            if k == "loss":
                np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5,
                                           atol=1e-5, err_msg=f"step {i}")
            elif k.endswith("_frac"):
                # a count over the batch size: XLA's partitioned mean may
                # round it an ulp apart (reciprocal vs division)
                np.testing.assert_allclose(pm[k], jm[k], rtol=2.4e-7,
                                           err_msg=f"{k} step {i}")
            else:
                assert pm[k] == jm[k], (k, i, pm[k], jm[k])
    ps, js = port["state"], ref["state"]
    _close(ps["params"], js["params"], 1e-5, "params")
    assert int(ps["step"]) == int(js["step"]) == STEPS
    for key, part in js["embed"].items():
        pp = ps["embed"][key]
        assert set(pp) == set(part)
        for k in part:
            if k == "sketch":
                assert set(pp[k]) == set(part[k])
                for f in part[k]:
                    if f in ("cnt", "tot") and not exact_cnt:
                        np.testing.assert_allclose(
                            pp[k][f], part[k][f], rtol=1e-5, atol=2e-4)
                    else:
                        np.testing.assert_array_equal(
                            pp[k][f], part[k][f], err_msg=f"{key} {f}")
            else:
                np.testing.assert_allclose(pp[k], part[k], rtol=1e-5,
                                           atol=1e-5, err_msg=f"{key} {k}")
    for key in ref["routing"]:
        np.testing.assert_array_equal(port["routing"][key],
                                      ref["routing"][key])
        np.testing.assert_array_equal(port["hot"][key], ref["hot"][key])
    np.testing.assert_allclose(port["scores"], ref["scores"], rtol=1e-5,
                               atol=1e-5)


def test_world4_layout_and_init(world4):
    jax_out, port = world4
    # a replicated full table next to the sharded CafePart
    assert jax_out["explicit"]["parts"] == [("HashedTablePart", False),
                                            ("CafePart", True)]
    assert port["explicit"]["parts"] == jax_out["explicit"]["parts"]
    # the port's own init (numpy-made tables, the whole padded hot region
    # drawn, the sharded sketch layout) is bit-equal to the JAX package's
    np.testing.assert_equal(port["explicit"]["init_embed"],
                            jax_out["explicit"]["init"]["embed"])


@pytest.mark.parametrize("mode,ref", [("explicit", "explicit"),
                                      ("a2a", "a2a"), ("pallas", "a2a")])
def test_world4_steps_match(world4, mode, ref):
    """Port mode `mode` against JAX mode `ref` at 4 ranks; the port's
    pallas mode on the CPU is K5's plain version, held against JAX's
    a2a (its pallas_interpret step is the slow test below)."""
    jax_out, port = world4
    _check(port[mode], jax_out[ref])
    promotions = sum(m["cafe_promotions"] for m in port[mode]["metrics"])
    assert promotions > 0 and port[mode]["hot"]["part1"].any()


@pytest.mark.parametrize("mode", ["explicit", "a2a"])
def test_world1_steps_match(world1, mode):
    jax_out, port = world1
    _check(port[mode], jax_out[mode])
    assert sum(m["cafe_promotions"] for m in port[mode]["metrics"]) > 0


def test_world4_grad_norm_scores(tmp_path_factory):
    """Gradient-norm scores: the per-field norm sums and the batch size
    are the GLOBAL batch's, as in the JAX package (which scores outside
    its shard_map); rank-local normalisation would move every count.
    With an insert every 2nd step (steps 0 and 2 insert, step 1 skips
    the insert and the migration on every rank)."""
    kw = dict(SHARD, mesh_shape=4, cafe_use_freq=False,
              cafe_sketch_threshold=1.5, cafe_insert_interval=2)
    jax_out, port = _both(tmp_path_factory, kw, 4, ("explicit",),
                          ("explicit",))
    _check(port["explicit"], jax_out["explicit"], exact_cnt=False)
    assert sum(m["cafe_promotions"]
               for m in port["explicit"]["metrics"]) > 0


def test_world4_data_parallel_only(tmp_path_factory):
    """A mesh without --shard_embeddings: every part (the CafePart too)
    stays replicated and applies the all-gathered global batch on every
    rank, where the JAX package leaves the parts to XLA's partitioner."""
    kw = dict(SHARD, mesh_shape=4, shard_embeddings=False)
    jax_out, port = _both(tmp_path_factory, kw, 4, ("explicit",),
                          ("explicit",))
    assert port["explicit"]["parts"] == [("HashedTablePart", False),
                                         ("CafePart", False)]
    _check(port["explicit"], jax_out["explicit"])
    assert sum(m["cafe_promotions"]
               for m in port["explicit"]["metrics"]) > 0


@pytest.mark.slow
@pytest.mark.timeout(1800)
def test_world4_pallas_matches_jax_pallas_interpret(world4):
    """The JAX package's own pallas exchange in interpret mode (slow)."""
    jax_out, _ = _jax_run(dict(SHARD, mesh_shape=4), 4, "pallas_interpret",
                          STEPS)
    _check(world4[1]["pallas"], jax_out)


def _plus_slot_invariants(sk, n, s_l):
    """tests/test_sharding.py's CAFE+ invariants on a global sharded
    state: each shard's held slots are distinct local slots, and with its
    free stack they are its S_l - 1 slots exactly (no leak, no alias)."""
    d1 = sk["dic1"].reshape(n, -1)
    d2 = sk["dic2"].reshape(n, -1)
    free = sk["free"].reshape(n, s_l)
    held = 0
    for s in range(n):
        used = np.concatenate([d1[s][d1[s] != 0], d2[s][d2[s] != 0]])
        assert len(np.unique(used)) == len(used), f"shard {s} dup"
        assert ((used >= 1) & (used < s_l)).all()
        both = np.concatenate([used, free[s, :sk["free_top"][s]]])
        assert len(np.unique(both)) == len(both) == s_l - 1, f"shard {s}"
        held += len(used)
    assert sk["threshold"].shape == (n,)
    return held


@pytest.mark.parametrize("n,pairs", [
    (1, [("explicit", "explicit")]),
    (4, [("explicit", "explicit"), ("pallas", "a2a")])])
def test_cafe_plus_steps_match(tmp_path_factory, n, pairs):
    """CAFE+ sharded (per-shard tiers, thresholds, decay clocks and free
    stacks; the per-shard migration cap reverts promotions past 2 a
    shard) at n gloo ranks against the JAX package's sharded step on its
    virtual mesh: exact as the v1 cases, and the slot invariants hold in
    every shard."""
    kw = dict(SHARD, mesh_shape=n, cafe_plus=True)
    jax_out, port = _both(tmp_path_factory, kw, n,
                          tuple(dict.fromkeys(j for _, j in pairs)),
                          tuple(p for p, _ in pairs))
    for mode, ref in pairs:
        _check(port[mode], jax_out[ref])
        assert port[mode]["parts"][-1] == ("CafePart", True)
        sk = port[mode]["state"]["embed"]["part1"]["sketch"]
        s_l = sk["free"].shape[0] // n
        assert _plus_slot_invariants(sk, n, s_l) > 0
        assert sum(m["cafe_promotions"]
                   for m in port[mode]["metrics"]) > 0


@pytest.mark.parametrize("flags", [
    dict(mesh_inner=2), dict(shard_unique_frac=0.25),
    dict(shard_exchange="auto"), dict(save_model="m"),
    dict(test_throughput=True), dict(steps_per_dispatch=2)])
def test_unported_mesh_flags_raise(flags):
    cfg = TConfig(**dict(SHARD, mesh_shape=2, **flags))
    with pytest.raises(NotImplementedError, match="Q8"):
        check_supported(cfg)


def test_mesh_larger_than_the_world_raises_and_cleans_up():
    """--mesh_shape 2 in one process: make_mesh refuses it (as the JAX
    package refuses more devices than it has), and run() leaves no
    process group behind."""
    import torch.distributed as dist
    sys.path.insert(0, str(REPO))
    import main_torch
    with pytest.raises(ValueError, match="2-device mesh"):
        main_torch.main(CLI + ["--mesh_shape", "2"])
    assert not dist.is_initialized()


CLI = ["--dataset", "synthetic", "--synthetic_rows", "1792",
       "--synthetic_fields", "4", "--synthetic_vocab", "2000",
       "--synthetic_vocab_spread", "0.04", "--synthetic_dense", "4",
       "--embedding_dim", "8", "--mini_batch_size", "128",
       "--compress_method", "cafe", "--compress_rate", "0.05",
       "--cafe_sketch_threshold", "3", "--cafe_use_freq", "true",
       "--cafe_mig_lanes", "2", "--learning_rate", "0.1",
       "--print_freq", "4", "--test_freq", "12",
       "--test_mini_batch_size", "128", "--force_platform", "cpu",
       "--shard_embeddings", "true", "--tensor_board_filename", ""]


def _lines(text):
    losses = [float(m) for m in re.findall(
        r"^Finished training it \d+/\d+ of epoch 0, [\d.]+ ms/it, "
        r"loss ([\d.]+)$", text, re.M)]
    evals = [tuple(map(float, m)) for m in re.findall(
        r"^ accuracy ([\d.]+) %, auc ([\d.]+) %", text, re.M)]
    return losses, evals


@pytest.mark.parametrize("n,mode", [(2, "pallas"), (1, "explicit")])
def test_main_torch_prints_the_steps(n, mode, capsys, tmp_path):
    """main_torch.py at world size n (n > 1 under torch.distributed.run,
    n = 1 in this process) prints its lines once (rank 0 only), and they
    are the losses and eval of the port's sharded step driven directly
    on n ranks. (The JAX package's run() draws its towers from
    jax.random and takes no bridged state, so its losses cannot be
    matched through the CLI; the step tests above hold that same step
    against the JAX package's.)"""
    argv = CLI + ["--mesh_shape", str(n), "--shard_exchange", mode]
    if n > 1:
        out = subprocess.run(
            [sys.executable, "-m", "torch.distributed.run", "--standalone",
             "--nproc_per_node", str(n), "main_torch.py", *argv],
            cwd=REPO, capture_output=True, text=True, timeout=600)
        assert out.returncode == 0, out.stderr[-3000:]
        text = out.stdout
    else:
        sys.path.insert(0, str(REPO))
        import main_torch
        main_torch.main(argv)
        text = capsys.readouterr().out
    losses, evals = _lines(text)
    want_losses, (acc, auc) = w.run_ranks(w.cli_reference, n, tmp_path,
                                          argv)[0]
    assert len(want_losses) == 12 and len(losses) == 12 and len(evals) == 1
    assert text.count("setup done") == 1
    # printed with 6 decimals (loss) and 3 (percentages)
    np.testing.assert_allclose(losses, want_losses, rtol=0, atol=6e-7)
    assert abs(evals[0][0] - acc * 100) <= 6e-4
    assert abs(evals[0][1] - auc * 100) <= 6e-4
