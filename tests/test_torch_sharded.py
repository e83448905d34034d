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


def _jax_run(kw, n, mode, steps, inner=0):
    """The JAX package's sharded step at mesh n (`inner` > 0: its
    two-level mesh): (bridged init state, per-step metrics, final state,
    first batch's routing, aux tensors and scores, the batches)."""
    cfg = JConfig(**dict(kw, shard_exchange=mode))
    train = jdata(cfg, "train")
    mesh = jmake_mesh(n, inner)
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
            "aux": {k: [np.asarray(x) for x in (
                v if isinstance(v, tuple) else (v,))]
                for k, v in aux.items()},
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
    dict(mesh_inner=2), dict(shard_exchange="auto")])
def test_mesh_flags_are_accepted(flags):
    """The two-level mesh and the auto exchange run (tests/test_torch_mesh2.py,
    tests/test_torch_auto.py drive them)."""
    check_supported(TConfig(**dict(SHARD, mesh_shape=2, **flags)))


@pytest.mark.parametrize("flags", [
    dict(save_model="m", load_model="m"), dict(test_throughput=True),
    dict(steps_per_dispatch=2)])
def test_mesh_checkpoint_flags_are_accepted(flags):
    """Checkpoints, the latency protocol and K-step dispatches run under
    a mesh (tests/test_torch_mesh_checkpoint.py drives them)."""
    check_supported(TConfig(**dict(SHARD, mesh_shape=2, **flags)))


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


# ------------------------------------------------------ quantized serving

# a CafePart large enough that its int8 codes exceed 8x the O(batch)
# bound, so a table-sized collective could not pass unseen
QKW = dict(SHARD, synthetic_vocab=2 ** 20, embedding_dim=16,
           compress_rate=0.1, mesh_shape=4)
QB = 128                        # the eval batch, over 4 ranks


@pytest.fixture(scope="module", params=[False, True], ids=["v1", "plus"])
def served4(request, tmp_path_factory):
    """CAFE v1 or CAFE+ trained STEPS steps on 4 gloo ranks, then served
    quantized (8 and 4 bits) on the mesh."""
    from cafe_tpu_torch.data import batch_iterator
    from cafe_tpu_torch.train import get_dataset
    kw = dict(QKW, cafe_plus=request.param)
    data = get_dataset(TConfig(**kw), "train")
    batches = list(batch_iterator(data, kw["mini_batch_size"],
                                  drop_last=True))
    ev = batches[STEPS]
    out = w.run_ranks(w.quantized_serving, 4,
                      tmp_path_factory.mktemp("ranks"), kw,
                      batches[:STEPS], ev[:2], (8, 4))[0]
    return kw, out, ev


def _meshless(kw, state_np, n):
    """The port on one process (no mesh) with the n-shard layout, holding
    the global state of a run on n ranks."""
    from cafe_tpu_torch.embeddings.cafe import CafePart
    from cafe_tpu_torch.train import build_all, get_dataset
    from cafe_tpu_torch.train.step import init_state
    cfg = TConfig(**dict(kw, mesh_shape=None, shard_embeddings=False))
    model, embed, *_ = build_all(cfg, get_dataset(cfg, "train"),
                                 device="cpu", capture=False)
    cafe = [p for p in embed.parts if isinstance(p, CafePart)]
    assert cafe and all(p.mesh is None and p.enable_sharded_layout(n)
                        for p in cafe)
    fresh = init_state(model, embed, cfg.numpy_rand_seed, cfg.optimizer)
    state = from_reference(state_np, "cpu")
    for a, b in zip(jax.tree.leaves(to_numpy(fresh)),
                    jax.tree.leaves(to_numpy(state))):
        assert a.shape == b.shape and a.dtype == b.dtype
    return model, embed, state


def _assert_same_rows(raws, want):
    """The dequantized rows of one process against the mesh's: the scores
    hardly move with rows of the init's scale, the rows themselves do."""
    assert raws.keys() == want.keys()
    for k, v in raws.items():
        np.testing.assert_allclose(v.numpy(), want[k], rtol=1e-6, atol=0)


def test_quantized_serving_on_the_mesh_moves_o_batch(served4):
    """The owners dequantize their rows and the reduce-scatter returns f32
    rows: every collective of the quantized eval step carries at most
    the JAX test's O(batch) bound, far below the codes' size; the scores
    track the float eval's."""
    kw, out, _ = served4
    assert out["parts"][-1] == ("CafePart", True)
    dim = kw["embedding_dim"]
    key = f"part{len(out['parts']) - 1}"
    rows = out["state"]["embed"][key]["table"].shape[0]
    sk = out["state"]["embed"][key]["sketch"]
    assert any((v != 0).any() for f, v in sk.items()
               if f.startswith("dic"))          # some ids serve hot rows
    bound = 8 * QB * kw["synthetic_fields"] * (dim + 4) * 4
    assert bound < rows * (dim + 8) // 8
    for bits in (8, 4):
        assert out["graphed"][bits] is False       # a mesh: eager
        sizes = out["sizes"][bits]
        assert {name for name, _ in sizes} >= {"_all_gather_single",
                                               "_reduce_scatter_single"}
        assert max(n for _, n in sizes) <= bound, sizes
        assert np.abs(out[bits] - out["float"]).mean() < 0.01


def test_meshless_layout_serves_the_mesh_state(served4):
    """enable_sharded_layout(4): the global state of the 4-rank run
    serves on one process, quantized and float, as the mesh served it."""
    from cafe_tpu_torch.train import build_quantized_eval_step
    from cafe_tpu_torch.train.step import build_eval_step
    kw, out, ev = served4
    model, embed, state = _meshless(kw, out["state"], 4)
    args = (torch.from_numpy(ev[0]), torch.from_numpy(ev[1]))
    np.testing.assert_allclose(
        build_eval_step(model, embed)(state, *args).numpy(), out["float"],
        rtol=1e-5, atol=1e-5)
    for bits in (8, 4):
        step = build_quantized_eval_step(model, embed, state, bits)
        np.testing.assert_allclose(step(state, *args).numpy(), out[bits],
                                   rtol=1e-5, atol=1e-5)
        _assert_same_rows(embed.gather_quantized(state.embed, step.qtables,
                                                 args[1]),
                          out[f"raw{bits}"])


def test_meshless_layout_matches_jax(served4):
    """The same global state, bridged into the JAX package's mesh-less
    sharded layout: its quantized eval step scores as the port's."""
    from cafe_tpu.embeddings.cafe import CafePart as JCafe
    from cafe_tpu.train.step import build_quantized_eval_step as jq_eval
    from cafe_tpu.train.step import init_state as jinit
    from cafe_tpu_torch.bridge import to_reference
    from cafe_tpu_torch.train import build_quantized_eval_step
    kw, out, ev = served4
    model, embed, state = _meshless(kw, out["state"], 4)
    jcfg = JConfig(**dict(kw, mesh_shape=None, shard_embeddings=False))
    jmodel, jembed, *_ = jbuild_all(jcfg, jdata(jcfg, "train"))
    assert all(p.enable_sharded_layout(4) for p in jembed.parts
               if isinstance(p, JCafe))
    jstate = to_reference(state, jinit(jmodel, jembed, jcfg.numpy_rand_seed,
                                       jcfg.optimizer))
    for bits in (8, 4):
        want = np.asarray(jq_eval(jmodel, jembed, jstate, bits)(
            jstate, *(jax.numpy.asarray(x) for x in ev[:2])))
        got = build_quantized_eval_step(model, embed, state, bits)(
            state, torch.from_numpy(ev[0]), torch.from_numpy(ev[1]))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-6)


def test_sharded_hash_serves_as_one_process(tmp_path):
    """--compress_method hash --shard_embeddings: the sharded
    HashedTablePart dequantizes through the same owner exchange (O(batch)
    collectives), and its mesh scores equal the one-process serving of
    the unsharded state, quantized and float."""
    from cafe_tpu_torch.data import batch_iterator
    from cafe_tpu_torch.train import (build_all, build_quantized_eval_step,
                                      get_dataset)
    from cafe_tpu_torch.train.step import build_eval_step
    kw = dict(QKW, compress_method="hash")
    cfg = TConfig(**kw)
    batches = list(batch_iterator(get_dataset(cfg, "train"),
                                  kw["mini_batch_size"], drop_last=True))
    ev = batches[STEPS]
    out = w.run_ranks(w.quantized_serving, 4, tmp_path, kw,
                      batches[:STEPS], ev[:2], (8, 4))[0]
    assert out["parts"] == [("HashedTablePart", True)]
    dim = kw["embedding_dim"]
    rows = out["state"]["embed"]["part0"]["table"].shape[0]
    bound = 8 * QB * kw["synthetic_fields"] * (dim + 4) * 4
    assert bound < rows * (dim + 8) // 8
    for bits in (8, 4):
        assert max(n for _, n in out["sizes"][bits]) <= bound

    one = TConfig(**dict(kw, mesh_shape=None, shard_embeddings=False))
    model, embed, fresh, *_ = build_all(one, get_dataset(one, "train"),
                                        device="cpu", capture=False)
    state = from_reference(out["state"], "cpu")
    for a, b in zip(jax.tree.leaves(to_numpy(fresh)),
                    jax.tree.leaves(to_numpy(state))):
        assert a.shape == b.shape and a.dtype == b.dtype
    args = (torch.from_numpy(ev[0]), torch.from_numpy(ev[1]))
    np.testing.assert_allclose(
        build_eval_step(model, embed)(state, *args).numpy(), out["float"],
        rtol=1e-5, atol=1e-5)
    for bits in (8, 4):
        step = build_quantized_eval_step(model, embed, state, bits)
        np.testing.assert_allclose(step(state, *args).numpy(), out[bits],
                                   rtol=1e-5, atol=1e-5)
        _assert_same_rows(embed.gather_quantized(state.embed, step.qtables,
                                                 args[1]),
                          out[f"raw{bits}"])


def test_sharded_layout_training_raises(served4):
    """enable_sharded_layout is serving-only: the flat insert on the
    sharded sketch would corrupt it, so apply_grads raises."""
    kw, out, ev = served4
    _, embed, state = _meshless(kw, out["state"], 4)
    part, key = embed.parts[-1], f"part{len(embed.parts) - 1}"
    ids = torch.zeros((4, len(part.field_idx)), dtype=torch.int32)
    raw, aux = part.gather(state.embed[key], ids)
    with pytest.raises(RuntimeError, match="serving/inspection"):
        part.apply_grads(state.embed[key], ids, torch.ones_like(raw), aux,
                         0.1)


@pytest.mark.parametrize("plus", [False, True], ids=["v1", "plus"])
def test_main_torch_serves_quantized_on_a_mesh(plus, capsys):
    """--inference_only --quantize_emb_bits {8,4} through main_torch on a
    mesh (world size 1, this process): accuracy within 0.01 of the float
    eval of the same state."""
    sys.path.insert(0, str(REPO))
    import main_torch
    argv = CLI + ["--mesh_shape", "1", "--inference_only", "true",
                  "--cafe_plus", str(plus).lower()]
    accs = []
    for bits in ("0", "8", "4"):
        main_torch.main(argv + ["--quantize_emb_bits", bits])
        text = capsys.readouterr().out
        accs.append(float(re.search(r"^accuracy=([\d.]+) ", text,
                                    re.M).group(1)))
    assert abs(accs[1] - accs[0]) < 0.01 and abs(accs[2] - accs[0]) < 0.01
