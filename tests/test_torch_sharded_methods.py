"""QR, Off and AdaEmbed on a mesh, and the other methods and towers under
a mesh, at 4 gloo ranks against the JAX package's sharded steps on its
virtual CPU mesh, from one bridged state (tests/test_sharding.py's
QR / Off / Ada / Adagrad cases); AdaEmbed's shard-local check and
rebuild against the JAX package's on one carry; the quantized lookups of
Off and AdaEmbed on the mesh; main_torch.py with these methods on a mesh.

Tolerances: integer state (routed rows, hot flags, Off's hot_dict, Ada's
dic and admitted count, the CAFE sketch, step counters) EXACT. Tables,
optimizer slots, dense params, loss and scores within 1e-5: the ranks'
dense gradients and duplicate-row updates sum in another order than
XLA's. Under Adagrad the dense params are held as
tests/test_torch_train.py holds them (an element whose gradient sits at
the f32 cancellation floor moves by up to lr either way). The port's
pallas mode on the CPU is K5's plain version, held against the JAX
package's explicit exchange. AdaEmbed's sample key is left out: the JAX
package splits a jax.random key every step, the port keeps its seed
(embeddings/ada.py); the step-1 check rebuilds whatever its sample,
since nothing is admitted yet.
"""

import re
import sys
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu.config import Config as JConfig
from cafe_tpu.embeddings.ada import AdaPart as JAda
from cafe_tpu.parallel import make_mesh as jmake_mesh
from cafe_tpu.train.loop import build_all as jbuild_all, get_dataset as jdata
from cafe_tpu_torch.bridge import from_reference, to_numpy, to_reference
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.embeddings.ada import AdaPart as TAda
from test_torch_sharded import SHARD, STEPS, _jax_run
from test_torch_train import _mostly_close

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N = 4
BASE = dict(dataset="synthetic", synthetic_rows=1024, synthetic_fields=4,
            synthetic_vocab=20000, synthetic_vocab_spread=0.04,
            synthetic_dense=4, synthetic_zipf=1.2, embedding_dim=8,
            mini_batch_size=128, learning_rate=0.1, shard_embeddings=True,
            mesh_shape=N)
# the parts this slice shards, in the port's explicit and pallas modes
METHODS = {
    "qr_add": dict(BASE, compress_method="qr", compress_rate=0.05),
    "qr_mult": dict(BASE, compress_method="qr", compress_rate=0.05,
                    qr_operation="mult"),
    "qr_concat": dict(BASE, compress_method="qr", compress_rate=0.05,
                      qr_operation="concat"),
    "off": dict(BASE, compress_method="off", compress_rate=0.05),
    # ada needs cr > 2 / dim: hotn = 4,000 of 80,000 ids
    "ada": dict(BASE, compress_method="ada", compress_rate=0.3),
}
# the other methods and towers under a mesh (replicated parts next to
# sharded ones), in the explicit mode
OTHERS = {
    "cafe_adagrad": dict(SHARD, mesh_shape=N, optimizer="adagrad"),
    "mde": dict(BASE, compress_method="mde", compress_rate=0.05),
    "ae": dict(BASE, compress_method="ae", compress_rate=0.05),
    "hash_weighted": dict(BASE, compress_method="hash", compress_rate=0.2,
                          weighted_pooling="learned"),
    "wdl": dict(SHARD, mesh_shape=N, model="wdl"),
    "dcn": dict(SHARD, mesh_shape=N, model="dcn"),
}
MODES = {name: ("explicit", "pallas") for name in METHODS}
MODES.update({name: ("explicit",) for name in OTHERS})
CONFIGS = {**METHODS, **OTHERS}
# which parts run the exchange at 4 ranks, as in the JAX package: the
# slice's parts, CAFE and a weighted hashed table (its `w` whole on every
# rank); MDE and AE stay replicated
SHARDED = {"qr_add": "QRPart", "qr_mult": "QRPart", "qr_concat": "QRPart",
           "off": "OffPart", "ada": "AdaPart", "cafe_adagrad": "CafePart",
           "hash_weighted": "HashedTablePart", "wdl": "CafePart",
           "dcn": "CafePart"}


@pytest.fixture(scope="module")
def world4(tmp_path_factory):
    jax_out, runs = {}, []
    for name, kw in CONFIGS.items():
        jax_out[name], batches = _jax_run(kw, N, "explicit", STEPS)
        jax_out[name]["batches"] = batches
        runs.append((kw, jax_out[name]["init"], batches, MODES[name]))
    port = w.run_ranks(w.train_runs, N, tmp_path_factory.mktemp("ranks"),
                       runs)[0]
    return jax_out, dict(zip(CONFIGS, port))


def _same(a, b, path=""):
    """Integer leaves exact, float leaves within 1e-5; AdaEmbed's key
    skipped (module docstring)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k != "key":
                _same(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _same(x, y, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    else:
        a, b = np.asarray(a), np.asarray(b)
        assert a.shape == b.shape and a.dtype == b.dtype, path
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=path)


def _check_run(port, ref):
    assert port["parts"] == ref["parts"]
    for i, (pm, jm) in enumerate(zip(port["metrics"], ref["metrics"])):
        assert set(pm) == set(jm)
        for k in jm:
            if k == "loss":
                np.testing.assert_allclose(pm[k], jm[k], rtol=1e-5,
                                           atol=1e-5, err_msg=f"step {i}")
            elif k.endswith("_frac"):
                np.testing.assert_allclose(pm[k], jm[k], rtol=2.4e-7,
                                           err_msg=f"{k} step {i}")
            else:
                assert pm[k] == jm[k], (k, i, pm[k], jm[k])
    if port["state"]["opt"] is None:
        _same(port["state"], ref["state"])
    else:
        lr = BASE["learning_rate"]
        _mostly_close(port["state"]["params"], ref["state"]["params"], 1e-5,
                      2 * lr * STEPS, "params")
        _same({k: v for k, v in port["state"].items() if k != "params"},
              {k: v for k, v in ref["state"].items() if k != "params"})
    assert int(port["state"]["step"]) == STEPS
    _same(port["aux"], ref["aux"], "aux")
    np.testing.assert_allclose(port["scores"], ref["scores"], rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("name,mode", [(n, m) for n in CONFIGS
                                       for m in MODES[n]])
def test_steps_match_jax(world4, name, mode):
    """STEPS sharded steps at 4 ranks against the JAX package's: metrics,
    the whole state, the first batch's aux (routing) and eval scores."""
    jax_out, port = world4
    _check_run(port[name][mode], jax_out[name])


@pytest.mark.parametrize("name", list(CONFIGS))
def test_layout_at_four_ranks(world4, name):
    """The slice's parts (QR's quotient table, Off, AdaEmbed), CAFE and
    a weighted hashed table run the exchange; MDE and AE stay
    replicated; the port's init is the JAX package's, bit for bit."""
    jax_out, port = world4
    run = port[name]["explicit"]
    on = {cls for cls, sharded in run["parts"] if sharded}
    assert on == ({SHARDED[name]} if name in SHARDED else set())
    for key, part in run["init_embed"].items():
        ref = jax_out[name]["init"]["embed"][key]
        _same(part, ref, key)
        if "key" in part:
            np.testing.assert_array_equal(part["key"], ref["key"])


def test_ada_sharded_invariants(world4):
    """tests/test_sharding.py's invariants: live slots distinct and >= 1,
    each assigned inside its cyclic owner's slot range, the pool's row 0
    zero; ids were admitted at step 1."""
    _, port = world4
    for mode in MODES["ada"]:
        run = port["ada"][mode]
        key = f"part{[c for c, _ in run['parts']].index('AdaPart')}"
        ps = run["state"]["embed"][key]
        dic = ps["dic"]
        live = dic[dic != 0]
        assert len(live) and len(np.unique(live)) == len(live)
        assert (live >= 1).all()
        w_l = ps["weight"].shape[0] // N
        owner = (np.arange(dic.shape[0]) // (dic.shape[0] // N))[dic != 0]
        assert ((live // w_l) == owner).all()
        assert np.abs(ps["weight"][0]).max() == 0.0
        assert all(m["ada_admitted"] == len(live) for m in run["metrics"])


SAVED = ("qr_mult", "off", "ada")


@pytest.fixture(scope="module")
def saved4(world4, tmp_path_factory):
    """The slice's parts stepped at 4 ranks from the bridged state, then
    saved under the mesh (the global state, rank 0 writing)."""
    jax_out, _ = world4
    root = tmp_path_factory.mktemp("saved")
    runs = [(CONFIGS[n], jax_out[n]["init"], jax_out[n]["batches"],
             str(root / n)) for n in SAVED]
    w.run_ranks(w.saved_runs, N, root, runs)
    return root


@pytest.mark.parametrize("name", SAVED)
def test_mesh_checkpoint_holds_the_global_state(world4, saved4, name):
    """The file a 4-rank run saves is the JAX package's global state
    after the same steps (QR's whole remainder table, Off's row-sharded
    hot_dict, AdaEmbed's cyclic-permuted dic and importance)."""
    jax_out, _ = world4
    got = to_numpy(torch.load(str(saved4 / name), weights_only=True))
    want = jax_out[name]["state"]
    _same(got["embed"], want["embed"], "embed")
    _same(got["params"], want["params"], "params")
    assert int(got["step"]) == STEPS


def test_one_device_serves_a_mesh_ada_checkpoint(saved4, capsys):
    """main_torch.py without a mesh loads the 4-rank AdaEmbed checkpoint
    in the n-shard layout (its meta names world size 4): it serves with
    --inference_only and refuses to resume training."""
    sys.path.insert(0, str(REPO))
    import main_torch
    from test_torch_mesh_checkpoint import _argv
    one = _argv({k: v for k, v in CONFIGS["ada"].items()
                 if k != "mesh_shape"} | {"shard_embeddings": False,
                                          "force_platform": "cpu"})
    path = str(saved4 / "ada")
    with pytest.raises(ValueError, match="world size 4"):
        main_torch.main(one + ["--load_model", path])
    capsys.readouterr()
    main_torch.main(one + ["--load_model", path, "--inference_only", "true",
                           "--quantize_emb_bits", "8"])
    assert re.search(r"^accuracy=[\d.]+ .*roc_auc=[\d.]+$",
                     capsys.readouterr().out, re.M)


# ------------------------------------------ AdaEmbed's shard-local policy

def _ada_parts(n=N, optimizer="adagrad"):
    """The JAX and the port AdaPart of one small layout at n shards."""
    counts, hotn, dim = [3000, 1700, 900], 600, 8
    jp = JAda([0, 1, 2], counts, hotn, dim, optimizer)
    assert jp.enable_mesh(jmake_mesh(n))
    tp = TAda([0, 1, 2], counts, hotn, dim, optimizer)
    tp.device = torch.device("cpu")
    assert tp.enable_sharded_layout(n)
    return jp, tp


def _ada_carry(part, me, seed, n=N):
    """A local carry (pool, adagrad acc, dic, grad_norm) of rank `me`:
    importances with ties and zeros, the padding lanes at -1, and some
    ids admitted to distinct slots of the rank's own range."""
    rng = np.random.default_rng(seed)
    np_pad = -(-part.total_n // 512) * 512
    L, w_l = np_pad // n, (-(-(part.hotn + 1) // 512) * 512) // n
    gn = np.round(rng.exponential(1.0, L), 1).astype(np.float32)
    gn[rng.random(L) < 0.5] = 0.0
    gn[np.arange(L) * n + me >= part.total_n] = -1.0
    dic = np.zeros(L, np.int32)
    slots = rng.permutation(np.arange(1 if me == 0 else 0, w_l))[:w_l // 3]
    lanes = rng.choice(np.flatnonzero(gn >= 0), len(slots), replace=False)
    dic[lanes] = slots + me * w_l
    w_l_rows = rng.normal(size=(w_l, part.dim)).astype(np.float32)
    acc = rng.random((w_l, part.dim)).astype(np.float32)
    return w_l_rows, acc, dic, gn


def _jax_carry(c):
    return (jnp.asarray(c[0]), {"acc": jnp.asarray(c[1])},
            jnp.asarray(c[2]), jnp.asarray(c[3]))


def _torch_carry(c):
    return (torch.from_numpy(c[0].copy()),
            {"acc": torch.from_numpy(c[1].copy())},
            torch.from_numpy(c[2].copy()), torch.from_numpy(c[3].copy()))


def _carry_equal(got, want):
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    np.testing.assert_array_equal(got[1]["acc"].numpy(),
                                  np.asarray(want[1]["acc"]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    np.testing.assert_array_equal(got[3].numpy(), np.asarray(want[3]))


@pytest.mark.parametrize("me", range(N))
def test_ada_rebuild_local_matches_jax(me):
    """_rebuild_local of rank `me` on one carry: dic, the pool and the
    Adagrad slots exactly the JAX package's (ties in the importances
    resolve lower id first, global slot 0 is never handed out)."""
    jp, tp = _ada_parts()
    c = _ada_carry(tp, me, seed=10 + me)
    want = jax.jit(lambda cc: jp._rebuild_local(cc, jnp.int32(me)))(
        _jax_carry(c))
    got = tp._rebuild_local(_torch_carry(c), me)
    _carry_equal(got, want)
    assert (got[2].numpy() != c[2]).any()


@pytest.mark.parametrize("me", range(N))
def test_ada_check_local_matches_jax_on_pinned_samples(me):
    """_check_local on the sample the JAX package draws from its key (the
    port takes the indices): the same churn decision and the same carry,
    for a carry that rebuilds and for one with every id admitted (no
    churn, no rebuild)."""
    jp, tp = _ada_parts()
    c = _ada_carry(tp, me, seed=20 + me)
    key = jax.random.PRNGKey(me)
    sample_l = max(jp.sample // N, 1)
    L = c[2].shape[0]
    n_live = max((tp.total_n - 1 - me) // N + 1, 1)
    idx = np.array(jax.random.randint(key, (sample_l,), 0, min(n_live, L)))
    full = c[:2] + (np.full_like(c[2], 1 + me * len(c[0])), c[3])
    rebuilt = []
    for carry in (c, full):
        want = jax.jit(lambda cc: jp._check_local(cc, key, jnp.int32(me)))(
            _jax_carry(carry))
        got, did = tp._check_local(_torch_carry(carry),
                                   torch.from_numpy(idx), me)
        _carry_equal(got, want)
        rebuilt.append(did)
    assert rebuilt == [True, False]


def test_ada_store_perm_and_lookup():
    """The cyclic storage permutation and the n-shard layout's dic lookup
    (the JAX package's _store_perm / _dic_lookup) agree exactly."""
    jp, tp = _ada_parts()
    np_pad = -(-tp.total_n // 512) * 512
    np.testing.assert_array_equal(tp._store_perm(np_pad),
                                  jp._store_perm(np_pad))
    dic = np.random.default_rng(0).integers(0, 99, np_pad).astype(np.int32)
    gid = np.random.default_rng(1).integers(0, tp.total_n, (64, 3))
    want = jp._dic_lookup({"dic": jnp.asarray(dic)},
                          jnp.asarray(gid, jnp.int32))
    got = tp._dic_lookup({"dic": torch.from_numpy(dic)},
                         torch.from_numpy(gid).int())
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# --------------------------------------------- quantized lookups on a mesh

# vocabularies large enough that the int8 codes exceed the O(batch)
# bound many times over, so a table-sized collective could not pass
QKW = dict(BASE, synthetic_vocab=2 ** 20, embedding_dim=16)
QUANT = {"off": dict(QKW, compress_method="off", compress_rate=0.5),
         "ada": dict(QKW, compress_method="ada", compress_rate=0.2)}
QB = 128                        # the eval batch, over 4 ranks


@pytest.fixture(scope="module")
def served4(tmp_path_factory):
    from cafe_tpu_torch.data import batch_iterator
    from cafe_tpu_torch.train import get_dataset
    runs, evs = [], {}
    for name, kw in QUANT.items():
        data = get_dataset(TConfig(**kw), "train")
        batches = list(batch_iterator(data, kw["mini_batch_size"],
                                      drop_last=True))
        evs[name] = batches[STEPS]
        runs.append((kw, batches[:STEPS], batches[STEPS][:2], (8, 4)))
    out = w.run_ranks(w.serve_runs, N, tmp_path_factory.mktemp("ranks"),
                      runs)[0]
    return {name: (QUANT[name], o, evs[name])
            for name, o in zip(QUANT, out)}


def _one_device(kw, state_np, layout):
    """The port on one process (no mesh; AdaEmbed in the n-shard layout)
    holding the global state of the 4-rank run."""
    from cafe_tpu_torch.train import build_all, get_dataset
    cfg = TConfig(**dict(kw, mesh_shape=None, shard_embeddings=False))
    model, embed, fresh, *_ = build_all(cfg, get_dataset(cfg, "train"),
                                        device="cpu", capture=False,
                                        layout_shards=layout)
    state = from_reference(state_np, "cpu")
    for a, b in zip(jax.tree.leaves(to_numpy(fresh)),
                    jax.tree.leaves(to_numpy(state))):
        assert a.shape == b.shape and a.dtype == b.dtype
    return model, embed, state


@pytest.mark.parametrize("name", list(QUANT))
def test_quantized_lookup_on_the_mesh_moves_o_batch(served4, name):
    """The owners answer the dict lanes (Off's hot_dict, Ada's cyclic
    dic) and dequantize their rows: every collective of the quantized
    eval step is within the O(batch) bound, far below the codes' size,
    and the scores track the float eval's."""
    kw, out, _ = served4[name]
    cls = {"off": "OffPart", "ada": "AdaPart"}[name]
    assert (cls, True) in out["parts"]
    key = f"part{[c for c, _ in out['parts']].index(cls)}"
    table, dic = ("table", "hot_dict") if name == "off" \
        else ("weight", "dic")
    rows, dim = out["state"]["embed"][key][table].shape
    bound = 8 * QB * kw["synthetic_fields"] * (dim + 4) * 4
    assert bound < rows * (dim + 8) // 8
    assert 8 * bound < 4 * len(out["state"]["embed"][key][dic])
    for bits in (8, 4):
        sizes = out["sizes"][bits]
        assert {n for n, _ in sizes} >= {"_all_gather_single",
                                         "_reduce_scatter_single"}
        assert max(n for _, n in sizes) <= bound, sizes
        assert np.abs(out[bits] - out["float"]).mean() < 0.01


@pytest.mark.parametrize("name", list(QUANT))
def test_quantized_lookup_equals_one_device(served4, name):
    """The global state of the 4-rank run served on one process (Off in
    its plain layout, AdaEmbed through enable_sharded_layout(4)): float
    and quantized scores and dequantized rows as the mesh served them;
    training in AdaEmbed's n-shard layout raises."""
    from cafe_tpu_torch.train import build_quantized_eval_step
    from cafe_tpu_torch.train.step import build_eval_step
    kw, out, ev = served4[name]
    model, embed, state = _one_device(kw, out["state"],
                                      N if name == "ada" else 0)
    args = (torch.from_numpy(ev[0]), torch.from_numpy(ev[1]))
    np.testing.assert_allclose(
        build_eval_step(model, embed)(state, *args).numpy(), out["float"],
        rtol=1e-5, atol=1e-5)
    for bits in (8, 4):
        step = build_quantized_eval_step(model, embed, state, bits)
        np.testing.assert_allclose(step(state, *args).numpy(), out[bits],
                                   rtol=1e-5, atol=1e-5)
        raws = embed.gather_quantized(state.embed, step.qtables, args[1])
        for k, v in raws.items():
            np.testing.assert_allclose(v.numpy(), out[f"raw{bits}"][k],
                                       rtol=1e-6, atol=0)
    if name == "ada":
        i, part = next((i, p) for i, p in enumerate(embed.parts)
                       if isinstance(p, TAda))
        ids = torch.zeros((4, len(part.field_idx)), dtype=torch.int32)
        raw, aux = part.gather(state.embed[f"part{i}"], ids)
        with pytest.raises(RuntimeError, match="sharded layout"):
            part.apply_grads(state.embed[f"part{i}"], ids,
                             torch.ones_like(raw), aux, 0.1)


def test_ada_mesh_state_serves_as_the_jax_layout(served4):
    """What the JAX package does with a mesh AdaEmbed state on one device:
    its AdaPart at n_shards 4 looks dic up through the cyclic storage
    (_dic_lookup); its quantized lookup on the bridged state equals the
    port's one-process lookup in the n-shard layout."""
    from cafe_tpu_torch.train import build_quantized_eval_step
    kw, out, ev = served4["ada"]
    model, embed, state = _one_device(kw, out["state"], N)
    jcfg = JConfig(**dict(kw, mesh_shape=None, shard_embeddings=False))
    _, jembed, jstate, _, _ = jbuild_all(jcfg, jdata(jcfg, "train"))
    i = next(i for i, p in enumerate(jembed.parts) if isinstance(p, JAda))
    jp = jembed.parts[i]
    jp.n_shards = N
    jst = to_reference(state.embed[f"part{i}"], jstate.embed[f"part{i}"])
    ids = ev[1][:, jp.field_idx]
    step = build_quantized_eval_step(model, embed, state, 8)
    got = embed.parts[i].gather_quantized(
        state.embed[f"part{i}"], step.qtables[f"part{i}"],
        torch.from_numpy(ids))
    want = jp.gather_quantized(jst, jp.quantize_for_serving(jst, 8),
                               jnp.asarray(ids))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6,
                               atol=0)
    assert (np.abs(got.numpy()).sum(-1) > 0).any()   # admitted ids served


# ------------------------------------------------ main_torch.py on a mesh

CLI = ["--dataset", "synthetic", "--synthetic_rows", "1792",
       "--synthetic_fields", "4", "--synthetic_vocab", "20000",
       "--synthetic_vocab_spread", "0.04", "--synthetic_dense", "4",
       "--embedding_dim", "8", "--mini_batch_size", "128",
       "--learning_rate", "0.1", "--print_freq", "4", "--test_freq", "12",
       "--test_mini_batch_size", "128", "--force_platform", "cpu",
       "--mesh_shape", "1", "--shard_embeddings", "true",
       "--tensor_board_filename", ""]


@pytest.mark.parametrize("flags", [
    ["--compress_method", "qr", "--compress_rate", "0.05",
     "--shard_exchange", "pallas"],
    ["--compress_method", "off", "--compress_rate", "0.05"],
    ["--compress_method", "ada", "--compress_rate", "0.3"],
    ["--compress_method", "hash", "--compress_rate", "0.2",
     "--shard_unique_frac", "0.5"]], ids=["qr", "off", "ada", "unique"])
def test_main_torch_trains_saves_and_serves_on_a_mesh(flags, capsys,
                                                      tmp_path):
    """main_torch.py --mesh_shape 1 --shard_embeddings true with the
    slice's methods and the compact exchange: 12 finite train lines and
    an eval, a checkpoint of the global state, and an int8 serving of it
    on the mesh within 0.01 of the float accuracy."""
    sys.path.insert(0, str(REPO))
    import main_torch
    model = str(tmp_path / "m")
    main_torch.main(CLI + flags + ["--save_model", model])
    text = capsys.readouterr().out
    losses = [float(x) for x in re.findall(
        r"^Finished training it \d+/\d+ .* loss ([\d.]+)$", text, re.M)]
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert text.count(" accuracy ") == 1
    accs = []
    for bits in ("0", "8"):
        main_torch.main(CLI + flags + ["--inference_only", "true",
                                       "--load_model", model,
                                       "--quantize_emb_bits", bits])
        accs.append(float(re.search(r"^accuracy=([\d.]+) ",
                                    capsys.readouterr().out,
                                    re.M).group(1)))
    assert abs(accs[1] - accs[0]) < 0.01
