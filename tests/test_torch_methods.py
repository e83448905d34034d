"""The baseline methods (QR, MDE, Off, weighted pooling, AdaEmbed, AE)
against the JAX package, on the CPU at small sizes.

* build: the same parts, field lists, state shapes and bit-equal
  numpy-made state, and the same gathered features;
* two train steps through train/step.py from one bridged state equal
  the JAX package's jitted steps: integer state (Off's hot_dict, Ada's
  dic, the steps) exactly, float state within rtol 1e-5 / atol 1e-6 in
  f32 towers; under bf16 towers the bound is 2e-3 (a bf16 operand may
  round one ulp, 2^-8, apart when the f32 sums before it run in another
  order); Adagrad and Adam tables and slots within 1e-3 of the lr;
* AdaEmbed: the rebuild from tied importances gives JAX's dic over a
  chain of two rebuilds, the check takes JAX's branch on pinned samples,
  the decay fires at the same step, the p95 equals jnp.percentile, the
  sample is reproducible from (key, step), the budget error;
* AE: pretrain_step equals JAX's, reconstruction improves, the main step
  leaves the embeddings frozen;
* the JAX legacy tests' QR-operation and weighted-pooling cases against
  torch autograd, and Off's zero-cold fallback;
* the graphable methods' steps read nothing back to the host; Ada's does
  and is kept eager;
* main_torch.main runs each method.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.embeddings import build_embedding_layer as jbuild
from cafe_tpu.train.loop import get_dataset as jdata
from cafe_tpu_torch.bridge import to_numpy, to_torch
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.embeddings import build_embedding_layer as tbuild
from cafe_tpu_torch.embeddings.ada import (AdaPart, CHECK_EVERY,
                                           DECAY_EVERY, percentile95)
from cafe_tpu_torch.embeddings.ae import AEGroupPart
from cafe_tpu_torch.embeddings.base import (HashedTablePart, OffPart,
                                            QRPart)
from cafe_tpu_torch.train import build_all as tbuild_all, get_dataset
from cafe_tpu_torch.train.step import capture_blockers, clone_state
from test_torch_capture import CaptureBreak, NoCaptureBreaks
from test_torch_train import SMALL, _run

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
# 4 fields of 5,000 / 1,077 / 232 / 50 ids: some fields stay full
KW = dict(SMALL, synthetic_vocab=5000, synthetic_vocab_spread=0.01,
          compress_rate=0.05)
METHODS = {
    "qr_add": {"compress_method": "qr"},
    "qr_mult": {"compress_method": "qr", "qr_operation": "mult"},
    "qr_concat": {"compress_method": "qr", "qr_operation": "concat"},
    "mde": {"compress_method": "mde"},
    "mde_round_dims": {"compress_method": "mde", "md_round_dims": True},
    "off": {"compress_method": "off"},
    "hash_fixed": {"compress_method": "hash", "weighted_pooling": "fixed"},
    "hash_learned": {"compress_method": "hash",
                     "weighted_pooling": "learned"},
    "full_learned": {"compress_method": "full",
                     "weighted_pooling": "learned"},
    "ada": {"compress_method": "ada", "compress_rate": 0.5},
    "ae": {"compress_method": "ae"},
}
RTOL, ATOL = 1e-5, 1e-6
BF16_TOL = 2e-3


def _np_close(a, b, tol=(RTOL, ATOL), path=""):
    """Integer leaves equal, float leaves within tol; `key` skipped (the
    JAX key splits every step, the port's seed stays)."""
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            if k != "key":
                _np_close(a[k], b[k], tol, f"{path}/{k}")
    elif isinstance(a, list):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _np_close(x, y, tol, f"{path}[{i}]")
    elif a is None:
        assert b is None, path
    elif np.asarray(a).dtype.kind in "biu":
        np.testing.assert_array_equal(a, b, err_msg=path)
    else:
        np.testing.assert_allclose(a, b, rtol=tol[0], atol=tol[1],
                                   err_msg=path)


def _layers(name, **extra):
    kw = dict(KW, **METHODS[name], **extra)
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jtrain, ttrain = jdata(jcfg, "train"), get_dataset(tcfg, "train")
    counts = [int(c) for c in ttrain.counts]
    jl = jbuild(jcfg, counts, kw["embedding_dim"], jtrain)
    tl = tbuild(tcfg, counts, kw["embedding_dim"], ttrain, device="cpu")
    return jl, tl, ttrain


@pytest.mark.parametrize("name", sorted(METHODS))
def test_build_and_gather_match(name):
    jl, tl, data = _layers(name)
    method = METHODS[name]["compress_method"]
    kinds = [type(p).__name__ for p in tl.parts]
    assert kinds == [type(p).__name__ for p in jl.parts]
    assert [p.field_idx for p in tl.parts] == [p.field_idx for p in jl.parts]
    if method not in ("full", "hash"):
        assert len(set(kinds)) > 1       # a full part beside the method's
    jstate, jdense = jl.init(5)
    tstate, tdense = tl.init(5)
    np.testing.assert_equal(to_numpy(tstate), to_numpy(to_torch(jstate,
                                                                "cpu")))
    np.testing.assert_equal(to_numpy(tdense), to_numpy(to_torch(jdense,
                                                                "cpu")))
    ids = np.ascontiguousarray(data.sparse[:64])
    jraw, _ = jl.gather(jstate, jnp.asarray(ids))
    traw, _ = tl.gather(tstate, torch.from_numpy(ids))
    np.testing.assert_allclose(
        tl.transform(tdense, traw).numpy(),
        np.asarray(jl.transform(jdense, jraw)), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(METHODS))
def test_two_steps_match(name):
    _, jout, tout, (_, tembed), _, _ = _run(dict(KW, **METHODS[name]),
                                            steps=2)
    for i, ((js, jm), (ts, tm)) in enumerate(zip(jout, tout)):
        assert set(tm) == set(jm)
        for k in jm:
            if k in ("correct", "weight", "ada_admitted"):
                assert tm[k] == jm[k], (k, i)
            else:
                np.testing.assert_allclose(tm[k], jm[k], rtol=RTOL,
                                           atol=ATOL, err_msg=k)
        for f in ("params", "embed", "embed_dense", "step"):
            _np_close(ts[f], js[f], path=f"step {i} {f}")
    if name == "ada":     # the step-1 check rebuilt: ids were admitted
        assert 0 < jout[-1][1]["ada_admitted"] == tout[-1][1]["ada_admitted"]
    if name == "off":     # hot rows and a zero-cold fallback field served
        part = tembed.parts[1]
        assert isinstance(part, OffPart)
        assert sum(part.num_hots) > 0 and any(part.hot_fallback)


@pytest.mark.parametrize("optimizer", ["adagrad", "adam"])
@pytest.mark.parametrize("name", ["qr_mult", "mde", "off", "hash_learned",
                                  "ada", "ae"])
def test_sparse_optimizer_slots_match(name, optimizer):
    """The parts' tables and optimizer slots (AdaEmbed's zeroed with its
    freed slots) after two steps, within 1e-3 of the lr (0.1): Adagrad's
    and Adam's steps are about lr * g / |g| per element, so the f32 noise
    of a gradient near 0 moves an element by a share of lr, not of its
    value. The dense params are left to tests/test_torch_train.py for the
    same reason."""
    _, jout, tout, *_ = _run(dict(KW, **METHODS[name], optimizer=optimizer),
                             steps=2)
    tol = 1e-3 * KW["learning_rate"]
    for i, ((js, _), (ts, _)) in enumerate(zip(jout, tout)):
        for f in ("embed", "step"):
            _np_close(ts[f], js[f], (RTOL, tol), f"step {i} {f}")


@pytest.mark.parametrize("name", ["qr_add", "mde", "off", "ada"])
def test_two_steps_match_under_bf16_towers(name):
    _, jout, tout, *_ = _run(dict(KW, **METHODS[name], bf16=True), steps=2)
    for (js, jm), (ts, tm) in zip(jout, tout):
        np.testing.assert_allclose(tm["loss"], jm["loss"], rtol=BF16_TOL)
        for f in ("params", "embed", "embed_dense"):
            _np_close(ts[f], js[f], (BF16_TOL, BF16_TOL), f)


def test_weighted_pooling_gate_is_the_jax_packages():
    kw = dict(KW, compress_method="qr", weighted_pooling="learned")
    msg = "supports methods full/hash, not qr"
    with pytest.raises(ValueError, match=msg):
        jbuild(JConfig(**kw), [3000, 40], 8)
    with pytest.raises(ValueError, match=msg):
        tbuild(TConfig(**kw), [3000, 40], 8, device="cpu")


# ------------------------------------------------------------ AdaEmbed

def _ada_pair(counts, hotn, dim=4):
    """The JAX part and the port's, one state (the port's from the JAX
    state through the bridge)."""
    from cafe_tpu.embeddings.ada import AdaPart as JAda
    jp = JAda([0] if len(counts) == 1 else list(range(len(counts))),
              counts, hotn, dim)
    tp = AdaPart(list(range(len(counts))), counts, hotn, dim)
    jstate = jp.init(np.random.default_rng(0))
    tstate = tp.init(np.random.default_rng(0))
    np.testing.assert_equal(to_numpy(tstate),
                            to_numpy(to_torch(jstate, "cpu")))
    return jp, tp, jstate, tstate


def _tied_grad_norm(rng, counts, np_pad):
    """Importances with many tied zeros and tied small integers (p95 of
    most fields 0 or an integer, so the normalised values tie too)."""
    gn = np.full(np_pad, -1.0, np.float32)
    total = sum(counts)
    vals = rng.choice([0.0, 0.0, 0.0, 0.0, 1.0, 2.0, 3.0, 0.5], total)
    gn[:total] = vals.astype(np.float32)
    return gn


def test_ada_rebuild_chain_matches_jax_on_ties():
    counts = [400, 700, 300]
    jp, tp, jstate, tstate = _ada_pair(counts, hotn=120, dim=4)
    rng = np.random.default_rng(3)
    rebuild = jax.jit(jp._rebuild)
    np_pad = tstate["dic"].shape[0]
    for _ in range(2):     # the second rebuild keeps, evicts and admits
        gn = _tied_grad_norm(rng, counts, np_pad)
        # non-zero rows, so the zeroing of freed slots shows
        w = rng.normal(size=tuple(tstate["weight"].shape)).astype(np.float32)
        w[0] = 0.0
        jstate = {**jstate, "grad_norm": jnp.asarray(gn),
                  "weight": jnp.asarray(w)}
        tstate = {**tstate, "grad_norm": torch.from_numpy(gn.copy()),
                  "weight": torch.from_numpy(w.copy())}
        jstate = rebuild(jstate)
        tstate = tp._rebuild(tstate)
        np.testing.assert_array_equal(tstate["dic"].numpy(),
                                      np.asarray(jstate["dic"]))
        np.testing.assert_array_equal(tstate["weight"].numpy(),
                                      np.asarray(jstate["weight"]))
        live = tstate["dic"].numpy()
        live = live[live != 0]
        assert len(live) == tp.hotn == len(np.unique(live))


def test_ada_rebuild_keeps_slots_when_admits_exceed_evicts():
    """The JAX regression case (admits > evicts on a non-initial
    rebuild) gives JAX's dic: kept ids keep their slots, no slot twice."""
    jp, tp, jstate, tstate = _ada_pair([1000], hotn=50)
    dic = np.zeros(tstate["dic"].shape[0], np.int32)
    dic[:30] = np.arange(21, 51, dtype=np.int32)
    gn = tstate["grad_norm"].numpy().copy()
    gn[:30] = 100.0
    gn[100:120] = 50.0
    jout = jax.jit(jp._rebuild)({**jstate, "dic": jnp.asarray(dic),
                                 "grad_norm": jnp.asarray(gn)})
    tout = tp._rebuild({**tstate, "dic": torch.from_numpy(dic.copy()),
                        "grad_norm": torch.from_numpy(gn.copy())})
    np.testing.assert_array_equal(tout["dic"].numpy(),
                                  np.asarray(jout["dic"]))
    assert (tout["dic"][:30].numpy() == np.arange(21, 51)).all()


@pytest.mark.parametrize("admitted", [False, True])
def test_ada_check_takes_jax_branch_on_pinned_samples(admitted):
    counts = [3000, 2000]
    jp, tp, jstate, tstate = _ada_pair(counts, hotn=400)
    rng = np.random.default_rng(7)
    gn = tstate["grad_norm"].numpy().copy()
    gn[:5000] = rng.random(5000).astype(np.float32)
    dic = np.zeros_like(tstate["dic"].numpy())
    if admitted:       # the current top ids already hold slots: no churn
        top = np.argsort(-gn[:5000], kind="stable")[:400]
        dic[top] = np.arange(1, 401, dtype=np.int32)
    jstate = {**jstate, "grad_norm": jnp.asarray(gn),
              "dic": jnp.asarray(dic)}
    tstate = {**tstate, "grad_norm": torch.from_numpy(gn.copy()),
              "dic": torch.from_numpy(dic.copy())}
    key = jax.random.PRNGKey(11)
    idx = np.array(jax.random.randint(key, (jp.sample,), 0,
                                     jp.total_n))
    jout = jax.jit(jp._check)(jstate, key)
    tout, rebuilt = tp._check(tstate, torch.from_numpy(idx))
    assert rebuilt is (not admitted)
    jdic = np.asarray(jout["dic"])
    assert (not np.array_equal(jdic, dic)) is rebuilt
    np.testing.assert_array_equal(tout["dic"].numpy(), jdic)


@pytest.mark.parametrize("start", [DECAY_EVERY - 2, DECAY_EVERY - 1,
                                   CHECK_EVERY - 1])
def test_ada_decay_and_check_fire_at_the_jax_steps(start):
    """From step `start`, one apply_grads: the decay (every 16,384 steps)
    and the check (every 4,096; with nothing admitted it always rebuilds,
    whatever the sample) fire at the same step in both packages."""
    jp, tp, jstate, tstate = _ada_pair([3000, 2000], hotn=400)
    rng = np.random.default_rng(1)
    gn = tstate["grad_norm"].numpy().copy()
    gn[:5000] = rng.random(5000).astype(np.float32)
    jstate = {**jstate, "grad_norm": jnp.asarray(gn),
              "step": jnp.asarray(start, jnp.int32)}
    # the port updates grad_norm in place: its own copy, never the buffer
    # a JAX array may share with `gn`
    tstate = {**tstate, "grad_norm": torch.from_numpy(gn.copy()),
              "step": torch.tensor(start, dtype=torch.int32)}
    ids = rng.integers(0, 2000, (32, 2)).astype(np.int32)
    g = rng.normal(size=(32, 2, 4)).astype(np.float32)
    _, jaux = jp.gather(jstate, jnp.asarray(ids))
    jout, jm = jax.jit(lambda s, a, g: jp.apply_grads(
        s, jnp.asarray(ids), g, a, 0.1))(jstate, jaux, jnp.asarray(g))
    _, taux = tp.gather(tstate, torch.from_numpy(ids))
    tout, tm = tp.apply_grads(tstate, torch.from_numpy(ids),
                              torch.from_numpy(g), taux, 0.1)
    assert int(tout["step"]) == int(jout["step"]) == start + 1
    np.testing.assert_allclose(tout["grad_norm"].numpy(),
                               np.asarray(jout["grad_norm"]),
                               rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(tout["dic"].numpy(),
                                  np.asarray(jout["dic"]))
    assert int(tm["ada_admitted"]) == int(jm["ada_admitted"])
    assert (int(tm["ada_admitted"]) > 0) is ((start + 1) % CHECK_EVERY == 0)


@pytest.mark.parametrize("n", [1, 2, 20, 1001, 4097, 30011])
def test_p95_equals_jnp_percentile(n):
    rng = np.random.default_rng(n)
    for vals in (rng.random(n), rng.choice([0.0, 1.0, 2.5], n),
                 rng.exponential(size=n)):
        x = vals.astype(np.float32)
        want = np.asarray(jnp.percentile(jnp.asarray(x), 95.0))
        got = percentile95(torch.from_numpy(x), AdaPart([0], [n], 1, 4)
                           ._p95[0])
        np.testing.assert_array_equal(got.numpy(), want)


def test_ada_sample_reproducible_from_key_and_step():
    part = AdaPart([0, 1], [3000, 2000], 400, 4)
    part.device = torch.device("cpu")
    state = part.init(np.random.default_rng(0))
    a = part.sample_ids(state, CHECK_EVERY)
    assert a.shape == (part.sample,) and int(a.min()) >= 0 \
        and int(a.max()) < part.total_n
    assert torch.equal(a, part.sample_ids(dict(state), CHECK_EVERY))
    assert not torch.equal(a, part.sample_ids(state, 2 * CHECK_EVERY))
    other = {**state, "key": state["key"] + 1}
    assert not torch.equal(a, part.sample_ids(other, CHECK_EVERY))


def test_ada_state_crosses_the_bridge_and_a_checkpoint(tmp_path):
    """The JAX key maps to the int64 seed and back; a checkpoint keeps the
    seed, so a reloaded state draws the same check sample."""
    from cafe_tpu.train.loop import build_all as jbuild_all
    from cafe_tpu_torch.bridge import from_reference, to_reference
    from cafe_tpu_torch.train.checkpoint import (load_checkpoint,
                                                 save_checkpoint)
    kw = dict(KW, **METHODS["ada"])
    *_, jstate, _, _ = jbuild_all(JConfig(**kw), jdata(JConfig(**kw),
                                                       "train"))
    tstate = from_reference(jstate, "cpu")
    jkey = np.asarray(jstate.embed["part1"]["key"])
    assert int(tstate.embed["part1"]["key"]) == (int(jkey[0]) << 32) \
        + int(jkey[1])
    back = to_reference(tstate, jstate)
    np.testing.assert_array_equal(back.embed["part1"]["key"], jkey)
    assert back.embed["part1"]["key"].dtype == np.uint32
    _, embed, fresh, _, _ = tbuild_all(TConfig(**kw), device="cpu")
    # the port's own init draws the same seed (the dense params differ:
    # jax.random)
    np.testing.assert_equal(to_numpy(fresh.embed), to_numpy(tstate.embed))
    save_checkpoint(str(tmp_path / "m"), tstate, {"iter": 1})
    loaded, extra = load_checkpoint(str(tmp_path / "m"), fresh)
    assert extra == {"iter": 1}
    np.testing.assert_equal(to_numpy(loaded), to_numpy(tstate))
    part = embed.parts[1]
    assert torch.equal(part.sample_ids(loaded.embed["part1"], CHECK_EVERY),
                       part.sample_ids(tstate.embed["part1"], CHECK_EVERY))


def test_ada_rejects_budget_consumed_by_overhead():
    with pytest.raises(ValueError, match="compress_rate > 2/dim"):
        AdaPart([0], [100000], hotn=-3125, dim=16)


# ------------------------------------------------------------ AE

def _ae_pair(counts=(50, 30), low=4, base=8):
    from cafe_tpu.embeddings.ae import AEGroupPart as JAE
    jp = JAE(list(range(len(counts))), list(counts), low, base)
    tp = AEGroupPart(list(range(len(counts))), list(counts), low, base)
    tp.device = torch.device("cpu")
    return jp, tp, jp.init(np.random.default_rng(0)), \
        tp.init(np.random.default_rng(0))


@pytest.mark.parametrize("low", [4, 8])
def test_ae_pretrain_steps_match_jax(low):
    """At low < base and at low == base (no projection in the loss)."""
    jp, tp, jstate, tstate = _ae_pair(low=low)
    np.testing.assert_equal(to_numpy(tstate), to_numpy(to_torch(jstate,
                                                                "cpu")))
    rng = np.random.default_rng(1)
    step = jax.jit(jp.pretrain_step)
    for _ in range(3):
        ids = np.stack([rng.integers(0, 50, 32), rng.integers(0, 30, 32)],
                       1).astype(np.int32)
        jstate = step(jstate, jnp.asarray(ids))
        tstate = tp.pretrain_step(tstate, torch.from_numpy(ids))
    _np_close(to_numpy(tstate), to_numpy(to_torch(jstate, "cpu")))


def test_ae_pretrain_improves_reconstruction():
    _, tp, _, state = _ae_pair(counts=(50,))
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 50, (32, 1)).astype(np.int32))

    def recon(st):
        emb, _ = tp._embed(st, ids)
        h = torch.einsum("bfe,fed->bfd", emb, st["fc1_w"]) + st["fc1_b"]
        v = torch.einsum("bfd,fdn->bfn", h, st["fc2_w"]) + st["fc2_b"]
        onehot = torch.nn.functional.one_hot(ids.long(), 50).float()
        return float(((v - onehot) ** 2).sum() / 32)

    before = recon(state)
    for _ in range(300):
        state = tp.pretrain_step(state, ids)
    assert recon(state) < before - 0.2


def test_ae_embeddings_frozen_in_the_main_step():
    kw = dict(KW, **METHODS["ae"])
    _, embed, state, step, _ = tbuild_all(TConfig(**kw), device="cpu")
    before = to_numpy(state.embed)
    data = get_dataset(TConfig(**kw), "train")
    raws, _ = embed.gather(state.embed, torch.from_numpy(
        np.ascontiguousarray(data.sparse[:8])))
    assert not any(r.requires_grad for r in raws.values())
    batch = [torch.from_numpy(np.ascontiguousarray(a[:128]))
             for a in (data.dense, data.sparse, data.label)]
    state, m = step(state, *batch, 128)
    assert np.isfinite(float(m["loss"]))
    frozen = [f"part{i}" for i, p in enumerate(embed.parts)
              if isinstance(p, AEGroupPart)]
    assert len(frozen) == 3
    for key in frozen:
        np.testing.assert_equal(to_numpy(state.embed[key]), before[key])
    assert not np.array_equal(to_numpy(state.embed["part0"]["table"]),
                              before["part0"]["table"])   # the full part


# ------------------------------------------------------------ legacy cases

def _weighted_part(weighted):
    part = HashedTablePart([0, 1], [50, 30], [50, 30], 8, weighted=weighted)
    return part, part.init(np.random.default_rng(0))


def test_weighted_pooling_fixed_is_identity_and_untouched():
    part_w, st_w = _weighted_part("fixed")
    part_p, st_p = _weighted_part("")
    ids = torch.from_numpy(np.random.default_rng(1).integers(
        0, 30, (16, 2)).astype(np.int32))
    raw_w, aux = part_w.gather(st_w, ids)
    raw_p, _ = part_p.gather(st_p, ids)
    torch.testing.assert_close(raw_w, raw_p, rtol=0, atol=0)
    g = torch.ones_like(raw_w)
    st_w2, _ = part_w.apply_grads(st_w, ids, g, aux, 0.1)
    st_p2, _ = part_p.apply_grads(st_p, ids, g, aux, 0.1)
    assert bool((st_w2["w"] == 1.0).all())
    torch.testing.assert_close(st_w2["table"], st_p2["table"], rtol=1e-6,
                               atol=0)


def _autodiff_sgd(gather, tables, ids, lr):
    """tables - lr * d(sum(raw^2))/d(tables), by torch autograd."""
    leaves = {k: v.detach().clone().requires_grad_()
              for k, v in tables.items()}
    raw, _ = gather(leaves, ids)
    grads = torch.autograd.grad((raw * raw).sum(), list(leaves.values()))
    return {k: (v - lr * g).detach()
            for (k, v), g in zip(leaves.items(), grads)}


def test_weighted_pooling_learned_matches_autodiff():
    part, st = _weighted_part("learned")
    ids = torch.tensor([[3, 7], [3, 2]], dtype=torch.int32)   # row 3 twice
    want = _autodiff_sgd(part.gather, {"table": st["table"], "w": st["w"]},
                         ids, 0.5)
    raw, aux = part.gather(st, ids)
    st2, _ = part.apply_grads(st, ids, 2 * raw, aux, 0.5)
    for k in ("table", "w"):
        torch.testing.assert_close(st2[k], want[k], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("op", ["add", "mult", "concat"])
def test_qr_ops_match_autodiff(op):
    part = QRPart([0], [1000], 16, 8, operation=op)
    st = part.init(np.random.default_rng(0))
    ids = torch.tensor([[5], [21], [5], [999]], dtype=torch.int32)
    raw, aux = part.gather(st, ids)
    assert raw.shape == (4, 1, 8)
    want = _autodiff_sgd(part.gather, {"q": st["q"], "r": st["r"]}, ids,
                         0.25)
    st2, _ = part.apply_grads(st, ids, 2 * raw, aux, 0.25)
    for k in ("q", "r"):
        torch.testing.assert_close(st2[k], want[k], rtol=1e-5, atol=1e-7)


def test_offpart_zero_cold_falls_back_to_hot_table():
    hd = np.full(20, -1, np.int32)
    hd[3], hd[7] = 0, 1
    part = OffPart([0], [20], [hd], [0], 4)
    st = part.init(np.random.default_rng(0))
    ids = torch.tensor([[3], [7], [4], [6]], dtype=torch.int32)
    rows, _ = part.gather(st, ids)
    hot = st["table"][:2]
    for lane, row in enumerate([0, 1, 0, 0]):    # cold 4, 6 -> 4 % 2, 6 % 2
        assert torch.equal(rows[lane, 0], hot[row])
    assert float(rows.abs().sum()) > 0


# ------------------------------------------------------------ capture

BC = 16


@pytest.mark.parametrize("name", ["qr_mult", "qr_concat", "mde", "off",
                                  "hash_learned", "ae"])
def test_graphable_method_steps_read_nothing_back(name):
    cfg = TConfig(**dict(KW, **METHODS[name], mini_batch_size=BC))
    _, embed, state, step, eval_step = tbuild_all(cfg, device="cpu")
    assert capture_blockers(cfg, embed) == []
    data = get_dataset(cfg, "train")
    batch = [torch.from_numpy(np.ascontiguousarray(a[:BC]))
             for a in (data.dense, data.sparse, data.label)]
    valid = torch.tensor(BC - 3, dtype=torch.int32)
    state, _ = step(state, *batch, valid)
    with NoCaptureBreaks():
        state, m = step(state, *batch, valid)
        eval_step(state, batch[0], batch[1])
    assert torch.isfinite(m["loss"])


def test_ada_step_is_eager_and_reads_back():
    """AdaEmbed's check step (step 1) reads back and runs eagerly; its
    ordinary steps read only their branch predicates, so nothing blocks
    the capture (the GraphedStep runs the check steps eagerly)."""
    cfg = TConfig(**dict(KW, **METHODS["ada"], mini_batch_size=BC))
    _, embed, state, step, _ = tbuild_all(cfg, device="cpu")
    assert capture_blockers(cfg, embed) == []
    assert step.graphed is False
    data = get_dataset(cfg, "train")
    batch = [torch.from_numpy(np.ascontiguousarray(a[:BC]))
             for a in (data.dense, data.sparse, data.label)]
    with pytest.raises(CaptureBreak), NoCaptureBreaks():
        step(clone_state(state), *batch, BC)
    state, _ = step(state, *batch, BC)
    with NoCaptureBreaks():
        step(state, *batch, BC)


# ------------------------------------------------------------ CLI

@pytest.mark.parametrize("name", ["qr_add", "mde", "off", "ada", "ae",
                                  "hash_learned"])
def test_main_torch_runs_each_method(name, capsys):
    sys.path.insert(0, str(REPO))
    import main_torch
    flags = dict(KW, **METHODS[name], synthetic_rows=1024, print_freq=3,
                 test_freq=7, tensor_board_filename="")
    argv = ["--force_platform", "cpu"] + [
        x for k, v in flags.items() for x in (f"--{k}", str(v))]
    res = main_torch.main(argv)
    out = capsys.readouterr().out
    losses = [float(ln.split()[-1]) for ln in out.splitlines()
              if ln.startswith("Finished training it ")]
    assert len(losses) == 7 and np.isfinite(losses).all()
    assert out.count(" accuracy") == 1 and "roc_auc" in res["metrics"]
    assert ("autoencoder pretraining done (1 batches)" in out) is \
        (name == "ae")
