"""Quantized serving (ops/quantized.py, each part's quantize_for_serving /
gather_quantized, train/step.build_quantized_eval_step, main_torch's
--inference_only --quantize_emb_bits) against the JAX package, on the CPU.

* quantize_rowwise: codes, scale and zero byte-equal to the JAX
  package's at 8 and 4 bits (random rows, constant rows — the 1e-12
  clamp —, negative rows, dim 128, an odd width served at 8 bits);
  dequantize_rows within 1e-6 relative; the JAX tests' round-trip bounds
  (0.002 at 8 bits, 0.05 at 4) and int4 packing case;
* per part (hash, full, weighted hash and full, QR add / mult / concat,
  MDE, Off, AdaEmbed, AE, CAFE v1, CAFE+), on one state (the JAX
  package's after two train steps, bridged): quantize_for_serving
  byte-equal (the v1 CafePart's frozen packed sketch view, `sk_packed`,
  too), gather_quantized
  within 1e-6, the quantized eval scores within test_torch_methods'
  bounds (f32 towers rtol 1e-5 / atol 1e-6, bf16 2e-3) of the JAX
  package's quantized eval step (of its parts' lookups composed as that
  step composes them where an odd-width table serves at 8 bits under
  int4: the JAX step reads such a table at 4), the JAX tests'
  mean |p_full - p_q8| < 0.01, and no value read back to the host in
  the quantized eval step (test_torch_capture's dispatch mode);
* the packed sketch view: _pack_cells byte-equal to the JAX package's,
  query_cells_packed exactly equal to its and to the plain query on
  random cells (empty, dic-0 and duplicate-val cells) and on trained
  sketches; a view frozen at quantize time keeps serving the sketch as
  it stood then after more train steps, in both packages;
* main_torch.main --inference_only --load_model ... --quantize_emb_bits
  8 and 4 after a training run that saved: accuracy within 0.01 of the
  float eval of the same checkpoint.
"""

import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.data import batch_iterator as jbatches
from cafe_tpu.ops import quantized as jq
from cafe_tpu.train.loop import build_all as jbuild_all, get_dataset as jdata
from cafe_tpu.train.step import build_quantized_eval_step as jquant_eval
from cafe_tpu_torch.bridge import from_reference
from cafe_tpu_torch.config import Config as TConfig
from cafe_tpu_torch.ops import quantized as tq
from cafe_tpu_torch.train import (build_all as tbuild_all,
                                  build_quantized_eval_step, get_dataset)
from cafe_tpu_torch.train.loop import check_supported
from test_torch_capture import NoCaptureBreaks
from test_torch_methods import ATOL, BF16_TOL, KW, METHODS, RTOL

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


# ------------------------------------------------------ quantize_rowwise

def _rows(kind, rng):
    if kind == "constant":         # hi == lo: the scale's 1e-12 clamp
        t = rng.normal(0, 1, (64, 16)).astype(np.float32)
        t[::3] = t[::3, :1]
        return t
    if kind == "negative":
        return -np.abs(rng.normal(0.5, 2.0, (64, 16))).astype(np.float32)
    if kind == "wide":
        return rng.normal(0, 0.05, (512, 128)).astype(np.float32)
    return rng.normal(rng.normal(), 0.3, (1024, 16)).astype(np.float32)


def _assert_same_table(t, j):
    np.testing.assert_array_equal(t.codes.numpy(), np.asarray(j.codes))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(j.scale))
    np.testing.assert_array_equal(t.zero.numpy(), np.asarray(j.zero))
    assert t.codes.dtype == torch.uint8 and t.bits == j.bits
    assert isinstance(t.bits, int)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("kind", ["random", "constant", "negative", "wide"])
def test_quantize_rowwise_byte_equal(kind, bits):
    table = _rows(kind, np.random.default_rng(0))
    t = tq.quantize_rowwise(torch.from_numpy(table), bits)
    j = jq.quantize_rowwise(jnp.asarray(table), bits)
    _assert_same_table(t, j)
    assert t.codes.shape[1] == table.shape[1] // (8 // bits) + 8
    idx = np.random.default_rng(1).integers(0, len(table), 300)
    np.testing.assert_allclose(
        tq.dequantize_rows(t, torch.from_numpy(idx)).numpy(),
        np.asarray(jq.dequantize_rows(j, jnp.asarray(idx))),
        rtol=1e-6, atol=1e-6 * np.abs(table).max())


def test_odd_width_serves_at_8_bits():
    """Part._quantize: int4 packs code pairs, so an odd width takes 8
    bits, in both packages."""
    from cafe_tpu.embeddings.base import Part as JPart
    from cafe_tpu_torch.embeddings.base import Part as TPart
    table = np.random.default_rng(2).normal(0, 1, (96, 7)).astype(np.float32)
    t = TPart()._quantize(torch.from_numpy(table), 4)
    j = JPart()._quantize(jnp.asarray(table), 4)
    assert t.bits == 8 == j.bits
    _assert_same_table(t, j)


def test_roundtrip_error_bounds():
    rng = np.random.default_rng(0)
    table = torch.from_numpy(rng.normal(0, 0.1, (64, 16)).astype(np.float32))
    for bits, tol in [(8, 0.002), (4, 0.05)]:
        qt = tq.quantize_rowwise(table, bits)
        err = (tq.dequantize_rows(qt, torch.arange(64)) - table).abs()
        assert float(err.max()) < tol
        assert tq.quantization_error(table, bits) == float(err.max())


def test_int4_packing():
    table = torch.arange(32, dtype=torch.float32).reshape(2, 16)
    qt = tq.quantize_rowwise(table, 4)
    # 8 nibble-pair bytes + 4 scale + 4 zero bytes a row, plane-major
    assert qt.codes.shape == (2, 16) and qt.codes.dtype == torch.uint8
    lo, hi = qt.codes[:, :8] & 0x0F, qt.codes[:, :8] >> 4
    np.testing.assert_array_equal(lo.numpy(), [[0, 1, 2, 3, 4, 5, 6, 7]] * 2)
    np.testing.assert_array_equal(hi.numpy(), [[8, 9, 10, 11, 12, 13, 14,
                                                15]] * 2)
    out = tq.dequantize_rows(qt, torch.tensor([0, 1]))
    np.testing.assert_allclose(out.numpy(), table.numpy(), atol=0.6)


# -------------------------------------------------------------- per part

PARTS = {
    "hash": {"compress_method": "hash"},
    "full": {"compress_method": "full"},
    **{k: METHODS[k] for k in ("hash_fixed", "hash_learned", "full_learned",
                               "qr_add", "qr_mult", "qr_concat", "mde",
                               "off", "ada", "ae")},
    "cafe": {"compress_method": "cafe"},
    "cafe_plus": {"compress_method": "cafe", "cafe_plus": True},
    "cafe_bf16": {"compress_method": "cafe", "bf16": True},
}
EVAL_ROWS = 256
_CACHE = {}


def _served(name):
    """Both packages at PARTS[name] on one state: the JAX package's after
    two train steps, and its bridged copy; plus an eval batch."""
    if name in _CACHE:
        return _CACHE[name]
    kw = dict(KW, **PARTS[name])
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jtrain = jdata(jcfg, "train")
    jmodel, jembed, jstate, jstep, jeval = jbuild_all(jcfg, jtrain)
    for dense, sparse, label, valid in list(jbatches(
            jtrain, kw["mini_batch_size"], drop_last=True))[:2]:
        jstate, _ = jstep(jstate, jnp.asarray(dense), jnp.asarray(sparse),
                          jnp.asarray(label), valid)
    jstate = jax.device_get(jstate)
    tmodel, tembed, _, _, teval = tbuild_all(
        tcfg, get_dataset(tcfg, "train"), device="cpu")
    tstate = from_reference(jstate, "cpu")
    test = get_dataset(tcfg, "test")
    batch = (np.ascontiguousarray(test.dense[:EVAL_ROWS]),
             np.ascontiguousarray(test.sparse[:EVAL_ROWS]))
    _CACHE[name] = out = dict(kw=kw, j=(jmodel, jembed, jstate, jeval),
                              t=(tmodel, tembed, tstate, teval),
                              batch=batch)
    return out


def _tb(batch):
    return tuple(torch.from_numpy(x) for x in batch)


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", sorted(PARTS))
def test_quantize_for_serving_equals_jax(name, bits):
    s = _served(name)
    _, jembed, jstate, _ = s["j"]
    _, tembed, tstate, _ = s["t"]
    for i, (jp, tp) in enumerate(zip(jembed.parts, tembed.parts)):
        key = f"part{i}"
        got = tp.quantize_for_serving(tstate.embed[key], bits)
        want = jp.quantize_for_serving(jstate.embed[key], bits)
        assert set(got) == set(want), key
        for k in want:
            if k == "sk_packed":
                assert got[k].dtype == torch.int32
                np.testing.assert_array_equal(got[k].numpy(),
                                              np.asarray(want[k]))
            else:
                _assert_same_table(got[k], want[k])


@pytest.mark.parametrize("name", sorted(PARTS))
def test_gather_quantized_equals_jax(name):
    s = _served(name)
    _, jembed, jstate, _ = s["j"]
    _, tembed, tstate, _ = s["t"]
    ids = s["batch"][1]
    for bits in (8, 4):
        for i, (jp, tp) in enumerate(zip(jembed.parts, tembed.parts)):
            key = f"part{i}"
            cols = np.asarray(tp.field_idx)
            jqt = jp.quantize_for_serving(jstate.embed[key], bits)
            want = jp.gather_quantized(jstate.embed[key], jqt,
                                       jnp.asarray(ids[:, cols]))
            tqt = tp.quantize_for_serving(tstate.embed[key], bits)
            got = tp.gather_quantized(tstate.embed[key], tqt,
                                      torch.from_numpy(ids[:, cols]))
            np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                       rtol=1e-6, atol=1e-6,
                                       err_msg=f"{key} bits {bits}")


def _jax_scores(s, bits):
    """(scores, whether they are the JAX package's quantized eval step's).
    That step re-reads every table at the step's `bits`, so a table that
    an odd width sent to 8 bits would be read as int4 codes: where one
    exists the reference is the JAX parts' own lookups, composed as the
    step composes them, each table at its own bits."""
    jmodel, jembed, jstate, _ = s["j"]
    dense, sparse = (jnp.asarray(x) for x in s["batch"])
    qts = [p.quantize_for_serving(jstate.embed[f"part{i}"], bits)
           for i, p in enumerate(jembed.parts)]
    if all(qt.bits == bits for part in qts for qt in part.values()
           if isinstance(qt, jq.QuantizedTable)):
        return np.asarray(jquant_eval(jmodel, jembed, jstate, bits)(
            jstate, dense, sparse)), True
    feats = []
    for i, (p, qt) in enumerate(zip(jembed.parts, qts)):
        key = f"part{i}"
        raw = p.gather_quantized(jstate.embed[key], qt,
                                 sparse[:, np.asarray(p.field_idx)])
        feats.append(p.transform(jstate.embed_dense[key], raw))
    feats = jnp.concatenate(feats, axis=1)[:, jembed._perm]
    return np.asarray(jmodel.apply(jstate.params, dense, feats)), False


@pytest.mark.parametrize("bits", [8, 4])
@pytest.mark.parametrize("name", sorted(PARTS))
def test_quantized_eval_scores_match_jax(name, bits):
    s = _served(name)
    tmodel, tembed, tstate, _ = s["t"]
    want, _ = _jax_scores(s, bits)
    step = build_quantized_eval_step(tmodel, tembed, tstate, bits)
    assert step.graphed is False and step.capture_blockers == []
    got = step(tstate, *_tb(s["batch"])).numpy()
    tol = (BF16_TOL, BF16_TOL) if s["kw"].get("bf16") else (RTOL, ATOL)
    np.testing.assert_allclose(got, want, rtol=tol[0], atol=tol[1])


def test_an_odd_width_table_serves_at_its_own_bits():
    """AE's width-1 group quantizes at 8 bits under --quantize_emb_bits 4.
    The port dequantizes each table at the bits it was quantized with;
    the JAX package's step reads it as int4 codes and so serves other
    scores (a flaw of the reference, kept out of the port)."""
    s = _served("ae")
    tmodel, tembed, tstate, _ = s["t"]
    jmodel, jembed, jstate, _ = s["j"]
    want, from_step = _jax_scores(s, 4)
    assert not from_step
    got = build_quantized_eval_step(tmodel, tembed, tstate, 4)(
        tstate, *_tb(s["batch"])).numpy()
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    jax_step = np.asarray(jquant_eval(jmodel, jembed, jstate, 4)(
        jstate, *(jnp.asarray(x) for x in s["batch"])))
    assert np.abs(jax_step - got).max() > 1e-5


@pytest.mark.parametrize("name", sorted(PARTS))
def test_quantized_predictions_close_to_float(name):
    """The JAX tests' check of int8 serving against the float eval."""
    s = _served(name)
    tmodel, tembed, tstate, teval = s["t"]
    batch = _tb(s["batch"])
    p_full = teval(tstate, *batch)
    p_q8 = build_quantized_eval_step(tmodel, tembed, tstate, 8)(tstate,
                                                                 *batch)
    assert float((p_full - p_q8).abs().mean()) < 0.01


@pytest.mark.parametrize("name", sorted(PARTS))
def test_quantized_eval_reads_nothing_back(name):
    """What a CUDA graph of the quantized eval step would hold: no value
    read back to the host, no shape that depends on the data (one call
    first, as the graph's warm-up makes its constants)."""
    s = _served(name)
    tmodel, tembed, tstate, _ = s["t"]
    batch = _tb(s["batch"])
    step = build_quantized_eval_step(tmodel, tembed, tstate, 4)
    step(tstate, *batch)
    with NoCaptureBreaks():
        p = step(tstate, *batch)
    assert p.shape == batch[0].shape[:1] and torch.isfinite(p).all()


# ------------------------------------------------- the packed sketch view

def _random_cells(rng, rows=96, c=4):
    """Cells with empty (cnt 0), unpromoted (dic 0) and duplicate-val
    entries: ids 0..399 sit in cells of their own bucket (some twice, so
    a bucket holds duplicate vals), the rest of the cells hold ids that
    hash elsewhere."""
    from cafe_tpu.sketch import hotsketch as jhs
    val = rng.integers(0, 400, (rows, c)).astype(np.int32)
    home = np.asarray(jhs._bucket_of(jhs.HotSketchConfig(
        buckets=rows, threshold=1.0), jnp.arange(400, dtype=jnp.int32)))
    for i in rng.permutation(400)[:200]:
        val[home[i], rng.integers(0, c, 2)] = i          # maybe twice
    cnt = rng.integers(0, 4, (rows, c)).astype(np.float32) \
        * rng.random((rows, c)).astype(np.float32)
    cnt[rng.random((rows, c)) < 0.25] = 0.0
    dic = rng.integers(1, rows, (rows, c)).astype(np.int32)
    dic[rng.random((rows, c)) < 0.4] = 0
    return val, cnt, dic


def _trained_cells(seed):
    """A JAX v1 sketch after an integer-score insert stream that
    promotes and decays."""
    from cafe_tpu.sketch import hotsketch as jhs
    rng = np.random.default_rng(seed)
    cfg = jhs.HotSketchConfig(buckets=96, threshold=4.0, decay=0.5)
    st = jhs.init_sketch(cfg)
    for _ in range(6):
        ids = rng.zipf(1.3, 512).astype(np.int64) % 400
        scores = rng.integers(0, 4, 512).astype(np.float32)
        st, _ = jhs.sketch_insert(cfg, st, jnp.asarray(ids.astype(np.int32)),
                                  jnp.asarray(scores))
    return tuple(np.array(x) for x in (st.val, st.cnt, st.dic))


def _cells(kind, seed):
    if kind == "random":
        return _random_cells(np.random.default_rng(seed))
    return _trained_cells(seed)


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["random", "trained"])
def test_pack_cells_byte_equal(kind, seed):
    from cafe_tpu.sketch import hotsketch as jhs
    from cafe_tpu_torch.sketch import hotsketch as ths
    val, cnt, dic = _cells(kind, seed)
    got = ths._pack_cells(*(torch.from_numpy(x) for x in (val, cnt, dic)))
    want = np.asarray(jhs._pack_cells(*(jnp.asarray(x)
                                        for x in (val, cnt, dic))))
    assert got.dtype == torch.int32 and got.shape == want.shape
    assert got.numpy().tobytes() == want.tobytes()


@pytest.mark.parametrize("seed", [0, 1])
@pytest.mark.parametrize("kind", ["random", "trained"])
def test_query_cells_packed_equals_jax(kind, seed):
    from cafe_tpu.sketch import hotsketch as jhs
    from cafe_tpu_torch.sketch import hotsketch as ths
    val, cnt, dic = _cells(kind, seed)
    rows = val.shape[0]
    jcfg = jhs.HotSketchConfig(buckets=rows, threshold=4.0)
    tcfg = ths.HotSketchConfig(buckets=rows, threshold=4.0)
    ids = np.concatenate([np.arange(400), val.reshape(-1)]).astype(np.int32)
    packed = jhs._pack_cells(*(jnp.asarray(x) for x in (val, cnt, dic)))
    want = np.asarray(jhs.query_cells_packed(jcfg, packed, jnp.asarray(ids)))
    tv, tc, td = (torch.from_numpy(x) for x in (val, cnt, dic))
    got = ths.query_cells_packed(tcfg, ths._pack_cells(tv, tc, td),
                                 torch.from_numpy(ids))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        got.numpy(), ths.query_cells(tcfg, tv, tc, td,
                                     torch.from_numpy(ids)).numpy())
    assert (want < 0).any() and (want >= 0).any()   # hot and cold lanes


def _steps(kw, n):
    """The JAX package's state after `n` train steps at kw, its layer
    and step, the port's layer at kw, and the train batches."""
    jcfg, tcfg = JConfig(**kw), TConfig(**kw)
    jtrain = jdata(jcfg, "train")
    jmodel, jembed, jstate, jstep, _ = jbuild_all(jcfg, jtrain)
    batches = list(jbatches(jtrain, kw["mini_batch_size"], drop_last=True))
    for dense, sparse, label, valid in batches[:n]:
        jstate, _ = jstep(jstate, jnp.asarray(dense), jnp.asarray(sparse),
                          jnp.asarray(label), valid)
    _, tembed, _, _, _ = tbuild_all(tcfg, get_dataset(tcfg, "train"),
                                    device="cpu")
    return jembed, jstate, jstep, tembed, batches


@pytest.mark.parametrize("bits", [8, 4])
def test_a_frozen_view_serves_the_sketch_it_was_quantized_from(bits):
    """Quantize, train on, then serve with the old tables: both packages
    route through the view frozen at quantize time, not through the
    state's newer sketch, and agree on every row."""
    kw = dict(KW, compress_method="cafe", cafe_use_freq=True,
              cafe_sketch_threshold=2.0)
    jembed, jstate, jstep, tembed, batches = _steps(kw, 2)
    i = next(i for i, p in enumerate(tembed.parts)
             if type(p).__name__ == "CafePart")
    key = f"part{i}"
    jp, tp = jembed.parts[i], tembed.parts[i]
    jold = jax.device_get(jstate)
    jqt = jp.quantize_for_serving(jold.embed[key], bits)
    told = from_reference(jold, "cpu").embed[key]
    tqt = tp.quantize_for_serving(told, bits)
    assert "sk_packed" in tqt and "sk_packed" in jqt
    for dense, sparse, label, valid in batches[2:6]:
        jstate, _ = jstep(jstate, jnp.asarray(dense), jnp.asarray(sparse),
                          jnp.asarray(label), valid)
    jnew = jax.device_get(jstate).embed[key]
    tnew = from_reference(jax.device_get(jstate), "cpu").embed[key]
    ids = np.concatenate([b[1] for b in batches[:6]])[:, tp.field_idx]
    want = np.asarray(jp.gather_quantized(jnew, jqt, jnp.asarray(ids)))
    got = tp.gather_quantized(tnew, tqt, torch.from_numpy(ids))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    # the view is the sketch at quantize time: the newer sketch routes
    # some id elsewhere, and without the view the port serves that route
    plain = {k: v for k, v in tqt.items() if k != "sk_packed"}
    newer = tp.gather_quantized(tnew, plain, torch.from_numpy(ids))
    assert not torch.equal(newer, got)
    _, frozen_row, _, _ = tp._route(told, torch.from_numpy(ids))
    np.testing.assert_array_equal(
        got.numpy(), tp._dequantize(tqt["table"], frozen_row).numpy())


def test_no_view_under_a_mesh_layout_or_cafe_plus():
    """The view is frozen only where the JAX package freezes it: one
    device, the flat sketch layout, the v1 sketch."""
    from cafe_tpu_torch.embeddings.cafe import CafePart
    args = ([0, 1], [500, 700], [0, 500], 64, [40, 50], 8, 2.0, 0.99, 700)
    rng = np.random.default_rng(0)
    for plus, layout in ((False, 0), (True, 0), (False, 1), (False, 2)):
        part = CafePart(*args, plus=plus)
        part.device = torch.device("cpu")
        if layout:
            assert part.enable_sharded_layout(layout)
        qt = part.quantize_for_serving(part.init(rng), 8)
        assert ("sk_packed" in qt) == (not plus and not layout)


# ------------------------------------------------------------------ CLI

CLI = ["--force_platform", "cpu", "--dataset", "synthetic",
       "--synthetic_rows", "2048", "--synthetic_fields", "4",
       "--synthetic_vocab", "2000", "--synthetic_dense", "4",
       "--embedding_dim", "8", "--mini_batch_size", "128",
       "--test_mini_batch_size", "128", "--compress_rate", "0.05",
       "--learning_rate", "0.1", "--print_freq", "8"]


def _serve_accuracy(text):
    m = re.search(r"^accuracy=([\d.]+) ", text, re.M)
    assert m, text
    return float(m.group(1))


@pytest.mark.parametrize("method", ["cafe", "cafe_plus", "qr"])
def test_main_torch_serves_quantized(method, tmp_path, capsys):
    sys.path.insert(0, str(REPO))
    import main_torch
    flags = ["--compress_method", "qr" if method == "qr" else "cafe",
             "--cafe_plus", str(method == "cafe_plus").lower()]
    save = str(tmp_path / "m")
    main_torch.main(CLI + flags + ["--test_freq", "6", "--save_model",
                                   save, "--tensor_board_filename",
                                   str(tmp_path / "run")])
    assert "saved model to" in capsys.readouterr().out
    serve = CLI + flags + ["--inference_only", "true", "--load_model", save,
                           "--tensor_board_filename", ""]
    main_torch.main(serve)
    acc = _serve_accuracy(capsys.readouterr().out)
    for bits in ("8", "4"):
        check_supported(TConfig(quantize_emb_bits=int(bits)))
        main_torch.main(serve + ["--quantize_emb_bits", bits])
        assert abs(_serve_accuracy(capsys.readouterr().out) - acc) < 0.01
