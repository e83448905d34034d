"""bench_torch.py, the jax-free twin of bench.py, on the CPU:

* its FLOPs a step per example equal bench.py's for the headline and the
  three extras, and its constants are bench.py's;
* the batches it measures are bench.py's make_criteo_batches arrays;
* main(device="cpu") on small batches prints one JSON line whose keys
  are bench.py's plus "device" and "graphed", with every rate a number
  and no MFU (the CPU has no card peak);
* a card the peak table does not know raises; an extra that fails
  prints as null and main returns 1; without CUDA the card run raises.
"""

import ast
import dataclasses
import importlib.util
import json
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu_torch.data import CTRArrays

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import bench_torch  # noqa: E402


def _configs():
    cfg = bench_torch.headline_config()
    return {"headline": cfg, **{name: c for name, (c, _) in
                                bench_torch.extra_configs(cfg).items()}}


@pytest.mark.parametrize("name", ["headline", "interval8", "cr1e4",
                                  "dim128"])
def test_flops_per_example_match_bench(name):
    cfg = _configs()[name]
    jcfg = JConfig(**dataclasses.asdict(cfg))
    n_sparse = len(bench.CRITEO_COUNTS)
    assert bench_torch.step_flops_per_example(cfg, 13, n_sparse) == \
        bench.step_flops_per_example(jcfg, 13, n_sparse)


def test_configs_and_constants_match_bench():
    """The four configurations are bench.py's (bench.py:198-258): the
    headline's fields, interval 8, cr 1e-4, the CriteoTB towers at dim
    128 at K = 1 over 100 steps; the constants are bench.py's."""
    for name in ("BATCH", "WARMUP", "STEPS", "WINDOWS", "DISPATCH_K",
                 "BASELINE_EXAMPLES_PER_S", "CRITEO_COUNTS"):
        assert getattr(bench_torch, name) == getattr(bench, name), name
    cfgs = _configs()
    head = cfgs["headline"]
    assert (head.dataset, head.embedding_dim, head.compress_rate,
            head.cafe_sketch_threshold, head.cafe_hash_rate,
            head.learning_rate, head.optimizer, head.bf16,
            head.cafe_insert_interval, head.mini_batch_size) == \
        ("criteo", 16, 0.001, 500.0, 0.5, 0.1, "sgd", True, 1, 2048)
    assert cfgs["interval8"].cafe_insert_interval == 8
    assert cfgs["cr1e4"].compress_rate == 0.0001
    d128 = cfgs["dim128"]
    assert (d128.dataset, d128.embedding_dim, d128.compress_rate,
            d128.learning_rate) == ("criteotb", 128, 0.1, 1.0)
    assert bench_torch.extra_configs(head)["dim128"][1] == \
        {"steps": 100, "dispatch_k": 1}


def test_batches_are_bench_arrays():
    """bench_torch measures the port's make_criteo_batches, which draws
    bench.py's numbers (its 16 batches of 2048 rows, cut to 4 of 64)."""
    assert bench_torch.make_criteo_batches.__module__ == \
        "cafe_tpu_torch.data.criteo"
    jdata, jb = bench.make_criteo_batches(batch=64, n_batches=4)
    tdata, tb = bench_torch.make_criteo_batches(batch=64, n_batches=4,
                                                device="cpu")
    for f in ("sparse", "dense", "label", "counts"):
        np.testing.assert_array_equal(getattr(tdata, f), getattr(jdata, f))
    for (jd, js, jl, jv), (td, ts, tl, tv) in zip(jb, tb):
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(tl.numpy(), np.asarray(jl))
        assert tv == int(jv) == 64


def _bench_keys():
    """The keys of bench.py's JSON line, read from its source: the
    literal keys of the printed dict and the extras' names."""
    src = (REPO / "bench.py").read_text()
    block = src[src.index('print(json.dumps({'):]
    block = block[:block.index("}))")]
    keys = set(re.findall(r'^\s+"(\w+)":', block, re.M))
    return keys | set(re.findall(r'try_extra\("(\w+)"', src))


def _small_data(batch=64, n_batches=16):
    """Criteo-shaped batches with vocabularies cut 1000-fold (each at
    least 4), so every configuration builds small tables on the CPU."""
    counts = np.maximum(np.asarray(bench.CRITEO_COUNTS) // 1000, 4)
    rng = np.random.default_rng(0)
    rows = batch * n_batches
    sparse = np.stack([rng.integers(0, n, rows) for n in counts],
                      1).astype(np.int32)
    dense = rng.random((rows, 13)).astype(np.float32)
    label = rng.integers(0, 2, rows).astype(np.float32)
    data = CTRArrays(sparse, dense, label, counts.astype(np.int32))
    batches = [tuple(torch.from_numpy(a[i * batch:(i + 1) * batch])
                     for a in (dense, sparse, label)) + (batch,)
               for i in range(n_batches)]
    return data, batches


def _main(capsys, **kw):
    rc = bench_torch.main(device="cpu", data=_small_data(), batch=64,
                          windows=2, extra_windows=1, steps=2, warmup=1,
                          **kw)
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    return rc, json.loads(lines[0])


def test_main_prints_bench_line_on_cpu(capsys):
    rc, rec = _main(capsys)
    assert rc == 0
    assert set(rec) == _bench_keys() | {"device", "graphed"}
    assert rec["device"] == {"name": "cpu", "nvidia_smi": None}
    assert rec["graphed"] == {"headline": False, "interval8": False,
                              "cr1e4": False, "dim128": False}
    assert rec["mfu"] is None and rec["windows"] == 2
    for k in ("value", "interval8_examples_per_s", "cr1e4_examples_per_s",
              "dim128_examples_per_s"):
        assert rec[k] > 0, k
    assert rec["window_min"] <= rec["value"] <= rec["window_max"]


def test_failed_extra_prints_null_and_returns_1(capsys, monkeypatch):
    measure = bench_torch.measure

    def failing(cfg, *a, **kw):
        if cfg.embedding_dim == 128:
            raise RuntimeError("out of memory")
        return measure(cfg, *a, **kw)

    monkeypatch.setattr(bench_torch, "measure", failing)
    rc, rec = _main(capsys)
    assert rc == 1
    assert rec["dim128_examples_per_s"] is None
    assert rec["graphed"]["dim128"] is None
    assert rec["interval8_examples_per_s"] > 0


def _chip_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", REPO / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    return smoke


def test_chip_smoke_k1_count():
    """chip_smoke's bench_torch phase expects K1 once an insert: 14 calls
    of 8 steps at the headline and cr 1e-4, 14 inserts and the 2 warm-up
    calls' 14 spare ones at interval 8, 104 dim-128 steps; all but the 2
    warm-up calls of each configuration in graphs."""
    smoke = _chip_smoke()
    assert smoke.bench_k1_want(bench_torch, 2) == (356, 306)


def test_chip_smoke_phase_holds_k1(monkeypatch):
    """chip_smoke's bench_torch phase on the CPU: the line's form, no K1
    launch counted, and K1's wrapper held against its plain version on
    the first insert of each shape: the headline's (interval 8's too) and
    dim 128's (at vocabularies cut 1000-fold cr 1e-4 keeps the
    headline's bucket count; on the card it has a tenth of them)."""
    from cafe_tpu_torch.kernels import KERNELS, land
    smoke = _chip_smoke()
    monkeypatch.setattr(smoke, "BENCH_STEPS", 2)
    monkeypatch.setattr(smoke, "BENCH_WARMUP", 1)
    rec = smoke.phase_bench_torch(bench_torch, land, KERNELS, 2,
                                  device="cpu", data=_small_data(),
                                  batch=64)
    assert rec["launches"]["land_max"] == 0
    assert rec["line"]["graphed"] == {"headline": False, "interval8": False,
                                      "cr1e4": False, "dim128": False}
    cases = rec["land_max_cases"]
    shapes = {tuple(c["shape"]) for c in cases}
    assert len(shapes) == len(cases) == 2, shapes
    assert all(c["max_abs_err"] == 0 and c["two_launches_equal"]
               for c in cases)


def test_unknown_card_raises():
    assert bench_torch.peak_flops("NVIDIA H100 80GB HBM3") == 989e12
    with pytest.raises(ValueError, match="no bf16 peak"):
        bench_torch.peak_flops("NVIDIA Some Card")
    assert "DEFAULT_PEAK" not in vars(bench_torch)


def test_card_run_needs_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        bench_torch.main()


def test_imports_no_jax():
    tree = ast.parse((REPO / "bench_torch.py").read_text())
    for node in ast.walk(tree):
        if isinstance(node, (ast.Import, ast.ImportFrom)):
            names = [a.name for a in node.names] \
                if isinstance(node, ast.Import) else [node.module or ""]
            for name in names:
                assert name.split(".")[0] not in ("jax", "jaxlib",
                                                  "cafe_tpu"), name
