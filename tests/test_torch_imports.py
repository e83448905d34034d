"""The port stands alone: no jax, nothing of cafe_tpu; its entry points
refuse to run on the CPU unless asked; its copies of the JAX package's
numpy-only modules stay equal to the originals."""

import ast
import dataclasses
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import cafe_tpu_torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
PKG = REPO / "cafe_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "cafe_tpu")


def _all_modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        cafe_tpu_torch.__path__, "cafe_tpu_torch."))


def test_imports_with_jax_and_cafe_tpu_blocked():
    code = ("import sys\n"
            "for name in ('jax', 'jaxlib', 'cafe_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import importlib\n"
            f"for m in {_all_modules()!r}:\n"
            "    importlib.import_module(m)\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


# files the card's machine (no jax) runs besides the package
JAX_FREE = ["chip_smoke.py", "bench_torch.py", "main_torch.py",
            "main_graphrec_torch.py",
            "tests/torch_dist_worker.py",
            "tests/test_torch_kernels.py", "tests/test_torch_loader.py",
            "tests/test_torch_sharded_cuda.py", "tools/a2a_cards_torch.py",
            "tools/ab_decisions_torch.py", "tools/ab_insert_land_torch.py",
            "tools/serving_bench_torch.py", "tools/sketch_bench_torch.py",
            "tools/ab_apply128_torch.py", "tools/ab_interact_torch.py",
            "tools/ab_scatter_vs_sorted_torch.py",
            "tools/clock_probe_torch.py", "tools/compiled_call_torch.py",
            "tools/kernel_overhead_probe_torch.py",
            "tools/latency_grid_torch.py", "tools/micro_ops_torch.py",
            "tools/profile_lines_torch.py", "tools/profile_step_torch.py",
            "tools/profile_train_torch.py", "tools/reset_cost_torch.py",
            "tools/step_breakdown_torch.py",
            "tools/sweep_cafe_vs_hash_torch.py",
            "tools/variance_cafe_vs_hash_torch.py",
            "tools/traffic_table_torch.py", "tools/pod_shape_check_torch.py",
            "tools/perf_report_torch.py", "tools/cond_nccl_probe_torch.py"]
# the root tools that run on the card: each parses its flags (--help)
# with jax blocked
ROOT_TOOLS = [p[len("tools/"):-len(".py")] for p in JAX_FREE
              if p.startswith("tools/")]


@pytest.mark.parametrize("path", sorted(
    [str(p.relative_to(REPO)) for p in PKG.rglob("*.py")] + JAX_FREE))
def test_no_import_names_jax_or_cafe_tpu(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module]
        else:
            continue
        for name in names:
            root = name.split(".")[0]
            assert root not in FORBIDDEN, f"{path}:{node.lineno} {name}"


# the data and experiment tools: each parses its flags (--help)
FLAG_TOOLS = ["cafe_tpu_torch.data.preprocess",
              "cafe_tpu_torch.tools.criteo_grid",
              "cafe_tpu_torch.tools.job_scheduler",
              "cafe_tpu_torch.tools.process_interactions",
              "cafe_tpu_torch.tools.visualization"]


def test_tools_import_with_jax_blocked(tmp_path):
    """cafe_tpu_torch.tools and the port's root tool scripts import (and
    parse their flags) with jax and cafe_tpu blocked."""
    assert "cafe_tpu_torch.tools.roofline" in _all_modules()
    assert set(FLAG_TOOLS) <= set(_all_modules())
    code = ("import sys, importlib, importlib.util, contextlib, io\n"
            "for name in ('jax', 'jaxlib', 'cafe_tpu'):\n"
            "    sys.modules[name] = None\n"
            "import cafe_tpu_torch.tools.roofline\n"
            "sys.path.insert(0, 'tools')\n"
            f"for name in {ROOT_TOOLS!r}:\n"
            "    spec = importlib.util.spec_from_file_location(\n"
            "        name, f'tools/{name}.py')\n"
            "    mod = importlib.util.module_from_spec(spec)\n"
            "    spec.loader.exec_module(mod)\n"
            "    # a2a_cards' main takes no argv; compiled_call is a helper\n"
            "    if name not in ('a2a_cards_torch', 'compiled_call_torch'):\n"
            "        try:\n"
            "            with contextlib.redirect_stdout(io.StringIO()) as o:\n"
            "                mod.main(['--help'])\n"
            "        except SystemExit as e:\n"
            "            assert e.code == 0 and 'usage' in o.getvalue(), name\n"
            "        else:\n"
            "            raise AssertionError(name)\n"
            f"for name in {FLAG_TOOLS!r}:\n"
            "    mod = importlib.import_module(name)\n"
            "    try:\n"
            "        with contextlib.redirect_stdout(io.StringIO()) as out:\n"
            "            mod.main(['--help'])\n"
            "    except SystemExit as e:\n"
            "        assert e.code == 0 and 'usage' in out.getvalue(), name\n"
            "    else:\n"
            "        raise AssertionError(name)\n"
            "from cafe_tpu_torch.tools import gen_tasks, hlo_traffic\n"
            "with contextlib.redirect_stdout(io.StringIO()):\n"
            f"    gen_tasks.main({str(tmp_path)!r})\n"
            "assert hlo_traffic.model_result_bytes(512, 16, 4, 100)['total']\n"
            "print('ok')\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_entry_points_need_cuda_unless_cpu(monkeypatch):
    sys.path.insert(0, str(REPO))
    import main_torch
    from cafe_tpu_torch import bridge
    from cafe_tpu_torch.config import Config
    from cafe_tpu_torch.data import make_criteo_batches
    from cafe_tpu_torch.data.loader import device_prefetch
    from cafe_tpu_torch.embeddings import (EmbeddingLayer, HashedTablePart,
                                           build_embedding_layer)
    from cafe_tpu_torch.models import DLRM, init_mlp
    from cafe_tpu_torch.sketch.hotsketch import HotSketchConfig, init_sketch
    from cafe_tpu_torch.train import build_all
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = Config(dataset="synthetic", synthetic_rows=256,
                 synthetic_fields=2, synthetic_vocab=500,
                 compress_method="cafe", compress_rate=0.05)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_all(cfg)
    with pytest.raises(RuntimeError, match="CUDA"):
        make_criteo_batches(batch=8, n_batches=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        bridge.to_torch({"w": np.zeros(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        build_embedding_layer(cfg, [3000, 40], 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        DLRM(8, 2, 4, [4, 8], [9, 4, 1])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_mlp(torch.Generator().manual_seed(0), [4, 8])
    with pytest.raises(RuntimeError, match="CUDA"):
        init_sketch(HotSketchConfig(buckets=64, threshold=1.0))
    with pytest.raises(RuntimeError, match="CUDA"):
        EmbeddingLayer([HashedTablePart([0], [10], [10], 8)], 1, 8)
    with pytest.raises(RuntimeError, match="CUDA"):
        next(device_prefetch(iter([])))
    with pytest.raises(RuntimeError, match="CUDA"):
        main_torch.main(["--dataset", "synthetic", "--synthetic_rows", "256",
                         "--tensor_board_filename", ""])
    *_, state, step, _ = build_all(cfg, device="cpu")
    assert state.embed["part0"]["table"].device.type == "cpu"
    assert DLRM(8, 2, 4, [4, 8], [9, 4, 1], device="cpu").init(0)[
        "top"][0]["w"].device.type == "cpu"
    _, batches = make_criteo_batches(batch=8, n_batches=1, device="cpu")
    assert batches[0][1].shape == (8, 26)


def test_config_copy_matches_jax_package():
    from cafe_tpu.config import Config as JConfig
    from cafe_tpu_torch.config import Config as TConfig
    jf = [(f.name, f.default) for f in dataclasses.fields(JConfig)]
    tf = [(f.name, f.default) for f in dataclasses.fields(TConfig)]
    assert tf == jf


def test_sizing_copy_matches_jax_package():
    from cafe_tpu.embeddings import sizing as js
    from cafe_tpu_torch.embeddings import sizing as ts
    counts = [1460, 583, 10131227, 2202608, 305, 24, 12517]
    for cr in (1e-4, 1e-3, 0.05, 0.1):
        assert ts.cafe_hotn(counts, cr, 16, 0.5) == \
            js.cafe_hotn(counts, cr, 16, 0.5)
        assert ts.hash_sizes(counts, cr) == js.hash_sizes(counts, cr)
        assert ts.mde_dims(counts, cr, 16) == js.mde_dims(counts, cr, 16)
        assert ts.cafe_hash_size(10131227, cr, 0.5) == \
            js.cafe_hash_size(10131227, cr, 0.5)


def test_criteo_batches_match_bench():
    sys.path.insert(0, str(REPO))
    import bench
    from cafe_tpu_torch.data import make_criteo_batches
    jdata, jb = bench.make_criteo_batches(batch=64, n_batches=2)
    tdata, tb = make_criteo_batches(batch=64, n_batches=2, device="cpu")
    for f in ("sparse", "dense", "label", "counts"):
        np.testing.assert_array_equal(getattr(tdata, f), getattr(jdata, f))
    for (jd, js, jl, _), (td, ts, tl, tv) in zip(jb, tb):
        np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
        np.testing.assert_array_equal(td.numpy(), np.asarray(jd))
        assert tv == 64


def test_batch_iterator_matches_jax_package():
    from cafe_tpu.data import batch_iterator as jbatches
    from cafe_tpu.data import make_synthetic_arrays as jarrays
    from cafe_tpu_torch.data import batch_iterator, make_synthetic_arrays
    kw = dict(rows=1000, fields=3, vocab=50, dense=2)
    data, jdata = make_synthetic_arrays(**kw), jarrays(**kw)
    for drop_last in (False, True):
        got = list(batch_iterator(data, 128, drop_last=drop_last))
        want = list(jbatches(jdata, 128, drop_last=drop_last))
        assert len(got) == len(want) == (7 if drop_last else 8)
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)


COPIES = ["train/metrics.py", "utils/logging.py", "data/datasets.py",
          "sketch/oracle.py", "models/graphrec/sampling.py",
          "data/preprocess.py", "tools/gen_tasks.py",
          "tools/visualization.py"]


@pytest.mark.parametrize("rel", COPIES)
def test_verbatim_copies_equal_originals(rel):
    """Numpy-only modules the port keeps verbatim copies of."""
    assert (PKG / rel).read_text() == (REPO / "cafe_tpu" / rel).read_text()


def test_metrics_copy_matches_jax_package():
    from cafe_tpu.train import metrics as jm
    from cafe_tpu_torch.train import metrics as tm
    rng = np.random.default_rng(0)
    for n in (50, 1000):
        y = rng.integers(0, 2, n)
        scores = np.round(rng.random(n), 1)       # many ties
        assert tm.binary_metrics(y, scores) == jm.binary_metrics(y, scores)
    assert np.isnan(tm.roc_auc(np.ones(5), rng.random(5)))


def test_logger_copy_writes_the_same_lines(tmp_path):
    import json
    from cafe_tpu.utils.logging import ScalarLogger as JLogger
    from cafe_tpu_torch.utils.logging import ScalarLogger as TLogger
    lines = {}
    for name, cls in (("j", JLogger), ("t", TLogger)):
        log = cls(str(tmp_path / name))
        for step, (tag, v) in enumerate([("Train/Loss", 0.69),
                                         ("Test/Acc", 0.51),
                                         ("roc_auc", np.float32(0.5))]):
            log.add_scalar(tag, v, step)
        log.close()
        with open(tmp_path / name / "scalars.jsonl") as f:
            lines[name] = [{k: v for k, v in json.loads(ln).items()
                            if k != "ts"} for ln in f]
    assert lines["t"] == lines["j"] and len(lines["t"]) == 3


COLLECTIVES = {"all_reduce", "all_gather", "all_gather_into_tensor",
               "all_gather_single", "reduce_scatter_tensor",
               "reduce_scatter_single", "all_to_all_single", "broadcast",
               "barrier", "all_gather_object"}
# exchange.py's names for the collectives it picks by torch version
ALIASES = {"_all_gather_single", "_reduce_scatter_single"}


@pytest.mark.parametrize("path", sorted(
    str(p.relative_to(REPO)) for p in PKG.rglob("*.py")))
def test_collectives_name_the_mesh_group(path):
    """Every collective of the port names its process group (the mesh's),
    never the default group implicitly."""
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if not isinstance(node, ast.Call):
            continue
        fn = node.func
        if isinstance(fn, ast.Attribute):
            is_dist = getattr(fn.value, "id", None) == "dist"
            hit = is_dist and fn.attr in COLLECTIVES
            name = fn.attr
        else:
            name = getattr(fn, "id", None)
            hit = name in ALIASES
        if hit:
            assert any(k.arg == "group" for k in node.keywords), \
                f"{path}:{node.lineno} {name} without group="


def _roadmap_items():
    """The item numbers ROADMAP.md section 1 lists ("**Item 6.3:",
    "**Items 6.1, 6.7:")."""
    text = (REPO / "ROADMAP.md").read_text()
    sec = text[text.index("### 1."):text.index("### 2.")]
    heads = re.findall(r"\*\*Items? ([\d., and]+?):", sec)
    return {n for h in heads for n in re.findall(r"\d+(?:\.\d+)?", h)}


def test_port_names_only_roadmap_items_that_exist():
    """Every "ROADMAP queue ... item N" the port names is an item that
    ROADMAP.md section 1 still lists (none may be named: since item 6
    every mesh flag runs), and no message names a queue by a letter
    ("queue Q8") any more."""
    listed = _roadmap_items()
    paths = sorted(PKG.rglob("*.py")) + [REPO / p for p in JAX_FREE
                                         if not p.startswith("tests/")]
    named = {}
    for path in paths:
        text = path.read_text()
        assert not re.search(r"queue Q\d", text), path
        for n in re.findall(r"\bitem (\d+(?:\.\d+)?)", text):
            named.setdefault(n, path)
    assert set(named) <= listed, {n: str(p) for n, p in named.items()
                                  if n not in listed}
