"""Nothing the benchmark runs imports JAX or the JAX package: every module
a run loads, compared by its whole top-level name (cafe_tpu_torch, the
port, is not cafe_tpu)."""

import ast
import json
import subprocess
import sys
from pathlib import Path

from benchmark import run

HERE = Path(__file__).resolve().parents[1]
ROOT = HERE.parent

LOAD_ALL = """
import json, sys
sys.argv = ["run.py"]
import benchmark.run as run
from benchmark import cell, core  # noqa: F401
man = core.manifest()
for c in man["configs"]:
    conf = core.config(man, c["name"])
    core.system(conf["system"])
    core.reference(conf["reference"])
for w in man["workloads"]:
    core.generator(core.traffic(w["traffic"])["generator"])
for m in man["per_layer"]:
    core.metric_reader(m["name"])
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""


def test_benchmark_a_run_loads_no_jax():
    out = subprocess.run([sys.executable, "-c", LOAD_ALL], cwd=ROOT,
                         capture_output=True, text=True, check=True)
    tops = set(json.loads(out.stdout.strip().splitlines()[-1]))
    assert "cafe_tpu_torch" in tops and "torch" in tops
    assert not tops & set(run.FORBIDDEN), tops & set(run.FORBIDDEN)


def test_benchmark_sources_import_no_jax():
    for path in HERE.rglob("*.py"):
        tree = ast.parse(path.read_text())
        for node in ast.walk(tree):
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module]
            for n in names:
                assert n.split(".")[0] not in run.FORBIDDEN, (path, n)


def test_benchmark_forbidden_names_compare_whole():
    saved = dict(sys.modules)
    try:
        sys.modules.pop("cafe_tpu", None)
        sys.modules["cafe_tpu_torch"] = saved.get("cafe_tpu_torch", sys)
        assert "cafe_tpu" not in run.forbidden_modules()
        sys.modules["cafe_tpu.config"] = sys
        assert run.forbidden_modules() == ["cafe_tpu"]
    finally:
        sys.modules.clear()
        sys.modules.update(saved)


def test_benchmark_reference_imports_nothing_of_the_port():
    for path in (HERE / "reference").rglob("*.py"):
        assert "cafe_tpu" not in path.read_text(), path
