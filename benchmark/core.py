"""Finding a cell's pieces by the names BENCHMARK.json gives them.

- a configuration: configs[].file, a JSON file under benchmark/configs/;
- a traffic mix: benchmark/traffic/<traffic>.json, a data file naming its
  generator, benchmark/traffic/<generator>.py;
- a per-layer metric: benchmark/metrics/<metric>.py, whose read(ctx)
  returns a number, or None when the run holds nothing it reads;
- a cell's limits: benchmark/limits/<cell>.json;
- a configuration's system under test: benchmark/systems/<system>.py
  (the only modules that import the port), named by the configuration
  file's "system"; it owns the layout, the entries the windows drive and
  the devices it uses;
- a configuration's plain reference: benchmark/reference/<reference>.py,
  named by the configuration file's "reference".
Nothing here imports the port.
"""

from __future__ import annotations

import importlib
import importlib.util
import json
from pathlib import Path
from typing import Dict, List, Optional

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent
MANIFEST = ROOT / "BENCHMARK.json"


def load_json(path: Path) -> Dict:
    with open(path) as f:
        return json.load(f)


def manifest(path: Path = MANIFEST) -> Dict:
    return load_json(path)


def cell(man: Dict, name: str) -> Dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(man: Dict, name: str) -> Dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(ROOT / c["file"])
    raise KeyError(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> Dict:
    return load_json(HERE / "traffic" / f"{name}.json")


def limits(cell_name: str) -> Dict[str, float]:
    return load_json(HERE / "limits" / f"{cell_name}.json")


def _module(path: Path, name: str):
    if not path.is_file():
        raise FileNotFoundError(path)
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _package_module(package: str, name: str):
    """benchmark/<package>/<name>.py, imported as a module of the
    benchmark package (it may import its siblings)."""
    if not (HERE / package / f"{name}.py").is_file():
        raise FileNotFoundError(HERE / package / f"{name}.py")
    return importlib.import_module(f"benchmark.{package}.{name}")


def system(name: str):
    return _package_module("systems", name)


def reference(name: str):
    return _package_module("reference", name)


def generator(name: str):
    return _module(HERE / "traffic" / f"{name}.py", f"bench_traffic_{name}")


def metric_reader(name: str):
    return _module(HERE / "metrics" / f"{name}.py",
                   "bench_metric_" + name.replace(".", "_").replace("-", "_"))


def metrics_of(man: Dict, cell_name: str, kind: str) -> List[Dict]:
    """The end_to_end or per_layer metrics a cell reports."""
    return [m for m in man[kind]
            if cell_name in m.get("workloads", [cell_name])]


def read_per_layer(man: Dict, cell_name: str, ctx: Dict) -> Dict:
    """{name: {value, unit}} of the cell's per-layer metrics that found
    something to read."""
    out = {}
    for m in metrics_of(man, cell_name, "per_layer"):
        v = metric_reader(m["name"]).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def pick(values: Dict[str, Optional[float]], wanted: List[Dict]) -> Dict:
    """{name: {value, unit}} of the wanted metrics the run measured."""
    return {m["name"]: {"value": float(values[m["name"]]), "unit": m["unit"]}
            for m in wanted if values.get(m["name"]) is not None}
