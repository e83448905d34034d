"""BENCHMARK.json against the benchmark's contract, and every name in it
found as a file of its own under benchmark/."""

import json
import re

import pytest

from benchmark import core

MAN = core.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


def test_benchmark_top_level_keys():
    assert set(MAN) == KEYS
    assert MAN["command"] == ["python3", "benchmark/run.py"]
    assert MAN["paths"] == ["benchmark"]
    assert 1 <= MAN["run_seconds"] <= 51
    assert len(json.dumps(MAN)) <= 64 * 1024


def test_benchmark_names_and_units():
    names = [c["name"] for c in MAN["configs"]] \
        + [w["name"] for w in MAN["workloads"]] \
        + [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    for n in names:
        assert NAME.match(n), n
    assert len(set(w["name"] for w in MAN["workloads"])) == \
        len(MAN["workloads"])
    metric_names = [m["name"] for m in MAN["end_to_end"] + MAN["per_layer"]]
    assert len(set(metric_names)) == len(metric_names)
    for m in MAN["end_to_end"] + MAN["per_layer"]:
        assert UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher")


def test_benchmark_entry_keys():
    for c in MAN["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert 1 <= len(c["why"]) <= 200
        assert 1 <= len(c["source"]) <= 200 and "\n" not in c["source"]
    for w in MAN["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for m in MAN["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in MAN["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_benchmark_cells_report_what_they_must():
    e2e = {m["name"]: m for m in MAN["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for w in MAN["workloads"]:
        own = [m["name"] for m in core.metrics_of(MAN, w["name"],
                                                  "end_to_end")]
        assert "setup_s" in own and len(own) >= 2, w["name"]
        layer = core.metrics_of(MAN, w["name"], "per_layer")
        assert layer, w["name"]
        for m in layer:
            # the end-to-end metric a per-layer metric moves is reported
            # in every cell that reports the per-layer metric
            assert m["moves"] in own, (w["name"], m["name"])
    used = {w["config"] for w in MAN["workloads"]}
    assert used == {c["name"] for c in MAN["configs"]}


@pytest.mark.parametrize("w", MAN["workloads"], ids=lambda w: w["name"])
def test_benchmark_cell_files_found_by_name(w):
    conf = core.config(MAN, w["config"])
    assert conf["name"] == w["config"]
    entry = next(c for c in MAN["configs"] if c["name"] == w["config"])
    assert entry["file"].startswith("benchmark/configs/")
    assert entry["reduced"] == conf["reduced"] == []
    assert conf["source"] == entry["source"]
    system = core.system(conf["system"])
    assert callable(core.reference(conf["reference"]).Reference)
    system.layout(conf)
    tf = core.traffic(w["traffic"])
    assert callable(system.ENTRIES[tf["entry"]])
    assert hasattr(core.generator(tf["generator"]), "make_pool")
    lim = core.limits(w["name"])
    assert set(lim) == {"loss_gap", "grad_gap", "change_gap"}
    for m in core.metrics_of(MAN, w["name"], "per_layer"):
        assert callable(core.metric_reader(m["name"]).read)


def test_benchmark_unknown_names_raise():
    with pytest.raises(KeyError):
        core.cell(MAN, "no_such_cell")
    with pytest.raises(KeyError):
        core.config(MAN, "no_such_config")
    with pytest.raises(FileNotFoundError):
        core.traffic("no_such_traffic")
    with pytest.raises(FileNotFoundError):
        core.metric_reader("no_such_metric")
    with pytest.raises(FileNotFoundError):
        core.system("no_such_system")
    with pytest.raises(FileNotFoundError):
        core.reference("no_such_reference")


def test_benchmark_kaggle_vocabularies():
    kag = core.config(MAN, "dlrm_kaggle_cafe")
    assert sum(kag["counts"]) == 33_762_577
