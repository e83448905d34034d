"""The port's measurement tools on the CPU at small shapes:
cafe_tpu_torch/tools/roofline.py against the JAX roofline's JSON,
tools/ab_decisions_torch.py against the JAX tool's report lines, and
tools/ab_insert_land_torch.py's equal-state check."""

import contextlib
import functools
import importlib.util
import io
import json
from pathlib import Path

import pytest
import torch

from cafe_tpu.tools import roofline as jroofline
from cafe_tpu_torch.tools import roofline as troofline

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def ab():
    return _load("ab_decisions_torch")


def _printed_json(fn, *args):
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        ret = fn(*args)
    return ret, buf.getvalue()


SMALL = ["--rows", "4096", "--iters", "3", "--batch", "64", "--fields", "4",
         "--dim", "16"]


def test_roofline_prints_the_jax_tools_keys():
    _, jout = _printed_json(jroofline.main, SMALL)
    ret, tout = _printed_json(troofline.main, SMALL + ["--device", "cpu"])
    want, got = json.loads(jout), json.loads(tout)
    assert got == ret
    # the port adds the device the numbers were taken on
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for k, v in want.items():
        if isinstance(v, dict):
            assert set(got[k]) == set(v), k
    assert got["shapes"] == want["shapes"]
    assert got["peak_gbs"] == troofline.DEFAULT_PEAK_GBS == 3350.0
    assert got["sync"] == troofline.SYNC_CPU
    for stage in ("lookup", "optimizer_apply", "optimizer_scatter",
                  "sketch_query", "sketch_insert"):
        assert got[stage]["ms"] > 0


def test_roofline_refuses_a_missing_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        troofline.main(SMALL)


REPORT_KEYS = {"decision", "median_us_per_step", "window_spread_us",
               "ratio", "note"}


def test_report_keys_match_the_jax_tool(ab):
    jab = _load("ab_decisions")
    us = {"a": [1.0, 2.0, 3.0], "b": [2.0, 4.0, 6.0]}
    want, _ = _printed_json(jab.report, "x", us, "n")
    got, printed = _printed_json(ab.report, "x", us, "n")
    assert got == want and set(got) == REPORT_KEYS
    assert json.loads(printed) == got


def test_decision_sortless_insert_small(ab):
    line, _ = _printed_json(functools.partial(
        ab.decision_sortless_insert, 2, steps=2, device="cpu",
        buckets=1024, lanes=2048, n_batches=2))
    assert set(line) == REPORT_KEYS and line["decision"] == "sortless_insert"
    assert set(line["median_us_per_step"]) == {"sortless", "sorted"}


def test_decision_pallas_gather_small(ab):
    from cafe_tpu_torch.kernels import gather
    before = gather.KERNEL.launches
    line, _ = _printed_json(functools.partial(
        ab.decision_pallas_gather, 2, steps=3, device="cpu", rows=4096,
        dim=16, lanes=512, tile=32))
    assert set(line) == REPORT_KEYS and line["decision"] == "pallas_gather"
    assert set(line["median_us_per_step"]) == {"torch_gather",
                                               "pallas_gather"}
    assert gather.KERNEL.launches == before      # CPU: the plain version


def test_a_failing_decision_fails_the_tool(ab, monkeypatch):
    def boom(*a, **k):
        raise RuntimeError("boom")

    small = functools.partial(ab.decision_pallas_gather, rows=4096, dim=16,
                              lanes=512, tile=32)
    monkeypatch.setitem(ab.DECISIONS, 3, boom)
    monkeypatch.setitem(ab.DECISIONS, 4, small)
    rc, out = _printed_json(ab.main, ["--decisions", "3", "4", "--windows",
                                      "1", "--steps", "1", "--device",
                                      "cpu"])
    lines = [json.loads(ln) for ln in out.splitlines()]
    assert rc == 1
    assert lines[0] == {"decision": 3, "error": "RuntimeError('boom')"}
    assert lines[1]["decision"] == "pallas_gather"   # the next one ran
    rc, _ = _printed_json(ab.main, ["--decisions", "4", "--windows", "1",
                                    "--steps", "1", "--device", "cpu"])
    assert rc == 0


def test_ab_insert_land_arms_give_equal_states():
    land = _load("ab_insert_land_torch")
    from cafe_tpu_torch.kernels import land as k1
    before = k1.KERNEL.launches
    args = land.parse_args(["--device", "cpu", "--lanes", "2048",
                            "--buckets", "512", "--windows", "1",
                            "--steps", "2", "--skip_level2"])
    records, _ = _printed_json(land.run, args)
    assert records[0]["level"] == "insert_us"
    assert set(records[0]["windows"]) == set(land.IMPLS)
    eq = records[1:]
    assert [r["impl"] for r in eq] == land.IMPLS[1:]
    assert all(r["level"] == "equal_state" and r["equal"] for r in eq)
    assert k1.KERNEL.launches == before
    rc, _ = _printed_json(land.main, ["--device", "cpu", "--lanes", "1024",
                                      "--buckets", "256", "--windows", "1",
                                      "--steps", "1", "--skip_level2"])
    assert rc == 0


def test_ab_insert_land_fails_when_an_arm_differs(monkeypatch):
    land = _load("ab_insert_land_torch")
    from cafe_tpu_torch.sketch import hotsketch
    real = hotsketch.sketch_insert

    def off_by_one(cfg, st, ids, sc):
        st, res = real(cfg, st, ids, sc)
        if cfg.land_impl == "scan":
            st = {**st, "tot": st["tot"] + 1.0}
        return st, res

    monkeypatch.setattr(hotsketch, "sketch_insert", off_by_one)
    rc, out = _printed_json(land.main, ["--device", "cpu", "--lanes", "1024",
                                        "--buckets", "256", "--windows", "1",
                                        "--steps", "1", "--skip_level2"])
    lines = [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]
    assert rc == 1
    assert {"level": "equal_state", "impl": "scan", "equal": False} in lines
    assert "scan" in lines[-1]["error"]


def test_sketch_bench_matches_the_jax_tool():
    """tools/sketch_bench_torch.py against cafe_tpu/tools/sketch_bench.py
    at a small stream: the same document (plus "device"); the recall of
    v1 and CAFE+, the droop sweep and the drift points are EQUAL (the
    sketches are exact ports and the scores are ones); throughput is
    each one's own clock."""
    from cafe_tpu.tools import sketch_bench as jbench
    tbench = _load("sketch_bench_torch")
    argv = ["--stream_len", "12000", "--vocab", "3000", "--buckets", "128",
            "--threshold", "6", "--batch", "512", "--cells", "4", "8",
            "--rounds_sweep"]
    _, jout = _printed_json(jbench.main, argv)
    ret, tout = _printed_json(tbench.main, argv + ["--device", "cpu"])
    want, got = json.loads(jout), json.loads(tout)
    assert got == json.loads(json.dumps(ret))
    assert set(got) == set(want) | {"device"} and got["device"] == "cpu"
    for k in ("recall", "recall_plus", "rounds_sweep", "drift"):
        assert got[k] == want[k], k
    assert got["recall_plus"]["cells4"]["hot"] > 0
    assert set(got["throughput"]) == set(want["throughput"])
    assert all(v > 0 for v in got["throughput"].values())
