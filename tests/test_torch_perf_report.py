"""tools/perf_report_torch.py (the port's digest of a card run) against
tools/perf_report.py, the JAX tool, on the CPU.

* the same records built both ways (bench.txt, step_breakdown.txt and
  ab_decisions.txt for the JAX tool; chip_smoke.jsonl lines and the same
  bench.txt for the twin) give equal headline and decision lines and the
  same eager stage budget;
* the clock reads VALID under the card's bf16 peak (989 TFLOP/s, the
  clock probe's) and prints the WARNING over it; the JAX tool's TPU peak
  (260) appears nowhere;
* the graphed headline's ms a step is the headline_graph record's;
* SUMMARY.md is what was printed; a missing record leaves its section
  out; a malformed chip_smoke.jsonl line raises.
"""

import contextlib
import importlib.util
import io
import json
import re
import sys
from pathlib import Path

import pytest
import torch

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]


def _load(name):
    spec = importlib.util.spec_from_file_location(
        name, REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


twin = _load("perf_report_torch")

BENCH = {"metric": "train_examples_per_s", "value": 741317.5,
         "unit": "examples/s", "window_min": 738455.1,
         "window_max": 743709.9, "windows": 5, "mfu": 0.0031,
         "flops_per_example": 1487872, "vs_baseline": 5.11}
DECISIONS = [
    {"decision": "donate_state", "median_us_per_step":
     {"donate_on": 17210.4, "donate_off": 18301.9}, "ratio": 1.063,
     "note": "eager step, dim 16"},
    {"decision": "migration_lane_cap", "median_us_per_step":
     {"cap_256": 21733.2, "cap_huge": 22917.5}, "ratio": 1.054,
     "note": "dim 128"},
    {"decision": 4, "error": "RuntimeError('out of memory')"}]
EAGER = {"cafe": 15776.7, "cafe_fwd": 1400.0, "cafe_iv8": 9089.5,
         "cafe_iv8_fwd": 1592.9, "hash": 6826.7, "hash_fwd": 1522.5,
         "full": 6366.4, "full_fwd": 1544.7}
GRAPHED = {"cafe": 2737.3, "cafe_fwd": 476.8, "hash": 1021.7,
           "hash_fwd": 288.9, "full": 1020.8, "full_fwd": 288.4}
TB = {"cafe": 15707.6, "cafe_fwd": 2205.2, "hash": 6410.6,
      "hash_fwd": 1425.8}


def _records(top_rate=769.3):
    return [
        {"phase": "device", "nvidia_smi": "NVIDIA H100 80GB HBM3, 700.00 W",
         "device": "NVIDIA H100 80GB HBM3"},
        {"phase": "headline_graph", "graphed_ms_per_step": 2.7628091,
         "eager_ms_per_step": 19.038342, "speedup": 6.89,
         "graphed_window_ms": [2.7537, 2.7628091, 2.7735],
         "steps_per_window": 20},
        {"phase": "step_breakdown",
         "criteo": {"eager": EAGER, "graphed": GRAPHED,
                    "not_graphed": {"cafe_iv8": ["tick"]}},
         "criteotb": {"eager": TB, "graphed": {}}},
        {"phase": "probes", "clock_probe": {
            "tflops": {"scan_host_sync": [737.2, 741.9],
                       "scan_cuda_events": [744.0, top_rate],
                       "chain_host_sync": [738.5, 742.1]},
            "max_share_of_peak": top_rate / 989.0}},
        {"phase": "ab_decisions", "decisions": [
            {**d, "launches": {"land_max": 100}} for d in DECISIONS]}]


def _write(path, recs, bench=True):
    path.mkdir(parents=True, exist_ok=True)
    with open(path / "chip_smoke.jsonl", "w") as f:
        for r in recs:
            f.write(json.dumps({**r, "elapsed_s": 1.5}) + "\n")
    if bench:
        (path / "bench.txt").write_text(
            "windows ...\n" + json.dumps(BENCH) + "\n")


def _jax_digest(path, monkeypatch):
    """tools/perf_report.py over the same records in its own files."""
    path.mkdir(parents=True)
    (path / "bench.txt").write_text("windows ...\n" + json.dumps(BENCH)
                                    + "\n")
    (path / "ab_decisions.txt").write_text(
        "".join(json.dumps(d) + "\n" for d in DECISIONS))
    (path / "step_breakdown.txt").write_text("".join(
        f"{k:12s} {v:8.1f} us/step  ({2048 / v:.1f}M ex/s)\n"
        for k, v in EAGER.items()))
    jtool = _load("perf_report")
    monkeypatch.setattr(sys, "argv", ["perf_report.py", str(path)])
    with contextlib.redirect_stdout(io.StringIO()) as out:
        jtool.main()
    return out.getvalue()


def _section(text, head):
    """The lines of the section whose heading starts with `head`."""
    lines = text.splitlines()
    i = next(k for k, ln in enumerate(lines) if ln.startswith(head))
    end = next((k for k in range(i + 1, len(lines))
                if lines[k].startswith("## ")), len(lines))
    return [ln for ln in lines[i + 1:end] if ln.strip()]


def test_headline_and_decisions_equal_the_jax_tool(tmp_path, monkeypatch):
    want = _jax_digest(tmp_path / "jax", monkeypatch)
    _write(tmp_path / "port", _records())
    got = twin.digest(str(tmp_path / "port"))
    assert _section(got, "## Headline (bench") == \
        _section(want, "## Headline (bench")
    assert _section(got, "## Perf decisions") == \
        _section(want, "## Round-2 perf decisions")
    assert len(_section(got, "## Perf decisions")) == 3
    # the JAX table's eager rows are the twin's first column
    jrows = [r for r in _section(want, "## Stage budget — dim 16")
             if r.startswith("| ") and "us/step" not in r]
    trows = [r for r in _section(got, "## Stage budget — dim 16")
             if r.startswith("| ") and "us/step" not in r]
    assert [r.split(" | ")[:2] for r in trows] == \
        [r.rstrip(" |").split(" | ") for r in jrows]


def test_clock_valid_and_graph_headline(tmp_path):
    _write(tmp_path, _records(), bench=False)
    text = twin.main([str(tmp_path)])
    assert "clock VALID" in text and "WARNING" not in text
    assert "card: NVIDIA H100 80GB HBM3, 700.00 W" in text
    assert "260" not in text
    ms = float(re.search(r"\*\*([0-9.]+) ms a step\*\*", text).group(1))
    assert ms == _records()[1]["graphed_ms_per_step"]
    assert "## Headline (bench" not in text
    assert "| cafe_iv8 | 9089.5 | not graphed |" in text
    assert "## Stage budget — dim 128" in text
    assert (tmp_path / "SUMMARY.md").read_text() == text


def test_clock_over_the_peak_warns(tmp_path):
    _write(tmp_path, _records(top_rate=1001.7))
    text = twin.digest(str(tmp_path))
    assert "**WARNING: a TFLOP/s rate (1001.7) exceeds" in text
    assert "VALID" not in text and "260" not in text
    assert twin.BF16_PEAK_TFLOPS == \
        _load("clock_probe_torch").BF16_PEAK_TFLOPS


def test_missing_records_leave_sections_out(tmp_path):
    _write(tmp_path, [r for r in _records()
                      if r["phase"] in ("device", "ab_decisions")],
           bench=False)
    text = twin.digest(str(tmp_path))
    heads = [ln for ln in text.splitlines() if ln.startswith("#")]
    assert heads == ["# Honest-clock re-measurement digest",
                     "## Perf decisions, re-validated (interleaved "
                     "windows)"]
    assert twin.digest(str(tmp_path / "none")).startswith("# Honest")


@pytest.mark.parametrize("line", ["{\"phase\": \"probes\", ", "[1, 2]"])
def test_malformed_line_raises(tmp_path, line):
    _write(tmp_path, _records(), bench=False)
    with open(tmp_path / "chip_smoke.jsonl", "a") as f:
        f.write(line + "\n")
    with pytest.raises(ValueError, match="chip_smoke.jsonl:6"):
        twin.digest(str(tmp_path))
