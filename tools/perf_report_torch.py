#!/usr/bin/env python3
"""Render a markdown digest of a card run, for the PyTorch / CUDA port
(cafe_tpu_torch; no jax). Port of tools/perf_report.py.

The JAX tool parses clock_probe.txt, bench.txt, step_breakdown*.txt and
ab_decisions.txt. The port's card run (chip_smoke.py) appends one JSON
line a phase to chip_smoke.jsonl; this reads from it:

  device          the card's name and power limit (nvidia-smi)
  probes          clock_probe's TFLOP/s: the clock is VALID when no rate
                  exceeds the card's bf16 peak (989 TFLOP/s, H100 SXM at
                  700 W; tools/clock_probe_torch.py), else a WARNING
  headline_graph  the graphed headline train step: ms a step, its
                  windows, examples/s (2048 / step time)
  step_breakdown  the stage budgets at dim 16 and at dim 128 (CriteoTB
                  towers on Kaggle's vocabularies), eager and graphed
  ab_decisions    one line a decision, as the JAX tool's (an error too)

and a bench.txt whose JSON line has bench.py's keys, read as the JAX tool
reads it. A missing record leaves its section out; a malformed line of
chip_smoke.jsonl raises. Prints the digest and writes SUMMARY.md beside
the records.

    python3 tools/perf_report_torch.py [chiprun_out]
"""

from __future__ import annotations

import argparse
import json
import os.path as osp
import re
from typing import Dict, List

BF16_PEAK_TFLOPS = 989.0    # tools/clock_probe_torch.py: H100 SXM, 700 W
BATCH = 2048                # bench.py:78, the headline's batch
BREAKDOWNS = (("criteo", "Stage budget — dim 16"),
              ("criteotb", "Stage budget — dim 128 (CriteoTB towers on "
                           "Kaggle vocabularies)"))


def read(path: str) -> str:
    try:
        with open(path) as f:
            return f.read()
    except OSError:
        return ""


def read_records(out: str) -> Dict[str, List[dict]]:
    """chip_smoke.jsonl's records by phase, in order ({} without the
    file). A line that is not a JSON object raises ValueError."""
    path = osp.join(out, "chip_smoke.jsonl")
    recs: Dict[str, List[dict]] = {}
    for i, line in enumerate(read(path).splitlines(), 1):
        if not line.strip():
            continue
        try:
            rec = json.loads(line)
        except ValueError as e:
            raise ValueError(f"{path}:{i}: malformed line: {e}") from None
        if not isinstance(rec, dict):
            raise ValueError(f"{path}:{i}: not a JSON object: {line[:80]}")
        recs.setdefault(rec.get("phase", ""), []).append(rec)
    return recs


def clock_section(w, probes: dict, device: dict) -> None:
    clk = probes["clock_probe"]
    w(f"## Clock probe (must be <= the card's bf16 peak, "
      f"{BF16_PEAK_TFLOPS:g} TFLOP/s)\n")
    if device.get("nvidia_smi"):
        w(f"card: {device['nvidia_smi']}\n")
    w("```")
    for name, rates in clk["tflops"].items():
        w(f"{name:24s}: {min(rates):8.1f} - {max(rates):8.1f} TFLOP/s")
    w("```")
    top = max(max(r) for r in clk["tflops"].values())
    if top <= BF16_PEAK_TFLOPS:
        w(f"\nTFLOP/s rates are physically possible (at most {top:.1f}) — "
          f"clock VALID.\n")
    else:
        w(f"\n**WARNING: a TFLOP/s rate ({top:.1f}) exceeds the card's "
          f"peak — do not trust the numbers below.**\n")


def bench_section(w, bench: str) -> None:
    """bench.txt's JSON line, as tools/perf_report.py:46-59 renders it."""
    m = re.search(r"\{.*\"metric\".*\}", bench)
    if not m:
        return
    try:
        j = json.loads(m.group(0))
        w("## Headline (bench.txt)\n")
        w(f"- **{j.get('value'):,.0f} {j.get('unit')}** "
          f"(window band {j.get('window_min'):,.0f}–"
          f"{j.get('window_max'):,.0f}, {j.get('windows')} windows)")
        w(f"- MFU {j.get('mfu')} at {j.get('flops_per_example'):,.0f} "
          f"FLOP/example; {j.get('vs_baseline')}x the reference "
          f"protocol baseline\n")
    except (ValueError, TypeError):
        w("## Headline (bench.txt)\n```\n" + bench.strip() + "\n```\n")


def graph_section(w, rec: dict) -> None:
    ms = rec["graphed_ms_per_step"]
    win = rec["graphed_window_ms"]
    w("## Headline (chip_smoke.py headline_graph: the graphed train "
      "step)\n")
    w(f"- **{ms!r} ms a step**, {BATCH * 1e3 / ms:,.0f} examples/s "
      f"({BATCH} / step time); {len(win)} windows of "
      f"{rec['steps_per_window']} steps, {min(win)!r}–{max(win)!r} ms")
    w(f"- eager {rec['eager_ms_per_step']!r} ms a step, in windows "
      f"alternating with the graphed ones (graphed {rec['speedup']:.2f}x "
      f"faster)\n")


def breakdown_section(w, rec: dict) -> None:
    for shapes, title in BREAKDOWNS:
        res = rec.get(shapes)
        if not res:
            continue
        modes = [m for m in ("eager", "graphed") if res.get(m)]
        w(f"## {title}\n")
        w("| step | " + " | ".join(f"{m} us/step" for m in modes) + " |")
        w("|---|" + "---|" * len(modes))
        for arm in res[modes[0]]:
            cells = [f"{res[m][arm]:.1f}" if arm in res[m] else "not graphed"
                     for m in modes]
            w(f"| {arm} | " + " | ".join(cells) + " |")
        w("")
        for m in modes:
            r = res[m]
            if "cafe" in r and "hash" in r:
                ov = r["cafe"] - r["hash"]
                w(f"{m}: sketch+migration overhead: {ov:.1f} us "
                  f"({ov / r['cafe'] * 100:.0f}% of cafe step)")
            if "cafe_iv8" in r and "hash" in r:
                ov = r["cafe_iv8"] - r["hash"]
                w(f"{m}:   at the bench protocol (insert_interval=8): "
                  f"{ov:.1f} us ({ov / r['cafe_iv8'] * 100:.0f}% of cafe "
                  f"step)")
        w("")


def decisions_section(w, decisions: List[dict]) -> None:
    """One line a decision, as tools/perf_report.py:77-96."""
    w("## Perf decisions, re-validated (interleaved windows)\n")
    for d in decisions:
        if "error" in d:
            w(f"- **{d.get('decision')}**: ERROR {d['error']}")
            continue
        meds = d.get("median_us_per_step", {})
        parts = ", ".join(f"{k} {v:,.1f}us" for k, v in meds.items())
        w(f"- **{d['decision']}** ({d.get('note', '')}): {parts} — "
          f"ratio {d.get('ratio')}")
    w("")


def digest(out: str) -> str:
    """The digest of the records in `out`."""
    recs = read_records(out)

    def last(phase):
        return recs[phase][-1] if phase in recs else None

    lines: List[str] = []
    w = lines.append
    w("# Honest-clock re-measurement digest\n")
    probes = last("probes")
    if probes and "clock_probe" in probes:
        clock_section(w, probes, last("device") or {})
    bench_section(w, read(osp.join(out, "bench.txt")))
    if last("headline_graph"):
        graph_section(w, last("headline_graph"))
    if last("step_breakdown"):
        breakdown_section(w, last("step_breakdown"))
    if last("ab_decisions"):
        decisions_section(w, last("ab_decisions")["decisions"])
    return "\n".join(lines) + "\n"


def main(argv=None) -> str:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("out", nargs="?", default="chiprun_out",
                    help="the directory of chip_smoke.jsonl (and bench.txt)")
    args = ap.parse_args(argv)
    text = digest(args.out)
    print(text)
    with open(osp.join(args.out, "SUMMARY.md"), "w") as f:
        f.write(text)
    return text


if __name__ == "__main__":
    main()
