"""On the card: each cell runs at its own size, comes out correct, and its
control and planted faults fail its limits. Run on a machine with an
NVIDIA card:

    python3 -m pytest -q -m cuda benchmark/tests/test_benchmark_card.py
"""

import json
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import check, core

ROOT = Path(__file__).resolve().parents[2]
MAN = core.manifest()


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in MAN["workloads"]])
def test_benchmark_cell_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "benchmark/run.py", "--workload", cell, "--seed",
         "2718281828", "--seconds", "3", "--trace", "1", "--readings", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["busy_s"] > 0
    limits = core.limits(cell)
    for name, numbers in res["readings"].items():
        compared = {k: v for k, v in numbers.items() if k in limits}
        assert not check.judge(compared, limits), (name, numbers)
