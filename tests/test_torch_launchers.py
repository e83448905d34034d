"""The port's dataset launchers (bench/*_torch.sh) and smoke matrices
(tools/smoke_matrix*_torch.sh) against the JAX package's: the same flags,
`$1` and DATA conventions and cases, each parsing through main_torch.py's
parser to the Config that main.py's parser gives; and the gloo launcher
the sharded matrix starts its ranks with (tests/torch_dist_worker.py)."""

import dataclasses
import re
import shlex
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from cafe_tpu.config import parse_args as jparse
from cafe_tpu_torch.config import parse_args as tparse

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
BENCH = ["avazu", "criteo_kaggle", "criteo_terabyte", "dcn", "kdd12", "wdl"]
EXTRA = "--compress_method cafe --compress_rate 0.001"


def _launcher(path):
    """(script, flags, DATA default, takes $1) of a bench launcher."""
    text = path.read_text()
    cmd = text[text.index("python "):text.index("$dlrm_extra_option 2>&1")]
    words = shlex.split(cmd.replace("\\\n", " "))
    data = re.search(r"DATA=\$\{DATA:-([^}]*)\}", text).group(1)
    return (words[1], words[2:], data,
            "dlrm_extra_option=${1:-}" in text)


def _same_config(flags):
    want, got = jparse(flags), tparse(flags)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    return got


@pytest.mark.parametrize("name", BENCH)
def test_bench_launcher_carries_the_jax_flags(name):
    jscript, jflags, jdata, jextra = _launcher(REPO / "bench" / f"{name}.sh")
    tscript, tflags, tdata, textra = _launcher(
        REPO / "bench" / f"{name}_torch.sh")
    assert (jscript, tscript) == ("main.py", "main_torch.py")
    assert tflags == jflags and tdata == jdata and jextra and textra
    flags = [f.replace("$DATA", "/data/x") for f in tflags]
    for extra in ([], EXTRA.split()):
        cfg = _same_config(flags + extra)
        assert cfg.data_path == "/data/x"
    text = (REPO / "bench" / f"{name}_torch.sh").read_text()
    assert "rc=${PIPESTATUS[0]}" in text and text.rstrip().endswith(
        "exit $rc")


def _matrix(path):
    """(BASE flags, {case: flags}) of a smoke-matrix script."""
    text = path.read_text()
    base = re.search(r'^BASE="([^"]*)"', text, re.M).group(1).split()
    cases = dict(re.findall(r'^\s+"([^"|]+)\|([^"]*)"', text, re.M))
    return base, cases


MATRICES = [("smoke_matrix", "smoke_matrix_torch"),
            ("smoke_matrix_sharded", "smoke_matrix_sharded_torch")]
CASES = [(j, t, c) for j, t in MATRICES
         for c in _matrix(REPO / "tools" / f"{j}.sh")[1]]


@pytest.mark.parametrize("jax_name,torch_name,case", CASES,
                         ids=[c for _, _, c in CASES])
def test_smoke_case_parses_to_the_jax_config(jax_name, torch_name, case):
    jbase, jcases = _matrix(REPO / "tools" / f"{jax_name}.sh")
    tbase, tcases = _matrix(REPO / "tools" / f"{torch_name}.sh")
    assert tbase == jbase and list(tcases) == list(jcases)
    assert tcases[case] == jcases[case]
    _same_config(tbase + tcases[case].split())


def test_smoke_matrix_flows_match_the_jax_script():
    def body(name):
        text = (REPO / "tools" / f"{name}.sh").read_text()
        return text[text.index("cd \"$(dirname"):]
    want = body("smoke_matrix").replace(
        "python main.py", "python main_torch.py").replace(
        "cafe_tpu.data.preprocess", "cafe_tpu_torch.data.preprocess")
    assert body("smoke_matrix_torch") == want
    assert len(_matrix(REPO / "tools" / "smoke_matrix_torch.sh")[1]) == 15
    sharded = (REPO / "tools" / "smoke_matrix_sharded_torch.sh").read_text()
    assert "python tests/torch_dist_worker.py --world 8 -- $BASE $flags" \
        in sharded
    assert len(_matrix(REPO / "tools" / "smoke_matrix_sharded.sh")[1]) == 10


def test_dist_worker_runs_main_torch_on_gloo_ranks():
    flags = ["--force_platform", "cpu", "--dataset", "synthetic",
             "--synthetic_rows", "1024", "--synthetic_fields", "4",
             "--synthetic_vocab", "5000", "--embedding_dim", "8",
             "--mini_batch_size", "128", "--print_freq", "4",
             "--test_freq", "0", "--mesh_shape", "2",
             "--shard_embeddings", "true", "--compress_method", "cafe",
             "--compress_rate", "0.05", "--tensor_board_filename", ""]
    out = subprocess.run(
        [sys.executable, "tests/torch_dist_worker.py", "--world", "2",
         "--", *flags], cwd=REPO, capture_output=True, text=True,
        timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "explicit exchange on" in out.stdout
    assert "Finished training it 7/7" in out.stdout
    bad = subprocess.run(
        [sys.executable, "tests/torch_dist_worker.py", "--world", "2",
         "--", *flags, "--compress_method", "nonesuch"], cwd=REPO,
        capture_output=True, text=True, timeout=300)
    assert bad.returncode == 1
