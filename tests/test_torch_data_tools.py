"""The port's data and experiment tools (cafe_tpu_torch/data/preprocess.py,
cafe_tpu_torch/tools/{job_scheduler,gen_tasks,process_interactions,
visualization}.py) against the JAX package's, on the CPU.

Everything here is exact: the same raw text gives the same binary files
(the port's encoder and the JAX package's; the port's C++ NativeEncoder
and the JAX package's), the same events the same train.txt / test.txt,
the same task files the same tasks and errors, and the scheduler's argv
is the JAX one's with main_torch.py in place of main.py. A two-task grid
then runs end to end through main_torch.py on the CPU, and visualization
reads its boards.

The C++ NativeEncoder (native/encoder.cpp, shared by both packages) numbers
each field's tokens in first-seen order where the Python encoder sorts
them (sklearn LabelEncoder order): its counts, labels and dense floats
are byte-equal to the Python encoder's, and its sparse ids are the
Python ids relabelled in first-seen order, field by field
(`assert_first_seen_relabel`).
"""

import json
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from cafe_tpu import native as jnative
from cafe_tpu.data import preprocess as jprep
from cafe_tpu.tools import gen_tasks as jgen
from cafe_tpu.tools import job_scheduler as jsched
from cafe_tpu.tools import process_interactions as jinter
from cafe_tpu_torch import native
from cafe_tpu_torch.data import preprocess as tprep
from cafe_tpu_torch.tools import gen_tasks as tgen
from cafe_tpu_torch.tools import job_scheduler as tsched
from cafe_tpu_torch.tools import process_interactions as tinter
from cafe_tpu_torch.tools import visualization as tvis
from test_preprocess_parity import _write_fixture

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
OUTPUTS = ("processed_count.bin", "processed_label.bin",
           "processed_sparse_sep.bin", "processed_dense.bin")
TASK_FILES = sorted(str(p.relative_to(REPO)) for p in
                    list((REPO / "tasks").glob("*.json"))
                    + list((REPO / "tasks" / "sensitivity").glob("*.json")))


def _same_files(a: Path, b: Path, names):
    for name in names:
        assert (a / name).read_bytes() == (b / name).read_bytes(), name


def assert_first_seen_relabel(native_ids, sorted_ids):
    """Each field's native ids are 0, 1, 2, ... in order of first
    appearance, and map one to one onto the sorted encoder's ids."""
    for j in range(sorted_ids.shape[1]):
        nat, ref = native_ids[:, j], sorted_ids[:, j]
        first = np.unique(nat, return_index=True)[1]
        assert np.array_equal(np.sort(first), first), j
        assert np.array_equal(ref, ref[first][nat]), j
        assert len(np.unique(ref)) == len(first), j


def _native_encode(paths, out: Path, day_names=None):
    """NativeEncoder over `paths` (one shared vocabulary); with
    `day_names`, each path encoded into out/<day> (CriteoTB's days)."""
    enc = native.NativeEncoder(num_dense=13, num_sparse=26, sep="\t")
    for p in paths:
        enc.collect(str(p))
    for i, p in enumerate(paths):
        enc.encode(str(p), str(out / day_names[i] if day_names else out))
    return enc.counts()


def test_criteo_bytes_match_jax_and_native(tmp_path):
    raw = tmp_path / "train.txt"
    _write_fixture(str(raw))
    tprep.process_criteo(str(raw), str(tmp_path / "port"))
    jprep.process_criteo(str(raw), str(tmp_path / "jax"))
    _native_encode([raw], tmp_path / "native")
    _same_files(tmp_path / "port", tmp_path / "jax", OUTPUTS)
    enc = jnative.NativeEncoder(num_dense=13, num_sparse=26, sep="\t")
    enc.collect(str(raw))
    enc.encode(str(raw), str(tmp_path / "jax_native"))
    _same_files(tmp_path / "native", tmp_path / "jax_native", OUTPUTS)
    _same_files(tmp_path / "port", tmp_path / "native", OUTPUTS[:2] + (
        "processed_dense.bin",))
    assert_first_seen_relabel(*(np.fromfile(
        tmp_path / d / "processed_sparse_sep.bin", np.int32).reshape(-1, 26)
        for d in ("native", "port")))
    counts = np.fromfile(tmp_path / "port" / "processed_count.bin",
                         dtype=np.int32)
    assert counts.shape == (26,) and (counts > 1).all()


def test_criteotb_days_match_jax_and_native(tmp_path):
    days = []
    for d in range(3):
        days.append(tmp_path / f"day_{d}")
        _write_fixture(str(days[-1]), rows=3000, seed=d + 1)
    tprep.process_criteotb([str(p) for p in days], str(tmp_path / "port"))
    jprep.process_criteotb([str(p) for p in days], str(tmp_path / "jax"))
    names = ["processed_count.bin"] + [
        f"{k}_{d}{s}.bin" for d in range(3)
        for k, s in (("sparse", "_sep"), ("dense", ""), ("label", ""))]
    _same_files(tmp_path / "port", tmp_path / "jax", names)
    assert sorted(os.listdir(tmp_path / "port")) == sorted(
        os.listdir(tmp_path / "jax"))
    counts = _native_encode(days, tmp_path / "native",
                            [f"d{d}" for d in range(3)])
    assert counts.tobytes() == (tmp_path / "port" /
                                "processed_count.bin").read_bytes()
    nat, ref = [], []
    for d in range(3):
        for name in ("dense", "label"):
            assert (tmp_path / "port" / f"{name}_{d}.bin").read_bytes() == (
                tmp_path / "native" / f"d{d}" / f"processed_{name}.bin"
            ).read_bytes(), (d, name)
        nat.append(np.fromfile(tmp_path / "native" / f"d{d}" /
                               "processed_sparse_sep.bin", np.int32))
        ref.append(np.fromfile(tmp_path / "port" / f"sparse_{d}_sep.bin",
                               np.int32))
    # one vocabulary over the days: first seen across the days in order
    assert_first_seen_relabel(np.concatenate(nat).reshape(-1, 26),
                              np.concatenate(ref).reshape(-1, 26))


def test_preprocess_cli_matches(tmp_path):
    raw = tmp_path / "train.txt"
    _write_fixture(str(raw), rows=2000, seed=3)
    tprep.main(["--dataset", "criteo", "--input", str(raw), "--output",
                str(tmp_path / "port")])
    jprep.main(["--dataset", "criteo", "--input", str(raw), "--output",
                str(tmp_path / "jax")])
    _same_files(tmp_path / "port", tmp_path / "jax", OUTPUTS)
    with pytest.raises(SystemExit):
        tprep.main(["--dataset", "criteo", "--input", str(raw), str(raw),
                    "--output", str(tmp_path / "x")])


def _write_events(path, users=120, items=80, events=2500, seed=0):
    """(user, item, timestamp) rows with repeats, ties, blank cells and a
    user with a single event."""
    rng = np.random.default_rng(seed)
    with open(path, "w") as f:
        f.write("user_id,item_id,ts\n")
        for _ in range(events):
            u = int(rng.integers(0, users))
            i = int(rng.integers(0, items))
            t = int(rng.integers(0, 500))
            f.write(f"u{u},i{i},{t:08d}\n")
        f.write(",i3,00000001\n")
        f.write("lonely,i5,00000002\n")


@pytest.mark.parametrize("time_col,leave_n", [("ts", 1), ("ts", 3),
                                              ("", 2)])
def test_interactions_split_matches_jax(tmp_path, time_col, leave_n):
    events = tmp_path / "events.csv"
    _write_events(events)
    got = tinter.process(str(events), str(tmp_path / "port"), "user_id",
                         "item_id", time_col, leave_n)
    want = jinter.process(str(events), str(tmp_path / "jax"), "user_id",
                          "item_id", time_col, leave_n)
    assert got == want and got["users"] == 121
    _same_files(tmp_path / "port", tmp_path / "jax",
                ["train.txt", "test.txt"])
    with pytest.raises(ValueError, match="not in CSV header"):
        tinter.process(str(events), str(tmp_path / "x"), "user", "item_id")


@pytest.mark.parametrize("rel", TASK_FILES)
def test_load_tasks_matches_jax(rel):
    got = tsched.load_tasks(str(REPO / rel))
    assert got == jsched.load_tasks(str(REPO / rel)) and got


@pytest.mark.parametrize("section,match", [
    (["compress_rate", 0.1], "must be an object"),
    ({"cafe_sketch_threshold": [1, 2], "cafe_hash_rate": [0.1, 0.2]},
     "without compress_rate"),
    ({"compress_rate": [0.1, 0.2], "cafe_hash_rate": [0.5]},
     "mismatched lengths")])
def test_load_tasks_errors_match_jax(tmp_path, section, match):
    path = tmp_path / "bad.json"
    path.write_text(json.dumps({"base": {"dataset": "criteo"},
                                "cafe": section}))
    errors = []
    for load in (tsched.load_tasks, jsched.load_tasks):
        with pytest.raises(ValueError, match=match) as e:
            load(str(path))
        errors.append(str(e.value))
    assert errors[0] == errors[1]


def test_every_task_key_is_a_port_flag():
    from cafe_tpu_torch.config import Config
    fields = set(Config.__dataclass_fields__)
    keys = {k for rel in TASK_FILES
            for t in tsched.load_tasks(str(REPO / rel)) for k in t}
    assert keys and keys <= fields, keys - fields


@pytest.mark.parametrize("cpu", [False, True])
def test_run_task_argv_is_the_jax_one_on_main_torch(tmp_path, monkeypatch,
                                                    cpu):
    seen = []

    class Done:
        returncode = 0

    def fake_run(cmd, **kwargs):
        seen.append(cmd)
        return Done()

    monkeypatch.setattr("subprocess.run", fake_run)
    task = {"dataset": "criteo", "data_path": "datasets/criteo",
            "compress_method": "cafe", "compress_rate": 0.001,
            "tensor_board_filename": str(tmp_path / "board" / "cafe0.001")}
    root = str(tmp_path)
    assert jsched.run_task(task, root, {}) == 0
    assert tsched.run_task(task, root, cpu) == 0
    want, got = seen
    want = [a.replace(os.path.join(root, "main.py"),
                      os.path.join(root, "main_torch.py")) for a in want]
    assert want[1] == os.path.join(root, "main_torch.py")
    assert got == want + (["--force_platform", "cpu"] if cpu else [])
    assert got[got.index("--data_path") + 1] == os.path.join(
        root, "datasets/criteo")


def test_gen_tasks_writes_the_jax_files(tmp_path):
    tgen.main(str(tmp_path / "port"))
    jgen.main(str(tmp_path / "jax"))
    files = sorted(str(p.relative_to(tmp_path / "jax"))
                   for p in (tmp_path / "jax").rglob("*.json"))
    assert files == sorted(str(p.relative_to(tmp_path / "port"))
                           for p in (tmp_path / "port").rglob("*.json"))
    _same_files(tmp_path / "port", tmp_path / "jax", files)


@pytest.fixture(scope="module")
def grid(tmp_path_factory):
    """A 2-task grid (hash and CAFE on a tiny synthetic dataset) run
    through the scheduler on the CPU, two workers."""
    root = tmp_path_factory.mktemp("grid")
    # the card's machine has no tensorboard; without it here too, each
    # task's process skips TensorFlow's ~14 s import
    block = root / "no_tensorboard" / "tensorboard"
    block.mkdir(parents=True)
    (block / "__init__.py").write_text(
        "raise ImportError('tensorboard is not used by this test')\n")
    board = root / "board"
    spec = {"base": {"dataset": "synthetic", "synthetic_rows": 4096,
                     "synthetic_fields": 4, "synthetic_vocab": 2000,
                     "embedding_dim": 8, "mini_batch_size": 128,
                     "print_freq": 16, "test_freq": 14,
                     "sparse_apply_impl": "dense"},
            "hash": {"compress_method": "hash", "compress_rate": [0.1],
                     "tensor_board_filename": str(board / "hash")},
            "cafe": {"compress_method": "cafe", "compress_rate": [0.05],
                     "cafe_sketch_threshold": [5.0],
                     "tensor_board_filename": str(board / "cafe")}}
    path = root / "grid.json"
    path.write_text(json.dumps(spec))
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("PYTHONPATH", str(block.parent), prepend=os.pathsep)
        codes = tsched.schedule([str(path)], workers=2, cpu=True)
    return codes, board


def test_grid_runs_end_to_end_on_the_cpu(grid):
    codes, board = grid
    assert codes == [0, 0], [(board / d / "stdouterr.log").read_text()[-2000:]
                             for d in ("hash0.1", "cafe0.05")]
    for run in ("hash0.1", "cafe0.05"):
        for name in ("config.json", "stdouterr.log", "scalars.jsonl"):
            assert (board / run / name).exists(), (run, name)
        cfg = json.loads((board / run / "config.json").read_text())
        assert cfg["tensor_board_filename"] == str(board / run)
        assert "Finished training it 28/28" in (
            board / run / "stdouterr.log").read_text()


def test_visualization_reads_and_plots_the_grid(grid, tmp_path):
    _, board = grid
    for method, cr in (("hash", 0.1), ("cafe", 0.05)):
        runs = tvis.collect_method_runs(str(board), method)
        assert list(runs) == [cr]
        s = runs[cr]
        assert 0.0 <= s["auc"] <= 1.0 and 0.0 <= s["acc"] <= 1.0
        assert np.isfinite(s["loss"])
        assert s == tvis.run_summary(str(board / f"{method}{cr}"))
    tvis.main(["metric_cr", "--board", str(board), "--out",
               str(tmp_path / "cr.png")])
    tvis.main(["metric_iter", "--runs", str(board / "hash0.1"),
               str(board / "cafe0.05"), "--out", str(tmp_path / "it.png")])
    for name in ("cr.png", "it.png"):
        assert (tmp_path / name).read_bytes()[:4] == b"\x89PNG"


def test_scheduler_exit_code_keeps_signal_deaths(monkeypatch):
    monkeypatch.setattr(tsched, "schedule", lambda *a: [0, -9, 1])
    with pytest.raises(SystemExit) as e:
        tsched.main(["x.json"])
    assert e.value.code == 9
