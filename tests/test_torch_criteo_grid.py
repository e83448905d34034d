"""The Criteo-scale AUC grid (cafe_tpu_torch/tools/criteo_grid.py) against
the JAX package's (cafe_tpu/tools/criteo_grid.py), on the CPU.

* gen_data draws the same arrays from the same seed (the 26 real
  vocabularies, 33,762,577 ids);
* run_config of the port, started from the JAX package's build_all state
  (bridge.from_reference), against the JAX run_config, which builds the
  same state, on a small hand-built CTRArrays (4 fields, vocabularies up
  to 5,000) with integer scores (cafe_use_freq): steps, slots_used,
  slot_capacity and the hot fractions exact (the sketch is exact on
  integer scores), AUC and accuracy within 1e-4 (f32 towers; torch and
  XLA sum in different orders);
* main: resumes past finished configs, exits 1 when a config fails, and
  --plot renders the figure.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from cafe_tpu.config import Config as JConfig
from cafe_tpu.data.datasets import CTRArrays as JArrays
from cafe_tpu.tools import criteo_grid as jg
from cafe_tpu.train.loop import build_all as jbuild_all
from cafe_tpu_torch import bridge
from cafe_tpu_torch.data import CTRArrays
from cafe_tpu_torch.data.synthetic import _zipf_ids
from cafe_tpu_torch.tools import criteo_grid as tg

torch.set_num_threads(1)

AUC_TOL = 1e-4
BATCH = 256
COUNTS = [5000, 3000, 800, 200]   # all above the CAFE threshold at cr 0.05


def test_gen_data_equals_jax():
    got, want = tg.gen_data(4096, 1.1, 7), jg.gen_data(4096, 1.1, 7)
    for f in ("sparse", "dense", "label", "counts"):
        np.testing.assert_array_equal(getattr(got, f), getattr(want, f))
    assert got.sparse.shape == (4096, 26)
    assert int(got.counts.astype(np.int64).sum()) == 33762577


def _small(rows=16384, seed=3):
    """gen_data's recipe on COUNTS: Zipf ids, a label driven by the ids
    and, more strongly, by the dense features (so 54 steps learn it)."""
    rng = np.random.default_rng(seed)
    cols, logits = [], np.zeros(rows, np.float32)
    for v in COUNTS:
        ids = _zipf_ids(rng, rows, v, 1.1)
        cols.append(ids)
        logits += rng.normal(0.0, 1.0, v).astype(np.float32)[ids]
    dense = np.log1p(rng.gamma(2.0, 2.0, (rows, 13))).astype(np.float32)
    z = (dense - dense.mean(0)) / dense.std(0)
    logits += 2 * z @ rng.normal(0.0, 1.0, 13).astype(np.float32)
    label = (rng.random(rows) < 1 / (1 + np.exp(-logits / 2))).astype(
        np.int32)
    sparse = np.stack(cols, 1)
    counts = np.asarray(COUNTS, np.int32)
    cut = rows * 6 // 7
    return [(cls(sparse[:cut], dense[:cut], label[:cut], counts),
             cls(sparse[cut:], dense[cut:], label[cut:], counts))
            for cls in (CTRArrays, JArrays)]


@pytest.mark.parametrize("method", ["hash", "cafe", "cafe_plus"])
def test_run_config_matches_jax(method):
    (train, test), (jtrain, jtest) = _small()
    cfg = tg.grid_config(method, 0.05, 500.0, 0.5, 16384, BATCH,
                         cafe_use_freq=True, cafe_sketch_threshold=16.0,
                         test_mini_batch_size=1024)
    jcfg = JConfig(**dataclasses.asdict(cfg))
    state = bridge.from_reference(jbuild_all(jcfg, jtrain)[2], "cpu")
    got = tg.run_config(cfg, train, test, BATCH, device="cpu", state=state)
    want = jg.run_config(jcfg, jtrain, jtest, BATCH)
    assert got["steps"] == want["steps"] == 16384 * 6 // 7 // BATCH
    exact = ["steps"] + (["slots_used", "slot_capacity", "hot_frac_last",
                          "hot_frac_mean"] if method != "hash" else [])
    for k in exact:
        assert got[k] == want[k], (k, got[k], want[k])
    if method != "hash":
        assert 0 < got["slots_used"] <= got["slot_capacity"]
        assert 0 < got["hot_frac_last"] < 1
    for k in ("auc", "acc"):
        assert abs(got[k] - want[k]) <= AUC_TOL, (k, got[k], want[k])
    assert set(got) == set(want)


@pytest.fixture
def tiny_grid(monkeypatch, tmp_path):
    """main() on the CPU at 4,096 rows with gen_data drawn once."""
    data = tg.gen_data(4096, 1.1, 7)
    monkeypatch.setattr(tg, "gen_data", lambda *a: data)
    out = tmp_path / "grid.jsonl"

    def run(*argv):
        return tg.main(["--platform", "cpu", "--rows", "4096", "--batch",
                        "512", "--epochs", "1", "--out", str(out),
                        *argv])
    return run, out


def test_main_resumes_and_fails_loudly(tiny_grid, capsys):
    run, out = tiny_grid
    run("--methods", "hash", "cafe", "--crs", "0.001")
    recs = [json.loads(ln) for ln in out.read_text().splitlines()]
    assert [(r["method"], r["cr"]) for r in recs] == [("hash", 0.001),
                                                      ("cafe", 0.001)]
    for r in recs:
        assert r["steps"] == 4096 * 6 // 7 // 512 and r["device"] == "cpu"
        assert 0.0 <= r["auc"] <= 1.0 and r["threshold"] == 2.0
    capsys.readouterr()
    with pytest.raises(SystemExit) as e:
        run("--methods", "hash", "nonesuch", "--crs", "0.001")
    assert e.value.code == 1
    text = capsys.readouterr().out
    assert "skip ('hash', 0.001, 4096) (done)" in text
    assert "SKIP nonesuch cr=0.001" in text and "1 config(s) FAILED" in text
    assert len(out.read_text().splitlines()) == 2


def test_plot_writes_a_png(tmp_path):
    out = tmp_path / "grid.jsonl"
    with open(out, "w") as f:
        for method, cr, auc in (("full", 1.0, 0.74), ("hash", 0.01, 0.7),
                                ("hash", 0.001, 0.68), ("cafe", 0.01, 0.72),
                                ("cafe", 0.001, 0.71)):
            f.write(json.dumps({"method": method, "cr": cr, "auc": auc,
                                "rows": 4096, "zipf": 1.1}) + "\n")
    png = tmp_path / "grid.png"
    tg.main(["--out", str(out), "--plot", str(png)])
    assert png.read_bytes()[:4] == b"\x89PNG"
