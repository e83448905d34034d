"""The collective byte model (cafe_tpu_torch/tools/hlo_traffic.py) against
the JAX package's (cafe_tpu/tools/hlo_traffic.py).

* model_result_bytes equals the JAX function on a grid of (lanes, dim,
  mesh size, method, migration cap, hot rows);
* collective_stats sums recorded (op, axis, bytes) records;
* at 2 and 4 gloo ranks (tests/torch_dist_worker.py) the recorded
  collective total of the port's explicit sharded step (hash, CAFE) lies
  within the bounds tests/test_sharding.py::TestTrafficPrediction holds
  the JAX package's compiled total to at the same configuration:
  [0.5, 3.0] x model for hash, [0.5, 4.0] x model for CAFE.

The port records the calls it makes, the JAX test its compiled program's
collectives (per-partition result bytes), so the totals differ. At these
configurations, rank 0, n = 2 and n = 4: hash 1,258,832 and 1,250,640
recorded against 1,258,836 and 1,250,644 compiled; CAFE 1,304,936 and
1,335,144 against 1,302,380 and 1,331,564 (model: 1,258,820, 1,250,628,
1,301,828, 1,332,548). Each assertion message states both.
"""

import itertools

import pytest
import torch

import torch_dist_worker as w
from cafe_tpu.tools import hlo_traffic as jtraffic
from cafe_tpu_torch.parallel.exchange import Collective
from cafe_tpu_torch.tools import hlo_traffic as traffic

torch.set_num_threads(1)

# tests/test_sharding.py TestTrafficPrediction._measure's configuration
ARGV = ["--force_platform", "cpu", "--dataset", "synthetic",
        "--embedding_dim", "16", "--cafe_sketch_threshold", "5",
        "--learning_rate", "0.1", "--synthetic_rows", "4096",
        "--synthetic_fields", "4", "--synthetic_vocab", str(2 ** 17),
        "--synthetic_dense", "13", "--mini_batch_size", "128",
        "--shard_embeddings", "true", "--shard_exchange", "explicit",
        "--tensor_board_filename", ""]
METHODS = {"hash": (0.2, 3.0), "cafe": (0.05, 4.0)}   # cr, upper factor
JAX_COMPILED = {("hash", 2): 1258836, ("hash", 4): 1250644,
                ("cafe", 2): 1302380, ("cafe", 4): 1331564}


@pytest.mark.parametrize("method", ["hash", "cafe"])
@pytest.mark.parametrize("n", [1, 2, 4, 8])
def test_model_equals_jax(method, n):
    for m, dim, mig_cap, hotn in itertools.product(
            (512, 53248), (16, 128), (0, 64), (0, 100)):
        args = (m, dim, n, 1205572)
        kw = dict(method=method, mig_cap=mig_cap, hotn=hotn)
        assert traffic.model_result_bytes(*args, **kw) == \
            jtraffic.model_result_bytes(*args, **kw), (args, kw)


def test_collective_stats_sums_records():
    recs = [Collective("all-gather", "data", 2048),
            Collective("all-reduce", "data", 100),
            Collective("all-gather", "ici", 512)]
    assert traffic.collective_stats(recs) == {
        "total": 2660, "by_axis": {"data": 2148, "ici": 512}}
    assert traffic.collective_stats([])["total"] == 0


@pytest.fixture(scope="module")
def recorded(tmp_path_factory):
    """{(method, n): rank 0's audit of one step} at 2 and 4 ranks."""
    argvs = [ARGV + ["--compress_method", method, "--compress_rate",
                     str(cr)] for method, (cr, _) in METHODS.items()]
    out = {}
    for n in (2, 4):
        res = w.run_ranks(w.collective_totals, n,
                          tmp_path_factory.mktemp(f"n{n}"), argvs)
        for method, rec in zip(METHODS, res[0]):
            out[method, n] = rec
    return out


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("n", [2, 4])
def test_recorded_total_tracks_model(recorded, method, n):
    rec = recorded[method, n]
    model = traffic.model_result_bytes(rec["lanes"], 16, n,
                                       rec["dense_bytes"],
                                       method=method)["total"]
    total = rec["total"]
    assert total == traffic.collective_stats(rec["collectives"])["total"]
    hi = METHODS[method][1]
    assert 0.5 * model <= total <= hi * model, {
        "port_recorded": total, "jax_compiled": JAX_COMPILED[method, n],
        "model": model, "bounds": (0.5 * model, hi * model)}
