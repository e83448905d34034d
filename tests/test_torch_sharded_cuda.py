"""The sharded slice across cards: K5 (kernels/a2a.cu) between processes
on different cards, and 5 sharded train steps on NCCL at world size
min(4, cards) against the same steps on gloo ranks on the CPU.

Needs at least 2 CUDA cards and skips, saying so, with fewer (one card
cannot host an NCCL group of two ranks; K5's one-card check across
processes is tests/test_torch_kernels.py::test_a2a_kernel_processes_one_card).
Runs with `python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_sharded_cuda.py` (no jax in this file or its ranks).

Tolerances: the all-to-all is a copy (bit-equal); sketch state, routing
and promotion counts exact (frequency scores); the hot fraction within
an f32 ulp; tables, params, loss and eval scores within 1e-4 (f32
towers; NCCL and gloo sum the ranks' gradients in other orders, the
card's row updates use atomics).
"""

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu_torch.config import Config
from cafe_tpu_torch.data import batch_iterator
from cafe_tpu_torch.train import get_dataset

SHARD = dict(dataset="synthetic", synthetic_rows=2048, synthetic_fields=4,
             synthetic_vocab=2000, synthetic_vocab_spread=0.04,
             synthetic_dense=4, synthetic_zipf=1.2, embedding_dim=8,
             mini_batch_size=128, compress_method="cafe",
             compress_rate=0.05, cafe_sketch_threshold=3.0,
             cafe_use_freq=True, learning_rate=0.1, cafe_mig_lanes=2,
             shard_embeddings=True)
SKETCH = ("val", "cnt", "dic", "free", "free_top", "tot")


@pytest.fixture
def world():
    if not torch.cuda.is_available() or torch.cuda.device_count() < 2:
        pytest.skip("needs at least 2 CUDA cards (one NCCL rank per card)")
    return min(4, torch.cuda.device_count())


@pytest.mark.cuda
def test_a2a_kernel_across_cards(world, tmp_path):
    chunk, dim, epochs, seed = 13312, 16, 3, 11
    res = w.run_ranks(w.kernel_a2a_epochs, world, tmp_path, chunk, dim,
                      epochs, seed, device="cuda")
    for rank, r in enumerate(res):
        assert r["launches"] == 2 * epochs
        for e, (ids, rows) in enumerate(r["outs"]):
            want_ids, want_rows = w.expected_a2a(world, chunk, dim, seed + e,
                                                 rank)
            np.testing.assert_array_equal(ids, want_ids)
            np.testing.assert_array_equal(rows, want_rows)


@pytest.mark.cuda
def test_sharded_steps_cards_match_cpu(world, tmp_path):
    kw = dict(SHARD, mesh_shape=world)
    cfg = Config(**kw)
    batches = list(batch_iterator(get_dataset(cfg, "train"), 128,
                                  drop_last=True))[:5]
    modes = ("explicit", "a2a", "pallas")
    card = w.run_ranks(w.train_steps, world, tmp_path / "card", kw, None,
                       batches, modes, device="cuda")[0]
    cpu = w.run_ranks(w.train_steps, world, tmp_path / "cpu", kw, None,
                      batches, modes)[0]
    for mode in modes:
        c, g = cpu[mode], card[mode]
        for cm, gm in zip(c["metrics"], g["metrics"]):
            for k in cm:
                # the hot fraction is a count over the batch size, which
                # the card's division may round an f32 ulp apart
                tol = (1e-4 if k == "loss" else
                       2.4e-7 * abs(cm[k]) if k.endswith("_frac") else 0.0)
                assert abs(cm[k] - gm[k]) <= tol, (mode, k, cm[k], gm[k])
        for key, part in c["state"]["embed"].items():
            gpart = g["state"]["embed"][key]
            for f in SKETCH if "sketch" in part else ():
                np.testing.assert_array_equal(gpart["sketch"][f],
                                              part["sketch"][f],
                                              err_msg=f"{mode} {key} {f}")
            np.testing.assert_allclose(gpart["table"], part["table"],
                                       rtol=1e-4, atol=1e-4)
        for tower in ("bot", "top"):
            for a, b in zip(g["state"]["params"][tower],
                            c["state"]["params"][tower]):
                for k in ("w", "b"):
                    np.testing.assert_allclose(a[k], b[k], rtol=1e-4,
                                               atol=1e-4)
        for key in c["routing"]:
            np.testing.assert_array_equal(g["routing"][key],
                                          c["routing"][key])
        np.testing.assert_allclose(g["scores"], c["scores"], rtol=1e-4,
                                   atol=1e-4)
        assert sum(m["cafe_promotions"] for m in g["metrics"]) > 0
