"""The multi-node pieces (ports of cafe_tpu/parallel/multihost.py,
cafe_tpu/parallel/embedding_parallel.py and cafe_tpu/tools/wire_audit.py),
on gloo ranks (tests/torch_dist_worker.py):

* main_torch.py on 4 ranks posing as two nodes of two (LOCAL_RANK 0, 1 on
  each), flat and with --mesh_inner 2 (one node a row of the mesh),
  against the same run as one node of four; a resumed two-level run
  prints the saving run's losses (K = 1, 4), and the two-level mesh runs
  the latency protocol and serves at int4;
* global_batches cuts each rank's slice of a global batch and refuses
  one that does not divide; gather_to_host returns the mesh's rows;
* embedding_parallel's lookup, scatter-add and lookup-and-update against
  plain indexing;
* the wire audit's exit codes: 0 for the sharded CAFE step, 1 for a
  configuration that broadcasts an O(vocab) table every step (weighted
  pooling's replicated `w`), as the JAX package's audit gives 1 there.

Tolerances: the flat two-node run prints the one-node run's losses
exactly; the two-level run within 2e-6 (the printed 6 decimals; its
apply coalesces over the host's lanes). embedding_parallel within 1e-6
(duplicate rows sum in another order).
"""

import os
import re
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_dist_worker as w
from cafe_tpu_torch.tools import wire_audit
from test_torch_mesh_checkpoint import KW, _argv, _losses

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N = 4
ARGV = _argv(KW)
TWO_LEVEL = ARGV + ["--mesh_inner", "2"]


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    root = tmp_path_factory.mktemp("nodes")
    rng = np.random.default_rng(0)
    table = rng.standard_normal((64, 8)).astype(np.float32)
    ids = rng.integers(0, 64, 32).astype(np.int32)
    ids[:6] = 5                                    # duplicates
    upd = rng.standard_normal((32, 8)).astype(np.float32)
    batch = (rng.standard_normal((16, 4)).astype(np.float32),
             rng.integers(0, 99, (16, 3)).astype(np.int32),
             rng.random(16).astype(np.float32), 13)
    return (table, ids, upd, batch), w.run_ranks(w.calls, N, root, [
        ("node_runs", ([ARGV, TWO_LEVEL], 2)),
        ("node_runs", ([ARGV], 4)),
        ("save_resume_runs", (TWO_LEVEL, str(root), (1, 4))),
        ("multihost_pieces", (table, ids, upd, 0.5, batch)),
        ("latency_calls", (TWO_LEVEL,)),
        ("cli_text", (TWO_LEVEL + [
            "--inference_only", "true", "--load_model",
            str(root / "k4" / "a"), "--quantize_emb_bits", "4"],))])


def test_two_nodes_of_two_match_one_node(nodes):
    _, res = nodes
    (flat2, hier2), (one,) = res[0][0], res[0][1]
    want = _losses(one)
    assert want and _losses(flat2) == want
    got = _losses(hier2)
    assert set(got) == set(want)
    for it in want:
        assert abs(float(got[it]) - float(want[it])) <= 2e-6, it
    assert "exchange=explicit" in hier2


def test_two_level_resume_latency_and_serving(nodes):
    """On the (2, 2) mesh: a resumed run prints the saving run's losses
    at --steps_per_dispatch 1 and 4, the latency protocol makes its 1,024
    calls on every rank, and the saved state serves at int4."""
    _, res = nodes
    for k in (1, 4):
        run = res[0][2][k]
        a, b = _losses(run["a"]), _losses(run["b"])
        common = sorted(set(a) & set(b))
        assert common and all(a[i] == b[i] for i in common), k
    for r in res:
        calls, ms = r[4]
        assert calls == 1024 and ms > 0
    assert re.search(r"^accuracy=[\d.]+ .*roc_auc=[\d.]+$", res[0][5], re.M)


def test_global_batches_and_gather_to_host(nodes):
    (_, _, _, batch), res = nodes
    for rank, r in enumerate(res):
        got = r[3]
        sl = slice(rank * 4, (rank + 1) * 4)
        for x, want in zip(got["slice"], batch[:3]):
            np.testing.assert_array_equal(x, want[sl])
        assert got["valid"] == batch[3]
        assert "must divide by 4" in got["odd"]
        np.testing.assert_array_equal(got["gathered"], batch[2])


def test_embedding_parallel_matches_plain_indexing(nodes):
    (table, ids, upd, _), res = nodes
    want_add = table.copy()
    np.add.at(want_add, ids, upd)
    rows = table[ids]
    want_sgd = table.copy()
    np.add.at(want_sgd, ids, -0.5 * 2.0 * rows)
    for r in res:
        got = r[3]
        np.testing.assert_array_equal(got["gather"], rows)
        np.testing.assert_allclose(got["scatter_add"], want_add, rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_array_equal(got["lookup_rows"], rows)
        np.testing.assert_allclose(got["lookup_table"], want_sgd,
                                   rtol=1e-6, atol=1e-6)


WEIGHTED = ["--compress_method", "hash", "--compress_rate", "0.2",
            "--weighted_pooling", "learned", "--synthetic_vocab", "200000"]
# first item of a case whose audit is the JAX package's, run as its own
# process (it sets up 4 virtual XLA devices before jax starts)
JAX_AUDIT = "cafe_tpu.tools.wire_audit"


@pytest.mark.parametrize("flags,code", [
    (["--compress_method", "cafe", "--compress_rate", "0.05",
      "--mesh_inner", "2", "--shard_unique_frac", "0.5"], 0),
    (WEIGHTED, 1),
    # the JAX package fails weighted pooling too: its compiled step
    # all-reduces `w`'s dense gradient (4,369,712 B over a 2,337,352 B
    # bound), as the port broadcasts `w` (an O(vocab) collective in both)
    ([JAX_AUDIT] + WEIGHTED, 1)])
def test_wire_audit_exit_codes(flags, code, capsys):
    base = ["--force_platform", "cpu", "--devices", "4",
            "--synthetic_rows", "1024", "--synthetic_fields", "4",
            "--synthetic_dense", "4", "--embedding_dim", "8",
            "--mini_batch_size", "128", "--synthetic_vocab", "20000",
            "--tensor_board_filename", ""]
    if flags[0] == JAX_AUDIT:
        env = {k: v for k, v in os.environ.items() if k != "XLA_FLAGS"}
        out = subprocess.run([sys.executable, "-m", JAX_AUDIT, *base,
                              *flags[1:]], cwd=REPO, env=env,
                             capture_output=True, text=True, timeout=600)
        assert out.returncode == code, out.stdout + out.stderr
        assert "FAIL" in out.stdout and "all-reduce: 4,369,712 B" \
            in out.stdout, out.stdout
        return
    assert wire_audit.main(base + flags) == code
    out = capsys.readouterr().out
    assert ("PASS" if code == 0 else "FAIL") in out
    assert "per-axis bytes" in out
