"""The sharded slice across cards: K5 (kernels/a2a.cu) between processes
on different cards, eagerly and captured in a CUDA graph whose replays
(fresh inputs each) interleave with eager calls on the same workspace
(the call counter lives on the card), at 2 and 4 cards; 5 sharded
train steps on NCCL at 2 and 4 cards, the default steps (graphed in
every exchange) and capture=False's, against each other and against
the same steps on gloo ranks on the CPU; the steps whose device
branches hold collectives (pallas, a2a, the unique-compact legs with a
batch that overflows them, the insert every 8 ticks) and the a2a legs
alone at a capacity that a skewed batch overflows, graphed at 2 and 4
cards, each replay against an eager step from one state, both sides of
every branch run inside replays; with 4
cards, the (2, 2) two-level mesh against the flat one and
--shard_exchange auto against one card's single-device step; the
collective-bytes table (tools/traffic_table_torch.py) on NCCL ranks
against its gloo ranks at 2 and 4 cards and on the (2, 2) mesh.

Needs at least 2 CUDA cards and skips, saying so, with fewer (one card
cannot host an NCCL group of two ranks; K5's one-card check across
processes is tests/test_torch_kernels.py::test_a2a_kernel_processes_one_card).
Runs with `python3 -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_sharded_cuda.py` (no jax in this file or its ranks).

Tolerances: the all-to-all is a copy (bit-equal); sketch state, routing
and promotion counts exact (frequency scores); the hot fraction within
an f32 ulp; tables, params, loss and eval scores within 1e-4 (f32
towers; NCCL and gloo sum the ranks' gradients in other orders, the
card's row updates use atomics). A replay against an eager step from
one state: integer leaves and fetched rows bit-equal, float leaves
within 1e-6 (relative over 1).
"""

import importlib.util
from pathlib import Path

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
@pytest.mark.parametrize("n", [2, 4])
def test_a2a_kernel_in_a_graph_across_cards(world, tmp_path, n):
    """K5 in a CUDA graph over 4 replays with fresh inputs, each followed
    by an eager call on other inputs: every output bit-equal to what
    all_to_all_single delivers (each rank's chunk `rank` of every
    rank's input). A replay that froze the capture's epoch would find
    its flags already set and copy stale slots."""
    if n > world:
        pytest.skip(f"needs {n} CUDA cards")
    chunk, dim, replays, seed = 4096, 16, 4, 31
    res = w.run_ranks(w.kernel_a2a_graph, n, tmp_path, chunk, dim, replays,
                      seed, device="cuda")
    for rank, r in enumerate(res):
        assert r["launches_at_capture"] == 0
        for e, (got, eager) in enumerate(r["outs"]):
            np.testing.assert_array_equal(
                got, w.expected_a2a(n, chunk, dim, seed + e, rank)[1],
                err_msg=f"replay {e}")
            np.testing.assert_array_equal(
                eager, w.expected_a2a(n, chunk, dim, seed + 1000 + e,
                                      rank)[1], err_msg=f"eager {e}")


def _metrics_close(c, g, mode):
    for cm, gm in zip(c["metrics"], g["metrics"]):
        for k in cm:
            # the hot fraction is a count over the batch size, which the
            # card's division may round an f32 ulp apart
            tol = (1e-4 if k == "loss" else
                   2.4e-7 * abs(cm[k]) if k.endswith("_frac") else 0.0)
            assert abs(cm[k] - gm[k]) <= tol, (mode, k, cm[k], gm[k])


def _runs_close(c, g, mode):
    """Sketch, routing and promotions exact; tables, params and scores
    within 1e-4."""
    _metrics_close(c, g, mode)
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
        np.testing.assert_array_equal(g["routing"][key], c["routing"][key])
    np.testing.assert_allclose(g["scores"], c["scores"], rtol=1e-4,
                               atol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
def test_sharded_steps_cards_match_cpu(world, tmp_path, n):
    """5 steps from build_all's state in each exchange mode: the default
    steps on the cards against capture=False's, and both against gloo
    ranks on the CPU. The default steps replay CUDA graphs (2 eager
    warm-up calls, a capture, replays) in every exchange: the a2a and
    pallas legs' overflow branches hold K5's device collectives, which
    the card captures into a conditional body on more than one rank."""
    if n > world:
        pytest.skip(f"needs {n} CUDA cards")
    kw = dict(SHARD, mesh_shape=n)
    cfg = Config(**kw)
    batches = list(batch_iterator(get_dataset(cfg, "train"), 128,
                                  drop_last=True))[:5]
    modes = ("explicit", "a2a", "pallas")
    graphed, eager = w.run_ranks(
        w.calls, n, tmp_path / "card",
        [("train_steps", (kw, None, batches, modes)),
         ("train_steps", (kw, None, batches, modes, False))],
        device="cuda")[0]
    cpu = w.run_ranks(w.train_steps, n, tmp_path / "cpu", kw, None,
                      batches, modes)[0]
    for mode in modes:
        assert graphed[mode]["graphed"] == [True, True], mode
        assert graphed[mode]["blockers"] == [], mode
        assert eager[mode]["graphed"] == [False, False], mode
        _runs_close(eager[mode], graphed[mode], mode)
        for card in (graphed[mode], eager[mode]):
            _runs_close(cpu[mode], card, mode)
            assert sum(m["cafe_promotions"] for m in card["metrics"]) > 0


HASH = dict(SHARD, compress_method="hash", compress_rate=0.2,
            synthetic_vocab=20000, mini_batch_size=512)
# the steps whose branches hold collectives: (config, whether a batch of
# distinct ids follows each data batch, the conds whose both sides must
# run in replays)
BODY_STEPS = {
    "pallas": (dict(SHARD, shard_exchange="pallas"), False, ()),
    "a2a": (dict(SHARD, shard_exchange="a2a"), False, ()),
    # 512 rows a batch: C holds a data batch's distinct rows, not those of
    # a batch of distinct ids
    "unique": (dict(HASH, shard_unique_frac=0.5), True,
               ("fetch_unique", "apply_unique")),
    "interval8": (dict(SHARD, cafe_insert_interval=8), False,
                  ("cafe_insert",)),
}


def _distinct_batch(batch, counts, seed):
    """`batch` with every sparse id replaced by a distinct-looking one
    within its field's vocabulary (a batch that overflows the compact
    legs)."""
    dense, sparse, label, valid = batch
    rng = np.random.default_rng(seed)
    ids = np.stack([np.resize(rng.permutation(int(c)), sparse.shape[0])
                    for c in counts], 1).astype(sparse.dtype)
    return dense, ids, label, valid


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("name", list(BODY_STEPS))
def test_body_steps_replay_eager(world, tmp_path, n, name):
    """The step graphs on n cards; 6 replays (data batches and, for the
    compact legs, batches of distinct ids between them), each against
    an eager step from the state it started from: integers bit-equal,
    floats within 1e-6; both sides of each named branch ran in
    replays (the insert at ticks 0 and 8 of the interval)."""
    if n > world:
        pytest.skip(f"needs {n} CUDA cards")
    cfg_kw, distinct, conds = BODY_STEPS[name]
    kw = dict(cfg_kw, mesh_shape=n)
    data = get_dataset(Config(**kw), "train")
    batches = list(batch_iterator(data, kw["mini_batch_size"],
                                  drop_last=True))
    if distinct:
        batches = [b for i, x in enumerate(batches[:3]) for b in (
            x, _distinct_batch(x, data.counts, i))]
    else:
        # warm-ups and the capture take ticks 0-2: tick 8 replays
        batches = batches[:6]
    got = w.run_ranks(w.graph_vs_eager, n, tmp_path, kw, batches,
                      device="cuda")
    for r in got:
        assert r["graphed"] and r["blockers"] == [], r["blockers"]
        assert r["bad"] == [], r["bad"]
        assert max(r["gaps"]) <= 1e-6, r["gaps"]
        assert np.isfinite(r["loss"])
        for c in conds:
            assert all(r["graph_runs"].get(c, [0, 0])), (c, r["graph_runs"])


def _exchange_batches(n, rows, lanes, dim, seed):
    """(idx, grad) batches over a `rows`-row table, `lanes` ids a rank:
    balanced (each rank's lanes spread evenly over the owners: the
    routed legs) and skewed (every id owned by rank 0, more distinct
    ids than a peer's capacity: both legs overflow), in turns."""
    rng = np.random.default_rng(seed)
    rows_l, b = rows // n, n * lanes // 8
    out = []
    for i in range(6):
        lane = np.arange(n * lanes)
        if i % 2 == 0:
            idx = (lane % n) * rows_l + rng.integers(0, rows_l, lane.size)
        else:
            idx = rng.integers(0, rows_l, lane.size)
        out.append((idx.astype(np.int32).reshape(b, 8),
                    rng.normal(0, 1, (b, 8, dim)).astype(np.float32)))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("n", [2, 4])
@pytest.mark.parametrize("impl", ["lax", "pallas"])
def test_a2a_legs_replay_both_branches(world, tmp_path, n, impl):
    """The a2a legs (fetch and apply) as one graphed step on n cards at
    slack 1 over batches that route and batches that overflow, in
    turns: the fetched rows bit-equal to an eager step's from one
    state, the table within 1e-6, and both sides of both legs' branches
    ran in replays."""
    if n > world:
        pytest.skip(f"needs {n} CUDA cards")
    rows, dim = 4096, 16
    table = np.random.default_rng(3).normal(0, 1, (rows, dim)).astype(
        np.float32)
    got = w.run_ranks(w.exchange_graph_vs_eager, n, tmp_path, table,
                      _exchange_batches(n, rows, 512, dim, 5), 1.0, impl,
                      device="cuda")
    for r in got:
        assert r["graphed"]
        assert max(r["fetch_gaps"]) == 0.0, r["fetch_gaps"]
        assert max(r["table_gaps"]) <= 1e-6, r["table_gaps"]
        for c in ("fetch_a2a", "apply_a2a"):
            assert r["graph_runs"][c] == [3, 3], r["graph_runs"]


@pytest.fixture
def four(world):
    if world < 4:
        pytest.skip("needs 4 CUDA cards for a (2, 2) mesh")
    return world


@pytest.mark.cuda
def test_two_level_cards_match_the_flat_mesh(four, tmp_path):
    """The (2, 2) two-level mesh on 4 cards (NCCL row and column groups)
    against the flat 4-card mesh: promotions and the sketch exact, the
    loss within 1e-6 relative, tables within 1e-4."""
    kw = dict(SHARD, mesh_shape=4, mesh_inner=2)
    batches = list(batch_iterator(get_dataset(Config(**kw), "train"), 128,
                                  drop_last=True))[:5]
    run = [(kw, None, batches, ("explicit",))]
    two = w.run_ranks(w.train_runs, 4, tmp_path / "two", run,
                      device="cuda", inner=2)[0][0]["explicit"]
    flat = w.run_ranks(w.train_runs, 4, tmp_path / "flat", run,
                       device="cuda")[0][0]["explicit"]
    for a, b in zip(two["metrics"], flat["metrics"]):
        np.testing.assert_allclose(a["loss"], b["loss"], rtol=1e-6)
        assert a["cafe_promotions"] == b["cafe_promotions"]
    assert sum(m["cafe_promotions"] for m in two["metrics"]) > 0
    for key, part in flat["state"]["embed"].items():
        for f in SKETCH if "sketch" in part else ():
            np.testing.assert_array_equal(
                two["state"]["embed"][key]["sketch"][f], part["sketch"][f],
                err_msg=f"{key} {f}")
        np.testing.assert_allclose(two["state"]["embed"][key]["table"],
                                   part["table"], rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_auto_cards_match_one_card(four, tmp_path):
    """--shard_exchange auto on 4 cards against one card's single-device
    step from build_all's own state: promotions and the sketch (dic
    included) exact, tables and loss within 1e-4."""
    from cafe_tpu_torch.bridge import to_numpy
    from cafe_tpu_torch.train import build_all
    kw = dict(SHARD, mesh_shape=4, shard_exchange="auto")
    cfg = Config(**kw)
    data = get_dataset(cfg, "train")
    batches = list(batch_iterator(data, 128, drop_last=True))[:5]
    got = w.run_ranks(w.train_runs, 4, tmp_path, [
        (kw, None, batches, ("auto",))], device="cuda")[0][0]["auto"]
    _, _, state, step, _ = build_all(cfg, data, device="cuda",
                                     capture=False)
    for (dense, sparse, label, valid), gm in zip(batches, got["metrics"]):
        state, m = step(state, *(torch.from_numpy(x).cuda()
                                 for x in (dense, sparse, label)), valid)
        np.testing.assert_allclose(gm["loss"], float(m["loss"]), rtol=1e-4)
        assert gm["cafe_promotions"] == int(m["cafe_promotions"])
    one = to_numpy(state)
    for key, part in one["embed"].items():
        for f in SKETCH if "sketch" in part else ():
            np.testing.assert_array_equal(got["state"]["embed"][key]
                                          ["sketch"][f], part["sketch"][f],
                                          err_msg=f"{key} {f}")
        np.testing.assert_allclose(got["state"]["embed"][key]["table"],
                                   part["table"], rtol=1e-4, atol=1e-4)


def _traffic_table():
    path = Path(__file__).resolve().parents[1] / "tools" / \
        "traffic_table_torch.py"
    spec = importlib.util.spec_from_file_location("traffic_table_torch",
                                                  path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.cuda
@pytest.mark.parametrize("mesh", ["2", "4", "2x2"])
def test_traffic_table_cards_match_gloo(world, mesh):
    """The table's NCCL rows (one rank a card) record the gloo rows'
    totals, bytes by axis and by op, for hash and CAFE, each within the
    JAX tool's criterion: the configuration sets the bytes, not the
    backend."""
    tool = _traffic_table()
    n, inner = tool.parse_mesh(mesh)
    if n > world:
        pytest.skip(f"needs {n} CUDA cards")
    card = tool.rows(n, inner, ["hash", "cafe"], device="cuda")
    cpu = tool.rows(n, inner, ["hash", "cafe"], device="cpu")
    for c, g in zip(card, cpu):
        assert c["hlo_total"] == g["hlo_total"], (mesh, c["method"])
        assert c["per_axis"] == g["per_axis"], (mesh, c["method"])
        assert c["by_op"] == g["by_op"], (mesh, c["method"])
        assert tool.passes(c), (mesh, c["method"], tool.ratio(c))
