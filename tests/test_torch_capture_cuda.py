"""The CUDA-graph steps on the card (train/capture.py), with no JAX in the
process: `cuda` tests that skip here and run on a card with

    python3 -m pytest --noconftest -p no:cacheprovider -m cuda \\
        tests/test_torch_capture_cuda.py

* a replayed train step equals the eager step bit for bit over 10 steps
  with a tail and an empty batch, on the deterministic dense apply (K3)
  with frequency scores; so do the 2-step dispatch and the eval step;
* a call with another state (a reload) copies it in before the replay
  and leaves the caller's tensors alone;
* the kernels' launch counts grow by the captured launches at every
  replay;
* device branches (utils/cond.cond) in a graph: nested conds replay the
  branch the card picks; an interval-8 CAFE step, graphed, equals its
  eager step bit for bit over 16 steps, with K1 counted only on the
  replays that ran the insert, also when the step is deleted before
  the count is read; CAFE+ with a reset firing inside a
  replay, Adagrad and Adam, and AdaEmbed across a check step (run
  eagerly on the graph's state) equal their eager steps too;
* a mesh of one NCCL rank: the graphed train step (K = 1 and 2) and eval
  step equal their eager twins from one state, in the explicit and
  pallas exchanges, with the unique-compact legs and at insert interval
  8, integers exact and floats within 1e-5 (the same kernels in the same
  order: the one-device steps above are bit-equal); every replay runs
  under torch.cuda.set_sync_debug_mode("error"), so no value is read
  back to the host in a graphed mesh step;
* spans (utils/spans.py): a graphed 8-step dispatch under the profiler
  runs its span marks and the promotions counter in the captured order,
  8 times a replay, inside the host ranges cafe_dispatch / cafe_load /
  cafe_replay; the graph of untraced replays holds no mark or counter
  launch and runs every kernel of the traced graph but its marks (the
  counter's total stays), and K1 / K3 launch as before; 16 traced
  replays leave the state bit-equal to 16 untraced ones, and the
  counters add up the calls' promotions and migration lanes (each at
  insert interval 1 and 8);
* the graph recommenders (models/graphrec/): LightGCN's BPR step (cr 1.0
  and 0.5) and PinSAGE's train and representation steps (compress
  ratio 1 and 4), graphed against eager from one state, replays under
  the same sync check, K1 once a replay on CAFE, K3 (segment_rows) 7
  and 4 times; a PinSAGE step built for one lr raises on another.
"""

import contextlib
import gc

import numpy as np
import pytest
import torch

from cafe_tpu_torch.bridge import from_reference, to_numpy
from cafe_tpu_torch.config import Config
from cafe_tpu_torch.kernels import land, rowsum
from cafe_tpu_torch.embeddings import CafePart
from cafe_tpu_torch.sketch import PROMO_LANES
from cafe_tpu_torch.train import build_all, build_multi_step, get_dataset
from cafe_tpu_torch.train.capture import (WARMUP_CALLS, GraphedStep,
                                          branch_runs, cond, copy_into)

torch.set_num_threads(1)

B = 256
KW = dict(dataset="synthetic", synthetic_rows=8192, synthetic_fields=6,
          synthetic_vocab=5000, synthetic_dense=4, synthetic_zipf=1.2,
          embedding_dim=16, mini_batch_size=B, compress_method="cafe",
          compress_rate=0.05, cafe_sketch_threshold=3.0, cafe_use_freq=True,
          learning_rate=0.1, bf16=True, sparse_apply_impl="dense")
# valid counts of the 10 steps: full batches, a tail, an empty batch
VALIDS = [B, B, B, B - 37, B, 0, B, B, B - 1, B]


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


def _setup(k=1, **kw):
    """(cfg, graphed step, eager step, graphed eval, eager eval, start
    state as numpy, batches of k * B rows on the card)."""
    cfg = Config(**dict(KW, **kw))
    data = get_dataset(cfg, "train")
    _, _, state, g_step, g_eval = build_all(cfg, data, device="cuda")
    _, _, _, e_step, e_eval = build_all(cfg, data, device="cuda",
                                        capture=False)
    if k > 1:
        g_step = build_multi_step(g_step, k, donate=True)
        e_step = build_multi_step(e_step, k, donate=True)
    rows = k * B
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(a[i:i + rows]))
                     .cuda() for a in (data.dense, data.sparse, data.label))
               for i in range(0, len(data) - rows + 1, rows)]
    return cfg, g_step, e_step, g_eval, e_eval, to_numpy(state), batches


def _run(step, state, batches, valids):
    metrics = []
    for i, v in enumerate(valids):
        state, m = step(state, *batches[i % len(batches)], v)
        metrics.append({name: x.clone() for name, x in m.items()})
    torch.cuda.synchronize()
    return state, metrics


def _assert_equal(a, b):
    np.testing.assert_equal(to_numpy(a), to_numpy(b))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
def test_replayed_steps_equal_eager_steps_bitwise(k):
    _card()
    _, g_step, e_step, g_eval, e_eval, start, batches = _setup(k)
    assert g_step.graphed and isinstance(g_step, GraphedStep)
    assert not e_step.graphed
    valids = [k * v for v in VALIDS]
    e_state, e_m = _run(e_step, from_reference(start, "cuda"), batches,
                        valids)
    g_state, g_m = _run(g_step, from_reference(start, "cuda"), batches,
                        valids)
    assert g_step.replays == len(valids) - WARMUP_CALLS
    _assert_equal(g_state, e_state)
    for em, gm in zip(e_m, g_m):
        assert set(em) == set(gm)
        for name in em:
            assert torch.equal(em[name], gm[name]), name
    assert sum(float(m["cafe_promotions"]) for m in g_m) > 0
    # eval on the trained state: graphed scores equal eager ones
    for dense, sparse, _ in batches[:4]:
        got = g_eval(g_state, dense[:B], sparse[:B]).clone()
        want = e_eval(e_state, dense[:B], sparse[:B])
        assert torch.equal(got, want)
    assert g_eval.graphed and g_eval.replays == 4 - WARMUP_CALLS


@pytest.mark.cuda
def test_a_different_state_is_copied_in():
    """After the graph has run on one state, a call with a state loaded
    from elsewhere replays on that state's values, and the loaded
    tensors stay as they were."""
    _card()
    _, g_step, e_step, _, _, start, batches = _setup()
    state = from_reference(start, "cuda")
    for i in range(WARMUP_CALLS + 2):
        state, _ = g_step(state, *batches[i], B)
    assert g_step.replays == 2
    loaded = from_reference(start, "cuda")
    loaded_before = to_numpy(loaded)
    got, gm = g_step(loaded, *batches[5], B - 9)
    want, em = e_step(from_reference(start, "cuda"), *batches[5], B - 9)
    torch.cuda.synchronize()
    _assert_equal(got, want)
    assert float(gm["loss"]) == float(em["loss"])
    np.testing.assert_equal(to_numpy(loaded), loaded_before)
    assert got is g_step.state and got is not loaded


@pytest.mark.cuda
def test_launch_counts_grow_per_replay():
    _card()
    _, g_step, _, _, _, start, batches = _setup()
    state = from_reference(start, "cuda")
    l0, r0 = land.KERNEL.launches, rowsum.KERNEL.launches
    g0 = land.KERNEL.graph_launches
    n = 12
    for i in range(n):
        state, _ = g_step(state, *batches[i % len(batches)], B)
    torch.cuda.synchronize()
    assert g_step.launches_per_replay() == {"land_max": 1, "rowsum": 1}
    assert land.KERNEL.launches - l0 == n
    assert rowsum.KERNEL.launches - r0 == n
    assert land.KERNEL.graph_launches - g0 == n - WARMUP_CALLS
    assert land.KERNEL.captured >= 1 and g_step.capture_s > 0


@pytest.mark.cuda
@pytest.mark.parametrize("plus", [False, True])
def test_quantized_eval_replays_equal_eager(plus):
    """The quantized eval step (int8 and int4) graphed on the card equals
    its eager twin bit for bit, on a trained state, batch for batch."""
    from cafe_tpu_torch.train import build_quantized_eval_step
    _card()
    cfg, _, e_step, _, _, start, batches = _setup(cafe_plus=plus)
    state, _ = _run(e_step, from_reference(start, "cuda"), batches,
                    VALIDS[:4])
    model, embed, *_ = build_all(cfg, get_dataset(cfg, "train"),
                                 device="cuda", capture=False)
    for bits in (8, 4):
        g = build_quantized_eval_step(model, embed, state, bits)
        e = build_quantized_eval_step(model, embed, state, bits,
                                      capture=False)
        assert g.graphed and not e.graphed
        for dense, sparse, _ in batches[:6]:
            assert torch.equal(g(state, dense, sparse).clone(),
                               e(state, dense, sparse))
        assert g.replays == 6 - WARMUP_CALLS


@pytest.mark.cuda
@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_rowwise_card_equals_cpu(bits):
    """The card's codes, scales and zeros byte-equal to the CPU's (a
    division by a Python number on the card would multiply by its
    reciprocal and move the last bit of some scales)."""
    from cafe_tpu_torch.ops.quantized import quantize_rowwise
    _card()
    table = torch.from_numpy(np.random.default_rng(0).normal(
        0, 0.3, (65536, 16)).astype(np.float32))
    card = quantize_rowwise(table.cuda(), bits).codes.cpu()
    assert torch.equal(card, quantize_rowwise(table, bits).codes)


@pytest.mark.cuda
def test_nested_conds_replay_the_branch_the_card_picks():
    """A graphed call with an if-else holding another: each replay takes
    the branches its inputs pick, the outputs of both sides land in one
    buffer, and each body's runs are counted on the card."""
    _card()

    def inner(x):
        return cond(x.sum() > 0, lambda y: y * 2.0, lambda y: y - 1.0, (x,),
                    name="inner")

    def fn(state, x, flag):
        out = cond(flag > 0, lambda y: inner(y) + 10.0,
                   lambda y: y * 0.5, (x,), name="outer")
        return state, out

    def want(x, flag):
        if flag > 0:
            return (x * 2.0 if x.sum() > 0 else x - 1.0) + 10.0
        return x * 0.5

    step = GraphedStep(fn, carry=True)
    state = {"s": torch.zeros((), device="cuda")}
    before = branch_runs()["graph"]
    cases = [(1.0, 1), (-1.0, 1), (1.0, 0), (-1.0, 1), (2.0, 0), (3.0, 1)]
    for v, flag in cases:
        x = torch.full((4,), v, device="cuda")
        f = torch.tensor(flag, dtype=torch.int32, device="cuda")
        _, out = step(state, x, f)
        assert torch.equal(out, want(x, flag)), (v, flag)
    assert step.replays == len(cases) - WARMUP_CALLS
    runs = branch_runs()["graph"]
    replayed = cases[WARMUP_CALLS:]
    outer_true = sum(flag > 0 for _, flag in replayed)
    assert runs["outer"][1] - before.get("outer", [0, 0])[1] == outer_true
    assert runs["outer"][0] - before.get("outer", [0, 0])[0] == \
        len(replayed) - outer_true
    assert sum(runs["inner"]) - sum(before.get("inner", [0, 0])) == \
        outer_true


def _trajectory(step, state, batches, n):
    out = []
    for i in range(n):
        state, m = step(state, *batches[i % len(batches)], B)
        out.append({name: x.clone() for name, x in m.items()})
    torch.cuda.synchronize()
    return state, out


@pytest.mark.cuda
@pytest.mark.parametrize("plus", [False, True])
def test_interval8_graphed_equals_eager(plus):
    """cafe_insert_interval 8 over 16 steps: the graphed step (a
    conditional node holds the insert) equals the eager one bit for bit,
    and K1 counts one launch a v1 insert that ran (eager, spare warm-up
    or replayed)."""
    _card()
    cfg, g_step, e_step, _, _, start, batches = _setup(
        cafe_insert_interval=8, cafe_plus=plus)
    assert g_step.graphed and not g_step.capture_blockers
    e_state, e_m = _trajectory(e_step, from_reference(start, "cuda"),
                               batches, 16)
    runs0 = branch_runs()
    l0 = land.KERNEL.launches
    g_state, g_m = _trajectory(g_step, from_reference(start, "cuda"),
                               batches, 16)
    assert g_step.replays == 16 - WARMUP_CALLS
    _assert_equal(g_state, e_state)
    for em, gm in zip(e_m, g_m):
        for name in em:
            assert torch.equal(em[name], gm[name]), name
    runs = branch_runs()
    ran = {k: runs[k]["cafe_insert"][1] - runs0[k].get(
        "cafe_insert", [0, 0])[1] for k in runs}
    assert ran["graph"] == 1 and ran["eager"] == 1     # ticks 8 and 0
    if not plus:                 # K1 lands v1's insert (none in CAFE+)
        assert land.KERNEL.launches - l0 == sum(ran.values())


@pytest.mark.cuda
def test_a_freed_graphs_inserts_still_count():
    """K1's launches in the insert's conditional body count after the
    graphed step that replayed them is deleted, before any count read."""
    _card()
    _, g_step, _, _, _, start, batches = _setup(cafe_insert_interval=8)
    l0, g0 = land.KERNEL.launches, land.KERNEL.graph_launches
    state = from_reference(start, "cuda")
    for i in range(16):
        state, _ = g_step(state, *batches[i % len(batches)], B)
    torch.cuda.synchronize()
    del g_step, state
    gc.collect()
    # tick 0's insert and the warm-up calls' spare inserts run eagerly,
    # tick 8's in a replayed body
    assert land.KERNEL.graph_launches - g0 == 1
    assert land.KERNEL.launches - l0 == 1 + (WARMUP_CALLS - 1) + 1


@pytest.mark.cuda
@pytest.mark.parametrize("extra", [
    {"cafe_plus": True, "cafe_sketch_threshold": 1.0},
    {"optimizer": "adagrad", "sparse_apply_impl": "auto"},
    {"optimizer": "adam", "sparse_apply_impl": "auto"},
    {"compress_method": "ada", "compress_rate": 0.5,
     "sparse_apply_impl": "auto"}])
def test_branching_steps_graphed_equal_eager(extra):
    """CAFE+ with threshold 1 (its reset fires inside replays), Adagrad
    and Adam (fixed-shape rows) and AdaEmbed (step 1 is a check step,
    run eagerly on the graph's state): 12 graphed steps equal 12 eager
    ones."""
    _card()
    _, g_step, e_step, _, _, start, batches = _setup(**extra)
    assert g_step.graphed
    ada = [k for k, v in start["embed"].items() if "grad_norm" in v]
    for key in ada:        # a check and a decay step at 16,384
        start["embed"][key]["step"] = np.asarray(16380, np.int32)
    e_state, e_m = _trajectory(e_step, from_reference(start, "cuda"),
                               batches, 12)
    runs0 = branch_runs()["graph"].get("plus_reset", [0, 0])[1]
    decays0 = branch_runs()["graph"].get("ada_decay", [0, 0])[1]
    g_state, g_m = _trajectory(g_step, from_reference(start, "cuda"),
                               batches, 12)
    e_np, g_np = to_numpy(e_state), to_numpy(g_state)
    # index_add_ sums duplicate lanes in float atomics: floats within
    # f32 reordering, integers exact
    for (path, a), (_, b) in zip(_np_leaves(e_np), _np_leaves(g_np)):
        if a.dtype.kind in "iub":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-5,
                                       err_msg=path)
    if extra.get("cafe_plus"):
        assert branch_runs()["graph"]["plus_reset"][1] > runs0
    if ada:
        assert g_step.host_calls == 1 and g_step.replays == 12 - \
            WARMUP_CALLS - 1
        # the decay step (16,384) is the check step, run eagerly: no
        # replay ran the decay's body
        assert branch_runs()["graph"].get("ada_decay", [0, 0])[1] \
            == decays0
        g_step.check_mirror(g_state)


def _np_leaves(tree, path=""):
    if tree is None:
        return []
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _np_leaves(tree[k],
                                                            f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _np_leaves(v, f"{path}[{i}]")]
    return [(path, np.asarray(tree))]


# ------------------------------------------------- spans (utils/spans.py)

# the marks of one step, in the order the step enqueues them
STEP_MARKS = (["cafe_span_begin_step"]
              + [f"cafe_span_{end}_{name}" for name in (
                  "embed_gather", "towers", "cafe_insert", "cafe_migrate",
                  "cafe_update") for end in ("begin", "end")]
              + ["cafe_span_count", "cafe_span_end_step"])


def _traced(fn):
    """fn() under torch.profiler (CPU and CUDA); returns (device op names
    by start, host op names)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    dev, host = [], []
    for ev in prof.profiler.kineto_results.events():
        if ev.device_type() == DeviceType.CUDA:
            dev.append((ev.start_ns(), ev.name()))
        else:
            host.append(ev.name())
    return [n for _, n in sorted(dev)], host


def _dispatches(step, state, batches, first, n, k=8):
    for i in range(first, first + n):
        state, m = step(state, *batches[i % len(batches)], k * B)
    return state, m


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [1, 8])
def test_span_marks_replay_in_the_captured_order(interval):
    """A graphed 8-step dispatch under the profiler runs each span's
    begin and end marks and the promotions counter in the captured
    order, 8 times a replay (at insert interval 8 around the insert's
    conditional node); the call is the host range cafe_dispatch with
    cafe_load and cafe_replay, which the device's timeline does not
    show."""
    _card()
    _, g_step, _, _, _, start, batches = _setup(
        8, cafe_insert_interval=interval)
    state, _ = _dispatches(g_step, from_reference(start, "cuda"), batches,
                           0, WARMUP_CALLS + 1)
    names, host = _traced(lambda: _dispatches(g_step, state, batches,
                                              WARMUP_CALLS + 1, 2))
    marks = [n for n in names if n.startswith("cafe_span_")]
    assert marks == STEP_MARKS * 8 * 2
    for rng in ("cafe_dispatch", "cafe_load", "cafe_replay"):
        assert host.count(rng) == 2, rng
        # a host range only: not mirrored on the device's timeline
        assert rng not in names, rng


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [1, 8])
def test_untraced_replays_run_a_graph_without_span_nodes(interval):
    """The step is captured twice: the graph replayed with the profiler
    off holds no mark or counter launch, the one replayed with it on
    holds the marks of 8 steps. Replayed under the profiler from one
    state, the first runs no mark and, without branches (interval 1),
    every kernel of the second but its marks; through GraphedStep,
    untraced replays before and after a traced call leave the promotions
    counter's total alone in a replay that promotes, and K1 / K3 launch
    as before."""
    from collections import Counter
    from cafe_tpu_torch.utils import spans
    _card()
    _, g_step, _, _, _, start, batches = _setup(
        8, cafe_insert_interval=interval)
    state, snaps, promos = from_reference(start, "cuda"), [], []
    for i in range(WARMUP_CALLS + 1):
        snaps.append(to_numpy(state))
        state, m = g_step(state, *batches[i], 8 * B)
        promos.append(int(m["cafe_promotions"]))
    nodes = len(STEP_MARKS) * 8
    assert g_step.span_marks() == (0, nodes)
    total = spans._TOTALS[torch.device("cuda", torch.cuda.current_device())]
    first = next(i for i, n in enumerate(promos) if n > 0)

    def untraced():
        # the state before the first call that promoted, copied in: the
        # replay promotes as that call did
        before = int(total.sum())
        _, m = g_step(from_reference(snaps[first], "cuda"),
                      *batches[first], 8 * B)
        assert int(m["cafe_promotions"]) == promos[first]
        assert int(total.sum()) == before

    untraced()
    g = g_step._graph_of(None)

    def replayed(graph):
        # each graph from the same state and batch, so the branches
        # taken are the same
        copy_into(g_step.state, from_reference(snaps[first], "cuda"))
        g.load((*batches[first], 8 * B))
        return _traced(graph.replay)[0]

    plain, marked = replayed(g.graph), replayed(g.traced.graph)
    marks = [n for n in marked if n.startswith("cafe_span_")]
    assert marks == STEP_MARKS * 8
    assert not any(n.startswith("cafe_span_") for n in plain)
    if interval == 1:
        # at interval 8 the profiler's counts of some kernels once
        # differed between these two replays in a run of the whole file
        # and matched in a run alone (PERF.md, section 7); the
        # alternating test below holds the two graphs' results equal
        assert Counter(plain) == Counter(
            n for n in marked if not n.startswith("cafe_span_"))
    names, _ = _traced(lambda: _dispatches(g_step, state, batches, 5, 1))
    assert sum(n.startswith("cafe_span_") for n in names) == nodes
    untraced()
    assert g.traced.launches == g.launches
    if interval == 1:
        assert g_step.launches_per_replay() == {"land_max": 8,
                                                 "rowsum": 8}


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [1, 8])
def test_tracing_leaves_the_state_bit_equal_and_counts(interval):
    """16 replays of the 8-step dispatch with the profiler on leave the
    tables, the sketch and the tick bit-equal to 16 with it off; traced,
    `promotions` adds up the calls' cafe_promotions and
    `migration_lanes` their lanes (8 x cap a call), eager warm-ups
    included."""
    from cafe_tpu_torch.utils import spans
    _card()
    n = WARMUP_CALLS + 1 + 16
    cfg, off_step, _, _, _, start, batches = _setup(
        8, cafe_insert_interval=interval)
    off, _ = _dispatches(off_step, from_reference(start, "cuda"), batches,
                         0, n)
    # the migration's lanes a step: the CAFE part's cap on B x F lanes
    _, embed, _, _, _ = build_all(cfg, get_dataset(cfg, "train"),
                                  device="cpu", capture=False)
    part = next(p for p in embed.parts if isinstance(p, CafePart))
    cap = min(B * len(part.field_idx), PROMO_LANES, part.hotn,
              max(part.mig_lanes * 16, 4096))
    _, on_step, _, _, _, _, _ = _setup(8, cafe_insert_interval=interval)
    promos = []

    def traced():
        state = from_reference(start, "cuda")
        for i in range(n):
            state, m = on_step(state, *batches[i % len(batches)], 8 * B)
            promos.append(m["cafe_promotions"].clone())
        return state

    holder = []
    _traced(lambda: holder.append(traced()))
    _assert_equal(holder[0], off)
    got = spans.counters()
    assert got["migration_lanes"] == 8 * n * cap
    assert got["promotions"] == int(torch.stack(promos).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("interval", [1, 8])
def test_alternating_traced_and_untraced_replays_stay_bit_equal(interval):
    """The two graphs of a step share one memory pool: replays that
    alternate between them (the profiler turned on and off every call)
    leave the state bit-equal to untraced replays alone."""
    _card()
    n = WARMUP_CALLS + 1 + 12
    _, off_step, _, _, _, start, batches = _setup(
        8, cafe_insert_interval=interval)
    off, _ = _dispatches(off_step, from_reference(start, "cuda"), batches,
                         0, n)
    _, mix_step, _, _, _, _, _ = _setup(8, cafe_insert_interval=interval)
    state = from_reference(start, "cuda")
    for i in range(n):
        if i % 2:
            holder = []
            _traced(lambda: holder.append(_dispatches(
                mix_step, state, batches, i, 1)))
            state = holder[0][0]
        else:
            state, _ = _dispatches(mix_step, state, batches, i, 1)
    torch.cuda.synchronize()
    _assert_equal(state, off)


# ------------------------------------------------- a mesh of one NCCL rank

MESH_CASES = {"explicit": {}, "pallas": {"shard_exchange": "pallas"},
              "unique": {"shard_unique_frac": 0.5},
              "interval": {"cafe_insert_interval": 8}}


@pytest.fixture(scope="module")
def nccl_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import torch.distributed as dist
    from cafe_tpu_torch.parallel import make_mesh, maybe_init_distributed
    own = maybe_init_distributed(Config(), "cuda")
    mesh = make_mesh(1, device="cuda")
    yield mesh
    mesh.close()
    if own:
        dist.destroy_process_group()


@contextlib.contextmanager
def _no_sync():
    """Any synchronizing call (a value read back to the host) raises."""
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode("default")


def _close_states(a, b, path=""):
    if isinstance(a, dict):
        assert set(a) == set(b), path
        for k in a:
            _close_states(a[k], b[k], f"{path}/{k}")
    elif isinstance(a, (list, tuple)):
        for i, (x, y) in enumerate(zip(a, b)):
            _close_states(x, y, f"{path}[{i}]")
    elif a is not None:
        a, b = np.asarray(a), np.asarray(b)
        if a.dtype.kind in "biu":
            np.testing.assert_array_equal(a, b, err_msg=path)
        else:
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-5,
                                       err_msg=path)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 2])
@pytest.mark.parametrize("name", sorted(MESH_CASES))
def test_mesh_graphed_steps_equal_eager_without_host_reads(nccl_mesh, name,
                                                           k):
    cfg = Config(**dict(KW, mesh_shape=1, shard_embeddings=True,
                        **MESH_CASES[name]))
    data = get_dataset(cfg, "train")
    _, _, state, g_step, g_eval = build_all(cfg, data, mesh=nccl_mesh)
    _, _, _, e_step, e_eval = build_all(cfg, data, mesh=nccl_mesh,
                                        capture=False)
    assert g_step.graphed and g_eval.graphed and not e_step.graphed
    if k > 1:
        g_step = build_multi_step(g_step, k, donate=True, mesh_size=1)
        e_step = build_multi_step(e_step, k, donate=True, mesh_size=1)
        assert g_step.graphed
    start = to_numpy(state)
    rows = k * B
    batches = [tuple(torch.from_numpy(np.ascontiguousarray(a[i:i + rows]))
                     .cuda() for a in (data.dense, data.sparse, data.label))
               for i in range(0, len(data) - rows + 1, rows)]
    valids = [k * v for v in VALIDS]
    e_state, e_m = _run(e_step, from_reference(start, "cuda"), batches,
                        valids)
    g_state, g_m = from_reference(start, "cuda"), []
    for i, v in enumerate(valids):
        replay = i > WARMUP_CALLS
        with _no_sync() if replay else contextlib.nullcontext():
            g_state, m = g_step(g_state, *batches[i % len(batches)], v)
            g_m.append({n: x.clone() for n, x in m.items()})
    torch.cuda.synchronize()
    assert g_step.replays == len(valids) - WARMUP_CALLS
    # a mesh's step captures no span mark, so one graph (utils/spans)
    assert g_step.span_marks() == (0, 0)
    _close_states(to_numpy(g_state), to_numpy(e_state))
    for em, gm in zip(e_m, g_m):
        for n in em:
            np.testing.assert_allclose(gm[n].cpu().numpy(),
                                       em[n].cpu().numpy(), rtol=1e-5,
                                       atol=1e-5, err_msg=n)
    assert sum(float(m["cafe_promotions"]) for m in g_m) > 0
    for i, (dense, sparse, _) in enumerate(batches[:5]):
        with _no_sync() if i > WARMUP_CALLS else contextlib.nullcontext():
            got = g_eval(g_state, dense[:B], sparse[:B]).clone()
        want = e_eval(e_state, dense[:B], sparse[:B])
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   rtol=1e-5, atol=1e-5)
    assert g_eval.replays == 5 - WARMUP_CALLS


# ------------------------------------------ the graph recommenders' steps

GRAPHREC_LR = 0.01
GRAPHREC_STEPS = 6


def _graphrec_close(got, want, path=""):
    """Numpy states after the same steps graphed and eager: integers
    exact, floats within 1e-5, but for a rows-Adam table's rows whose
    gradient is float noise in either (|m| < 1e-6), which Adam moves by
    up to lr whatever the noise's sign: those within lr + 1e-5."""
    if isinstance(got, dict) and "table_m" in got:
        noise = (np.abs(got["table_m"]).max(1) < 1e-6) \
            | (np.abs(want["table_m"]).max(1) < 1e-6)
        d = np.abs(got["table"] - want["table"])
        assert d[~noise].max(initial=0.0) <= 1e-5, f"{path}/table"
        assert d[noise].max(initial=0.0) <= GRAPHREC_LR + 1e-5, path
        got = {k: v for k, v in got.items() if k != "table"}
        want = {k: v for k, v in want.items() if k != "table"}
    if isinstance(got, dict):
        assert set(got) == set(want), path
        for k in got:
            _graphrec_close(got[k], want[k], f"{path}/{k}")
    elif isinstance(got, (list, tuple)):
        for i, (x, y) in enumerate(zip(got, want)):
            _graphrec_close(x, y, f"{path}[{i}]")
    else:
        _close_states(got, want, path)


def _interactions():
    import main_graphrec_torch
    return main_graphrec_torch.make_synthetic_interactions()


@pytest.mark.cuda
@pytest.mark.parametrize("cr", [1.0, 0.5])
def test_lightgcn_graphed_step_equals_eager(cr):
    """LightGCN.build_step graphed against eager (rows-Adam, frequency
    scores) from one state over GRAPHREC_STEPS BPR batches: losses and
    states as _graphrec_close holds them, the sketch exact, K1 once a
    replay on CAFE, no value read back to the host in a replay."""
    _card()
    from cafe_tpu_torch.models.graphrec import (
        LightGCN, LightGCNConfig, build_bipartite_graph, sample_negative)
    train, _, n_items = _interactions()
    users = np.concatenate([np.full(len(p), u, np.int32)
                            for u, p in enumerate(train)])
    items = np.concatenate(train)
    graph = build_bipartite_graph(users, items, len(train), n_items)
    cfg = LightGCNConfig(latent_dim=16, n_layers=3, lr=GRAPHREC_LR,
                         compress_rate=cr, sketch_threshold=2.0)
    trip = sample_negative(len(train), n_items, len(items), train, seed=1)
    cols = torch.from_numpy(np.ascontiguousarray(trip[:, :3].T)).cuda()
    batches = [tuple(cols[:, i * B:(i + 1) * B].long())
               for i in range(GRAPHREC_STEPS)]
    runs = {}
    for capture in (False, True):
        model = LightGCN(cfg, graph, device="cuda")
        model.part.use_freq = True
        step = model.build_step(capture)
        assert step.graphed is capture
        state, losses = model.init(), []
        for i, batch in enumerate(batches):
            replay = capture and i > WARMUP_CALLS
            with _no_sync() if replay else contextlib.nullcontext():
                state, loss = step(state, *batch)
                losses.append(loss.clone())
        torch.cuda.synchronize()
        runs[capture] = (to_numpy(state), torch.stack(losses).cpu(), step)
    (e_state, e_loss, _), (g_state, g_loss, g_step) = runs[False], runs[True]
    assert g_step.replays == GRAPHREC_STEPS - WARMUP_CALLS
    # K3 (segment_rows) 7 a step: three layers' messages, their
    # backward and the apply
    assert g_step.launches_per_replay() == dict(
        {"rowsum": 7}, **({"land_max": 1} if cr < 1 else {}))
    np.testing.assert_allclose(g_loss.numpy(), e_loss.numpy(), rtol=1e-5)
    _graphrec_close(g_state, e_state)
    if cr < 1:
        assert int((g_state["sketch"]["dic"] != 0).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("ratio", [1, 4])
def test_pinsage_graphed_steps_equal_eager(ratio):
    """PinSAGE's built train step (Adam) graphed against eager from one
    state over GRAPHREC_STEPS blocks, then its representation step on
    four blocks of the trained states; a graphed step built for one lr
    raises on another."""
    _card()
    from cafe_tpu_torch.models.graphrec import (
        PinSAGE, PinSAGEConfig, RandomWalkSampler)
    from cafe_tpu_torch.models.graphrec.pinsage import block_args
    train, _, n_items = _interactions()
    item_users = [[] for _ in range(n_items)]
    for u, its in enumerate(train):
        for it in its:
            item_users[int(it)].append(u)
    sampler = RandomWalkSampler(train, [np.asarray(x, np.int32)
                                        for x in item_users], seed=1)
    cfg = PinSAGEConfig(hidden_dims=16, compress_ratio=ratio,
                        sketch_threshold=2.0)
    models = {c: PinSAGE(cfg, n_items, device="cuda") for c in (False, True)}
    for m in models.values():
        m.part.use_freq = True
    blocks = [block_args(models[True].make_batch(sampler, B))
              for _ in range(GRAPHREC_STEPS)]
    reps = [block_args(models[True].make_block(
        sampler, np.arange(i * B, (i + 1) * B, dtype=np.int32) % n_items))
        for i in range(4)]
    runs = {}
    for capture, model in models.items():
        step = model.build_train_step(GRAPHREC_LR, capture)
        rep = model.build_representation_step(capture)
        assert step.graphed is capture and rep.graphed is capture
        state, losses, zs = model.init(), [], []
        for i, block in enumerate(blocks):
            replay = capture and i > WARMUP_CALLS
            with _no_sync() if replay else contextlib.nullcontext():
                state, loss = step(state, *block, GRAPHREC_LR)
                losses.append(loss.clone())
        for i, block in enumerate(reps):
            replay = capture and i > WARMUP_CALLS
            with _no_sync() if replay else contextlib.nullcontext():
                zs.append(rep(state, *block).clone())
        torch.cuda.synchronize()
        runs[capture] = (to_numpy(state), torch.stack(losses).cpu(),
                         torch.stack(zs).cpu(), step, rep)
        if capture:
            with pytest.raises(ValueError, match="built for lr"):
                step(state, *blocks[0], GRAPHREC_LR / 2)
    (e_state, e_loss, e_z, _, _) = runs[False]
    (g_state, g_loss, g_z, g_step, g_rep) = runs[True]
    assert g_step.replays == GRAPHREC_STEPS - WARMUP_CALLS
    assert g_rep.replays == 4 - WARMUP_CALLS
    # K3 (segment_rows) 4 a step: three gathers' backward and the apply
    assert g_step.launches_per_replay() == dict(
        {"rowsum": 4}, **({"land_max": 1} if ratio > 1 else {}))
    np.testing.assert_allclose(g_loss.numpy(), e_loss.numpy(), rtol=1e-5)
    _graphrec_close(g_state, e_state)
    np.testing.assert_allclose(g_z.numpy(), e_z.numpy(), rtol=1e-5,
                               atol=1e-5)
