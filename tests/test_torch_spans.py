"""The spans and counters of the train step (utils/spans.py) on the CPU.

On the CPU a span is a host range (record_function) while the profiler
is on, and nothing otherwise; the counters count on the host there. The
card's side (marks captured into a graph, their nodes toggled) is held
in tests/test_torch_capture_cuda.py.

* one eager DLRM + CAFE v1 step under the profiler holds the six spans,
  `step` around the other five, which follow each other in the step's
  order; at insert interval 8 `cafe_insert` wraps the insert's branch
  (a skipped insert still has its span); a k = 8 dispatch holds 8 of
  each;
* the other embedding methods get only `step`, `embed_gather` and
  `towers`;
* with the profiler off no range is opened and the counters stay;
* over a k = 8 dispatch `promotions` equals the dispatch's summed
  `cafe_promotions` and `migration_lanes` 8 x the migration's cap;
  the first call that finds the profiler on after one that found it off
  zeroes them.
"""

import pytest
import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

from cafe_tpu_torch.config import Config
from cafe_tpu_torch.embeddings import CafePart
from cafe_tpu_torch.embeddings import cafe as cafe_mod
from cafe_tpu_torch.sketch import PROMO_LANES
from cafe_tpu_torch.train import build_all, build_multi_step, get_dataset
from cafe_tpu_torch.utils import spans

torch.set_num_threads(1)

B = 64
KW = dict(dataset="synthetic", synthetic_rows=4096, synthetic_fields=4,
          synthetic_vocab=2000, synthetic_dense=4, synthetic_zipf=1.2,
          embedding_dim=8, mini_batch_size=B, compress_method="cafe",
          compress_rate=0.05, cafe_sketch_threshold=2.0, cafe_use_freq=True,
          learning_rate=0.1, cafe_mig_lanes=1)
CHILDREN = ("embed_gather", "towers", "cafe_insert", "cafe_migrate",
            "cafe_update")


def _build(k=1, **kw):
    """(embedding layer, state, step of k sub-steps, batches of k * B
    rows) on the CPU."""
    cfg = Config(**dict(KW, **kw))
    data = get_dataset(cfg, "train")
    _, embed, state, step, _ = build_all(cfg, data, device="cpu")
    if k > 1:
        step = build_multi_step(step, k, donate=True)
    rows = k * B
    batches = [tuple(torch.from_numpy(a[i:i + rows]) for a in
                     (data.dense, data.sparse, data.label))
               for i in range(0, len(data) - rows + 1, rows)]
    return embed, state, step, batches


def _ranges(fn):
    """fn() under the CPU profiler; returns (fn's result, [(name, start,
    end)] of the span host ranges by start)."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        out = fn()
    got = [(ev.name(), ev.start_ns(), ev.start_ns() + ev.duration_ns())
           for ev in prof.profiler.kineto_results.events()
           if ev.device_type() == DeviceType.CPU
           and ev.name() in spans.SPANS + ("cond_node",)]
    return out, sorted(got, key=lambda r: r[1])


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


@pytest.mark.parametrize("interval", [1, 8])
def test_spans_nest_as_listed(interval, monkeypatch):
    """Two eager steps (at interval 8 the first inserts, the second
    skips): each is one `step` range holding the five others, in the
    step's order and apart; at interval 8 the insert's branch (its cond)
    runs inside `cafe_insert`."""
    real_cond = cafe_mod.cond

    def cond_node(*args, **kw):
        with torch.profiler.record_function("cond_node"):
            return real_cond(*args, **kw)

    monkeypatch.setattr(cafe_mod, "cond", cond_node)
    _, state, step, batches = _build(cafe_insert_interval=interval)

    def two_steps():
        s = state
        for i in range(2):
            s, _ = step(s, *batches[i], B)
        return s

    _, got = _ranges(two_steps)
    steps = [r for r in got if r[0] == "step"]
    assert len(steps) == 2
    for st in steps:
        kids = [r for r in got if r[0] in CHILDREN and _inside(r, st)]
        assert [r[0] for r in kids] == list(CHILDREN)
        assert all(a[2] <= b[1] for a, b in zip(kids, kids[1:]))
        conds = [r for r in got if r[0] == "cond_node" and _inside(r, st)]
        if interval > 1:
            insert = next(r for r in kids if r[0] == "cafe_insert")
            assert len(conds) == 1 and _inside(conds[0], insert)
        else:
            assert not conds


def test_k8_dispatch_holds_eight_of_each_span():
    _, state, step, batches = _build(k=8)
    _, got = _ranges(lambda: step(state, *batches[0], 8 * B))
    names = [r[0] for r in got]
    assert {n: names.count(n) for n in spans.SPANS} == {
        n: 8 for n in spans.SPANS}


@pytest.mark.parametrize("method", [
    dict(compress_method="hash", compress_rate=0.2),
    dict(compress_method="qr", compress_rate=0.05)])
def test_other_methods_get_the_step_spans_only(method):
    _, state, step, batches = _build(**method)
    _, got = _ranges(lambda: step(state, *batches[0], B))
    assert sorted({r[0] for r in got}) == ["embed_gather", "step",
                                          "towers"]


def test_no_range_and_no_count_with_the_profiler_off(monkeypatch):
    _, state, step, batches = _build(k=8)
    # a traced call leaves the counters at its own counts
    (state, _), _ = _ranges(lambda: step(state, *batches[0], 8 * B))
    before = spans.counters()
    assert before["migration_lanes"] > 0
    opened = []
    real = spans.record_function

    def counted(name, device):
        opened.append(name)
        return real(name, device)

    monkeypatch.setattr(spans, "record_function", counted)
    for i in range(1, 3):
        state, _ = step(state, *batches[i], 8 * B)
    assert opened == []
    assert spans.counters() == before


def test_counters_over_a_k8_dispatch():
    """`promotions` is the dispatch's summed cafe_promotions (the
    multi-step sums them over its sub-steps), `migration_lanes` 8 x the
    migration's cap; a traced window after an untraced call counts only
    its own call."""
    embed, state, step, batches = _build(k=8)
    part = next(p for p in embed.parts if isinstance(p, CafePart))
    cap = min(B * len(part.field_idx), PROMO_LANES, part.hotn,
              max(part.mig_lanes * 16, 4096))
    counts = []
    assert not spans.tracing()        # a look with the profiler off
    for i in range(2):
        if i:
            state, _ = step(state, *batches[2 * i - 1], 8 * B)
        (state, m), _ = _ranges(lambda: step(state, *batches[2 * i], 8 * B))
        got = spans.counters()
        assert got == {"promotions": int(m["cafe_promotions"]),
                       "migration_lanes": 8 * cap}
        counts.append(got["promotions"])
    assert counts[0] > 0


def test_counters_refuse_a_foreign_dtype():
    with pytest.raises(ValueError, match="0-d int64"):
        with profile(activities=[ProfilerActivity.CPU]):
            spans.count_promotions(torch.zeros((), dtype=torch.int32))


def test_muted_spans_keep_their_host_ranges_and_count_nothing():
    """Inside muted() (a mesh's step) a span is its host range only and
    the counters do not move."""
    def body():
        spans.tracing()
        before = spans.counters()
        with spans.muted(), spans.span("step", "cpu"):
            spans.count_promotions(torch.ones((), dtype=torch.int64))
            spans.count_migration_lanes(7, "cpu")
        return before, spans.counters()

    (before, after), got = _ranges(body)
    assert [r[0] for r in got] == ["step"]
    assert after == before
