"""The port's spans in a made-up trace (benchmark/spans.py) and the
per-layer readers over them."""

import sys

import pytest

from benchmark import core, spans, trace

MAN = core.manifest()
US = 1_000
NEW = ("embed_gather_ms", "towers_ms", "sketch_insert_ms", "migrate_ms",
       "table_update_ms", "step_bubble_pct", "dispatch_idle_pct",
       "migrate_useful_pct")
SPAN_OF = {"embed_gather_ms": "embed_gather", "towers_ms": "towers",
           "sketch_insert_ms": "cafe_insert", "migrate_ms": "cafe_migrate",
           "table_update_ms": "cafe_update"}


def _b(name):
    return "cafe_span_begin_" + name


def _e(name):
    return "cafe_span_end_" + name


def _step(t0):
    """One step's device ops from t0 (us): marks of 1 us each; the gather
    10, a self op 3, the towers' GEMM 20, the insert 6 with a K1 launch 2
    inside, the migration 4, the update 5, the counter."""
    ops, t = [], t0

    def op(name, d):
        nonlocal t
        ops.append((name, t * US, d * US))
        t += d + 1                     # a 1 us gap after each op

    op(_b("step"), 1)
    op(_b("embed_gather"), 1)
    op("vectorized_gather_kernel", 10)
    op(_e("embed_gather"), 1)
    op("elementwise_kernel", 3)
    op(_b("towers"), 1)
    op("sm90_xmma_gemm_f32f32", 20)
    op(_e("towers"), 1)
    op(_b("cafe_insert"), 1)
    op("radix_sort", 4)
    op("land_max_kernel", 2)
    op(_e("cafe_insert"), 1)
    op(_b("cafe_migrate"), 1)
    op("index_put_kernel", 4)
    op(_e("cafe_migrate"), 1)
    op(_b("cafe_update"), 1)
    op("rowsum_kernel", 5)
    op(_e("cafe_update"), 1)
    op("cafe_span_count", 1)
    op(_e("step"), 1)
    return ops, t


def _trace(steps=2, dispatch=True, marks=True):
    """`steps` steps from 10 us, a batch copy before them (outside every
    span), a window of [0, 200 us); the host's cafe_dispatch range
    covers the first 30 us."""
    device = [("Memcpy HtoD", 2 * US, 5 * US)]
    t = 10
    for _ in range(steps):
        ops, t = _step(t)
        device += ops
    if not marks:
        device = [op for op in device if not spans.is_mark(op[0])]
    host = [(trace.WINDOW, 0, 200 * US)]
    if dispatch:
        host.append(("cafe_dispatch", 0, 30 * US))
    return trace.Trace(device, host, (0, 200 * US))


def _ctx(tr, card="NVIDIA H100 80GB HBM3", steps=2):
    return {"trace": tr, "entry": "train", "batch": 2048,
            "steps_per_dispatch": 1, "traced_calls": steps,
            "traced_steps": steps, "host_probe_ms": [0.5],
            "examples_per_s": 1e6, "launches": {}, "card": card}


def test_benchmark_spans_nested_attribution():
    got = spans.attribute(_trace())
    us = {k: v / US for k, v in got.inclusive.items()}
    assert us == {"step": 2 * (10 + 3 + 20 + 6 + 4 + 5),
                  "embed_gather": 20, "towers": 40, "cafe_insert": 12,
                  "cafe_migrate": 8, "cafe_update": 10}
    # the step's own time: what no child span covers
    assert got.own["step"] == 2 * 3 * US
    assert got.own["towers"] == got.inclusive["towers"]
    assert got.outside == 5 * US
    assert got.outside_ops == {"Memcpy HtoD": 5 * US}
    assert len(got.intervals["step"]) == 2
    assert len(got.intervals["cafe_insert"]) == 2


def test_benchmark_spans_leave_the_marks_out():
    tr = _trace(steps=1)
    got = spans.attribute(tr)
    marks = sum(d for n, _, d in tr.device if spans.is_mark(n))
    assert marks == 13 * US
    every = sum(d for _, _, d in tr.device)
    assert got.inclusive["step"] + got.outside == every - marks
    ctx = _ctx(tr, steps=1)
    read = {m: core.metric_reader(m).read(ctx) for m in SPAN_OF}
    assert read == pytest.approx({"embed_gather_ms": 0.010,
                                  "towers_ms": 0.020,
                                  "sketch_insert_ms": 0.006,
                                  "migrate_ms": 0.004,
                                  "table_update_ms": 0.005})


def test_benchmark_spans_unbalanced_marks():
    """An end with no open span (the window opened inside it) is
    dropped; a span still open at the window's end keeps its ops; an end
    closes the spans opened inside its own."""
    dev = [(_e("towers"), 0, US), ("a", 2 * US, US),
           (_b("step"), 4 * US, US), (_b("towers"), 6 * US, US),
           ("b", 8 * US, 2 * US), (_e("step"), 11 * US, US),
           (_b("step"), 13 * US, US), ("c", 15 * US, 4 * US)]
    got = spans.attribute(trace.Trace(dev, [], (0, 30 * US)))
    assert got.outside == US
    assert got.inclusive == {"step": 6 * US, "towers": 2 * US}
    assert got.intervals == {"step": [(4 * US, 12 * US)]}


def test_benchmark_spans_bubble_inside_step():
    tr = _trace(steps=1)
    # one step: 20 ops of 61 us with a 1 us gap after each, 19 gaps
    # inside the step's interval; 13 us of marks left out of its length
    a, b = spans.attribute(tr).intervals["step"][0]
    assert (a, b) == (10 * US, (10 + 61 + 19) * US)
    want = 100.0 * 19 / (61 + 19 - 13)
    assert spans.bubble_pct(tr) == pytest.approx(want)
    ctx = _ctx(tr, steps=1)
    assert core.metric_reader("step_bubble_pct").read(ctx) == \
        pytest.approx(want)
    # an op on another stream inside the gaps fills them
    filled = trace.Trace(tr.device + [("other", a, b - a)], tr.host,
                         tr.window)
    assert spans.bubble_pct(filled) == pytest.approx(0.0)


def test_benchmark_spans_idle_inside_and_outside_dispatch():
    tr = _trace(steps=2)
    gaps = trace.idle_gaps(tr)
    total = sum(e - s for s, e in gaps)
    inside = sum(e - s for s, e in gaps if s < 30 * US)
    assert 0 < inside < total
    want = 100.0 * inside / total
    assert spans.dispatch_idle_pct(tr) == pytest.approx(want)
    assert core.metric_reader("dispatch_idle_pct").read(_ctx(tr)) == \
        pytest.approx(want)
    # a range around the whole window takes every gap
    whole = trace.Trace(tr.device, tr.host + [("cafe_dispatch", 0,
                                               200 * US)], tr.window)
    assert spans.dispatch_idle_pct(whole) == pytest.approx(100.0)


def test_benchmark_spans_read_nothing_on_the_cpu_or_without_marks():
    cpu = _ctx(_trace(), card="cpu")
    for m in NEW:
        assert core.metric_reader(m).read(cpu) is None, m
    bare = _ctx(_trace(marks=False, dispatch=False))
    assert spans.attribute(bare["trace"]) is None
    for m in NEW:
        if m != "migrate_useful_pct":
            assert core.metric_reader(m).read(bare) is None, m


def test_benchmark_migrate_useful_pct_on_stubbed_counters(monkeypatch):
    from cafe_tpu_torch.utils import spans as port_spans
    reader = core.metric_reader("migrate_useful_pct")
    ctx = _ctx(_trace())
    monkeypatch.setattr(port_spans, "counters", lambda: {
        "promotions": 7, "migration_lanes": 8 * 4096})
    assert reader.read(ctx) == pytest.approx(100.0 * 7 / (8 * 4096))
    monkeypatch.setattr(port_spans, "counters", lambda: {
        "promotions": 0, "migration_lanes": 0})
    assert reader.read(ctx) is None
    # a port without the counters (the module cannot be imported)
    monkeypatch.setitem(sys.modules, "cafe_tpu_torch.utils.spans", None)
    assert reader.read(ctx) is None


def test_benchmark_span_metrics_in_the_manifest():
    cells = [w["name"] for w in MAN["workloads"]]
    entries = {m["name"]: m for m in MAN["per_layer"]}
    layers = {m["layer"] for m in MAN["per_layer"]
              if m["name"] not in NEW}
    assert [m["name"] for m in MAN["per_layer"]][-len(NEW):] == list(NEW)
    for name in NEW:
        m = entries[name]
        assert m["workloads"] == cells
        assert m["moves"] == "train_examples_per_s"
        assert m["source"] == ("program_counter"
                               if name == "migrate_useful_pct"
                               else "program_span")
        assert m["layer"] in layers, m
        assert callable(core.metric_reader(name).read)
