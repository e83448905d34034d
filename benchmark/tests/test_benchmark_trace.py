"""The trace's reduction and the per-layer readers on a made-up trace."""

import pytest

from benchmark import core, trace
from benchmark.counts.kernel_bytes import land_bytes
from benchmark.counts.layout import layout

MAN = core.manifest()
MS = 1_000_000


def _trace():
    # window [0, 10 ms); kernels: a gemm 0-2, K1 2-3, a copy 2.5-4 (it
    # overlaps K1), a gemm 6-7; a span mirrored on the device
    device = [("sm90_xmma_gemm_f32f32", 0, 2 * MS),
              ("void (anonymous namespace)::land_max_kernel<5>", 2 * MS, MS),
              ("Memcpy DtoD", int(2.5 * MS), int(1.5 * MS)),
              ("ampere_sgemm_128x64_nn", 6 * MS, MS),
              ("late kernel", 11 * MS, MS)]
    host = [(trace.WINDOW, 0, 10 * MS),
            ("cudaGraphLaunch", 3 * MS, 2 * MS),
            ("bench.dispatch", 3 * MS, 4 * MS),
            ("cudaDeviceSynchronize", 8 * MS, 2 * MS)]
    return trace.Trace(device, host, (0, 10 * MS))


def test_benchmark_busy_and_gaps():
    tr = _trace()
    assert trace.busy_intervals(trace.in_window(tr)) == [(0, 4 * MS),
                                                         (6 * MS, 7 * MS)]
    assert trace.device_busy_s(tr) == pytest.approx(5e-3)
    assert trace.window_s(tr) == pytest.approx(1e-2)
    assert trace.idle_gaps(tr) == [(4 * MS, 6 * MS), (7 * MS, 10 * MS)]
    b = trace.breakdown(tr)
    assert b["device_ops"][0] == ["sm90_xmma_gemm_f32f32", 2e-3]
    # the gap at 4 ms opens inside the graph launch (the shortest host
    # op covering it); the one at 7 ms between host ops
    assert b["idle_gaps"] == [["(host in Python, no op)", 3e-3],
                              ["cudaGraphLaunch", 2e-3]]


def _ctx(tr, entry="train"):
    lay = layout(core.config(MAN, "dlrm_kaggle_cafe"))
    return {"trace": tr, "entry": entry, "batch": 2048,
            "steps_per_dispatch": 1, "traced_calls": 2, "traced_steps": 2,
            "host_probe_ms": [0.5, 0.7], "examples_per_s": 1e6,
            "launches": {}, "card": "NVIDIA H100 80GB HBM3", "layout": lay,
            "train_flops_per_example": 3e6}


def test_benchmark_per_layer_readers():
    ctx = _ctx(_trace())
    read = {m: core.metric_reader(m).read(ctx) for m in (
        "train_mfu", "train_idle_pct", "train_gemm_ms", "train_sparse_ms",
        "land_roofline_pct", "train_dispatch_host_ms")}
    assert read["train_mfu"] == pytest.approx(100 * 3e12 / 989e12)
    assert read["train_idle_pct"] == pytest.approx(50.0)
    assert read["train_gemm_ms"] == pytest.approx(1.5)       # 3 ms / 2
    assert read["train_sparse_ms"] == pytest.approx(1.25)    # 2.5 ms / 2
    t_min = land_bytes(2048 * 26, 5, 9646) / 3.35e12
    assert read["land_roofline_pct"] == pytest.approx(100 * t_min / 1e-3)
    assert read["train_dispatch_host_ms"] == pytest.approx(0.6)
    ev = _ctx(_trace(), "eval")
    assert core.metric_reader("train_mfu").read(ev) is None


def test_benchmark_readers_read_nothing_on_the_cpu():
    ctx = dict(_ctx(_trace()), card="cpu")
    for m in MAN["per_layer"]:
        if m["name"] != "train_dispatch_host_ms":
            assert core.metric_reader(m["name"]).read(ctx) is None, m["name"]


def test_benchmark_unknown_card_raises():
    ctx = dict(_ctx(_trace()), card="an unknown card")
    with pytest.raises(ValueError):
        core.metric_reader("train_mfu").read(ctx)
