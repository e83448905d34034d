"""The traced window: torch.profiler with CPU and CUDA activities, reduced
to the device's operations, its busy time and its idle gaps.

A trace is reduced to plain tuples, so the reduction is tested without a
card: device ops (name, start_ns, dur_ns) and host ops (name, start_ns,
dur_ns), both on the profiler's one clock, and the window (start_ns,
end_ns) of the harness's "bench.window" span.
"""

from __future__ import annotations

from collections import defaultdict
from typing import Dict, List, NamedTuple, Tuple

WINDOW = "bench.window"
TOP = 10


class Trace(NamedTuple):
    device: List[Tuple[str, int, int]]
    host: List[Tuple[str, int, int]]
    window: Tuple[int, int]


def _ns(ev, name: str) -> int:
    fn = getattr(ev, name + "_ns", None)
    if fn is not None:
        return int(fn())
    return int(getattr(ev, name + "_us")() * 1000)


def from_profiler(prof) -> Trace:
    """The reduced trace of a stopped torch.profiler.profile."""
    from torch.autograd import DeviceType
    device, host, window = [], [], None
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        start, dur = _ns(ev, "start"), _ns(ev, "duration")
        if ev.device_type() == DeviceType.CUDA:
            # the window's own span is mirrored on the device's timeline
            if name != WINDOW:
                device.append((name, start, dur))
        else:
            if name == WINDOW:
                window = (start, start + dur)
            host.append((name, start, dur))
    if window is None:
        raise RuntimeError(f"the trace holds no {WINDOW!r} span")
    return Trace(device, host, window)


def in_window(tr: Trace) -> List[Tuple[str, int, int]]:
    """The device ops that start inside the window, clipped to it."""
    w0, w1 = tr.window
    out = []
    for name, s, d in tr.device:
        if w0 <= s < w1:
            out.append((name, s, min(s + d, w1) - s))
    return out


def busy_intervals(ops) -> List[Tuple[int, int]]:
    """The union of the ops' [start, end) intervals, merged, sorted."""
    spans = sorted((s, s + d) for _, s, d in ops)
    merged: List[List[int]] = []
    for s, e in spans:
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def busy_ns(ops) -> int:
    return sum(e - s for s, e in busy_intervals(ops))


def idle_gaps(tr: Trace) -> List[Tuple[int, int]]:
    """[start, end) of every stretch of the window with no device op."""
    w0, w1 = tr.window
    gaps, t = [], w0
    for s, e in busy_intervals(in_window(tr)):
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def host_labels(tr: Trace, times: List[int]) -> List[str]:
    """For each time (ascending), the innermost host op running then: the
    shortest that covers it, other than the window's own span. One sweep
    over the host ops sorted by start."""
    ops = sorted((s, s + d, name) for name, s, d in tr.host if name != WINDOW)
    out, active, i = [], [], 0
    for t in times:
        while i < len(ops) and ops[i][0] <= t:
            active.append(ops[i])
            i += 1
        active = [op for op in active if op[1] > t]
        best = min(active, key=lambda op: op[1] - op[0], default=None)
        out.append(best[2] if best else "(host in Python, no op)")
    return out


def breakdown(tr: Trace) -> Dict[str, list]:
    """{device_ops: the TOP device ops by total seconds, idle_gaps: the
    TOP idle totals in seconds by the host op running as each gap
    opened}."""
    by_op: Dict[str, int] = defaultdict(int)
    for name, _, d in in_window(tr):
        by_op[name] += d
    gaps = idle_gaps(tr)
    by_host: Dict[str, int] = defaultdict(int)
    for (s, e), label in zip(gaps, host_labels(tr, [s for s, _ in gaps])):
        by_host[label] += e - s
    top = sorted(by_op.items(), key=lambda kv: -kv[1])[:TOP]
    worst = sorted(by_host.items(), key=lambda kv: -kv[1])[:TOP]
    return {"device_ops": [[n, v / 1e9] for n, v in top],
            "idle_gaps": [[n, v / 1e9] for n, v in worst]}


def window_s(tr: Trace) -> float:
    return (tr.window[1] - tr.window[0]) / 1e9


def device_busy_s(tr: Trace) -> float:
    return busy_ns(in_window(tr)) / 1e9
