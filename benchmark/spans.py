"""The port's spans in a traced window (cafe_tpu_torch/utils/spans.py).

The port marks each span with two one-thread kernels captured into its
CUDA graph, `cafe_span_begin_<span>` and `cafe_span_end_<span>`, and
counts promotions with a third, `cafe_span_count`; the GraphedStep's call
is the host range `cafe_dispatch`. On one stream the marks run in the
order the step enqueued them, so each device op is booked to the
innermost span open at its start. The marks' own device time (every op
named `cafe_span_*`) is left out of every span's time. Pure functions of
a `trace.Trace`: tested on made-up traces.
"""

from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, NamedTuple, Optional, Tuple

from benchmark import trace

PREFIX = "cafe_span_"
BEGIN, END = PREFIX + "begin_", PREFIX + "end_"
DISPATCH = "cafe_dispatch"


class Spans(NamedTuple):
    """Device ns of the window's ops by span: `own` (the innermost open
    span), `inclusive` (every open span), `outside` (no span open), the
    ops outside every span by name, and each span's [begin's start, end's
    end) intervals in the window."""
    own: Dict[str, int]
    inclusive: Dict[str, int]
    outside: int
    outside_ops: Dict[str, int]
    intervals: Dict[str, List[Tuple[int, int]]]


def is_mark(name: str) -> bool:
    return name.startswith(PREFIX)


def attribute(tr: trace.Trace) -> Optional[Spans]:
    """Book the window's device ops to the spans; None where the window
    holds no mark. An end mark closes the innermost open span of its
    name (and any opened inside it); one with no open span is dropped,
    as a span still open at the window's end keeps its ops."""
    ops = sorted(trace.in_window(tr), key=lambda op: op[1])
    if not any(is_mark(name) for name, _, _ in ops):
        return None
    own: Dict[str, int] = defaultdict(int)
    inclusive: Dict[str, int] = defaultdict(int)
    outside_ops: Dict[str, int] = defaultdict(int)
    intervals: Dict[str, List[Tuple[int, int]]] = defaultdict(list)
    stack: List[Tuple[str, int]] = []
    outside = 0
    for name, s, d in ops:
        if name.startswith(BEGIN):
            stack.append((name[len(BEGIN):], s))
        elif name.startswith(END):
            span = name[len(END):]
            at = [i for i, (n, _) in enumerate(stack) if n == span]
            if at:
                i = at[-1]
                intervals[span].append((stack[i][1], s + d))
                del stack[i:]
        elif is_mark(name):
            continue
        elif stack:
            own[stack[-1][0]] += d
            for span in {n for n, _ in stack}:
                inclusive[span] += d
        else:
            outside += d
            outside_ops[name] += d
    return Spans(dict(own), dict(inclusive), outside, dict(outside_ops),
                 dict(intervals))


def span_ms_a_step(ctx, span: str) -> Optional[float]:
    """Device ms a training step inside `span` (its children included),
    the marks left out; None on the CPU or where the trace holds no
    mark."""
    if ctx["entry"] != "train" or ctx["card"] == "cpu":
        return None
    got = attribute(ctx["trace"])
    if got is None:
        return None
    return got.inclusive.get(span, 0) / 1e6 / ctx["traced_steps"]


def _overlap(merged: List[Tuple[int, int]], starts: List[int], a: int,
             b: int) -> int:
    """ns of [a, b) covered by `merged` (sorted, disjoint; `starts` their
    starts)."""
    i = max(bisect.bisect_right(starts, a) - 1, 0)
    out = 0
    while i < len(merged) and merged[i][0] < b:
        out += max(0, min(b, merged[i][1]) - max(a, merged[i][0]))
        i += 1
    return out


def bubble_pct(tr: trace.Trace, span: str = "step") -> Optional[float]:
    """The share, in %, of `span`'s device intervals in which no device
    op runs, the marks' own time left out of the intervals; None where
    the window holds no such interval."""
    got = attribute(tr)
    if got is None or not got.intervals.get(span):
        return None
    ops = trace.in_window(tr)
    busy = trace.busy_intervals(ops)
    marks = trace.busy_intervals([op for op in ops if is_mark(op[0])])
    b0, m0 = [s for s, _ in busy], [s for s, _ in marks]
    length = idle = 0
    for a, b in got.intervals[span]:
        mark_ns = _overlap(marks, m0, a, b)
        length += (b - a) - mark_ns
        idle += (b - a) - _overlap(busy, b0, a, b)
    return 100.0 * idle / length if length > 0 else None


def dispatch_idle_pct(tr: trace.Trace) -> Optional[float]:
    """The share, in %, of the window's idle time in gaps that open while
    the host is inside a `cafe_dispatch` range; None where the window
    holds no such range."""
    w0, w1 = tr.window
    ranges = sorted((s, s + d) for name, s, d in tr.host
                    if name == DISPATCH and s < w1 and s + d > w0)
    if not ranges:
        return None
    gaps = trace.idle_gaps(tr)
    total = sum(e - s for s, e in gaps)
    if total == 0:
        return 0.0
    starts = [s for s, _ in ranges]
    inside = 0
    for s, e in gaps:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and ranges[i][1] > s:
            inside += e - s
    return 100.0 * inside / total
