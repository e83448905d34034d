"""Spans and counters inside the port's train step, readable in a
replayed CUDA graph.

A replayed graph runs no Python, so a host range opened inside the step
(torch.profiler.record_function) is recorded once, at the capture, and
never again. A span here is also a pair of mark kernels captured into
the graph (kernels/span.cu): `cafe_span_begin_<name>` and
`cafe_span_end_<name>`, one-thread kernels that do nothing, so a
profiler's device trace shows every replay's spans in stream order, on
the clock of its host ops, and a reader books each device op to the
innermost span open at its start (benchmark/spans.py).

`span(name, device)` is a context manager:

* a GraphedStep (train/capture.py) captures its step twice: once with
  the marks, the graph it replays while the profiler is on, and once
  without them, the graph the step alone makes, which it replays while
  the profiler is off (`capturing`);
* outside a capture, on the card, the marks launch while the profiler is
  on, and nothing otherwise;
* while the profiler is on it is also a host range of the same name
  (`record_function`), on the CPU too;
* inside `muted()` (a mesh's step) it is that host range only.

A span inside a conditional body being captured (utils/cond.cond)
captures no mark: a span around a branch wraps its conditional node
whole (`cafe_insert`). The spans, one name each:

  step          each train step (each of the k sub-steps of a dispatch)
  embed_gather  the embedding layer's gather
  towers        the feature transform, the model, the loss and its
                backward (autograd.grad)
  cafe_insert   CAFE's score and sketch insert with its promotion cap
                (around the device branch at an insert interval > 1)
  cafe_migrate  CAFE's migration writes
  cafe_update   CAFE's table update

Counters (`counters()`), over the calls made while the profiler is on.
The first span, counter or GraphedStep call that finds the profiler on
after one that found it off zeroes them, so a traced window after an
untraced call counts its own calls:

  promotions       promotions landed, CAFE's p_mask.sum() a step, added
                   up on the device (kernel cafe_span_count, captured
                   with the marks)
  migration_lanes  the lanes CAFE's migration writes, a host count: a
                   graph credits the lanes its capture recorded at each
                   replay, as kernels/build.py credits launches

CAFE's inserts that ran are counted already, by K1's launches and
utils/cond.branch_runs().
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, Optional

import torch

from ..kernels import build
from . import cond as _cond

SPANS = ("step", "embed_gather", "towers", "cafe_insert", "cafe_migrate",
         "cafe_update")
_INDEX = {name: i for i, name in enumerate(SPANS)}
_COUNTER = 2 * len(SPANS)          # _launched's kind of the counter

_TRACING = False      # the profiler was on at the last look
_LANES = 0            # migration_lanes
_TOTALS: Dict[torch.device, torch.Tensor] = {}   # promotions, a device
_CAPTURE = None       # the Marks of the GraphedStep capturing now
_MUTED = 0            # depth of muted() contexts
_API = None


def profiler_on() -> bool:
    return torch.autograd._profiler_enabled()


def tracing() -> bool:
    """Whether the profiler is on (one host read). The first look that
    finds it on after one that found it off zeroes the counters. A
    capture does not look: it takes the last look's answer."""
    global _TRACING, _LANES
    if _capturing():
        return _TRACING
    on = profiler_on()
    if on != _TRACING:
        _TRACING = on
        if on:
            _LANES = 0
            for t in _TOTALS.values():
                t.zero_()
    return on


def record_function(name: str, device: torch.device):
    """A host range of the profiler's around work on `device`. For the
    card, one the profiler does not mirror on the device's timeline
    (torch.profiler.record_function's user ranges show there as device
    ops spanning the kernels they launched); for the CPU a user range,
    which line attribution on the CPU (tools/profile_lines_torch.py,
    the outermost operators standing in for kernels) does not take for
    an operator."""
    if device.type == "cuda":
        return torch._C._profiler._RecordFunctionFast(name)
    return torch.profiler.record_function(name)


def host_range(name: str, device, on: Optional[bool] = None):
    """A host range named `name` around work on `device` while the
    profiler is on (`on`, where the caller has looked already), else a
    context that does nothing."""
    if profiler_on() if on is None else on:
        return record_function(name, torch.device(device))
    return contextlib.nullcontext()


def counters() -> Dict[str, int]:
    """{"promotions", "migration_lanes"} over the calls made while the
    profiler was on, since a call last found it turned on (one host read
    of each device's total)."""
    return {"promotions": sum(int(t.sum()) for t in _TOTALS.values()),
            "migration_lanes": _LANES}


def _capturing() -> bool:
    return torch.cuda.is_available() and \
        torch.cuda.is_current_stream_capturing()


def _api():
    """kernels/span.cu, loaded with every kernel in it, its spans held
    against SPANS."""
    global _API
    if _API is None:
        lib = build.load("span.cu")
        vp, i = ctypes.c_void_p, ctypes.c_int
        sigs = {"cafe_span_mark": [vp, i],
                "cafe_span_count_launch": [vp, vp, vp],
                "cafe_span_upload": [vp, vp],
                "cafe_span_load": [], "cafe_span_count_spans": []}
        for name, args in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = args, i
        lib.cafe_span_name.argtypes = [i]
        lib.cafe_span_name.restype = ctypes.c_char_p
        lib.cafe_cuda_error_string.argtypes = [i]
        lib.cafe_cuda_error_string.restype = ctypes.c_char_p
        names = tuple(lib.cafe_span_name(k).decode()
                      for k in range(lib.cafe_span_count_spans()))
        if names != SPANS:
            raise RuntimeError(f"span.cu marks {names}, utils/spans.py "
                               f"{SPANS}")
        _API = lib
        _check(lib.cafe_span_load(), "loading the span kernels")
    return _API


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _API.cafe_cuda_error_string(err).decode() if _API else ""
        raise RuntimeError(f"spans: {what} failed with CUDA error {err} "
                           f"({msg})")


def _key(device) -> torch.device:
    """`device` with its index (the current card's for a bare "cuda")."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return device


def prepare(device) -> None:
    """Load the span kernels and make the device's promotions total, so
    that a capture on `device` loads and allocates nothing for them
    (GraphedStep calls it before each capture)."""
    device = _key(device)
    if device.type != "cuda":
        return
    _api()
    if device not in _TOTALS:
        _TOTALS[device] = torch.zeros(1, dtype=torch.int64, device=device)


class Marks:
    """What one GraphedStep capture recorded of the spans: whether it
    captures their marks (`marked`), how many mark and counter launches
    it captured, and the migration lanes one replay writes."""

    def __init__(self, marked: bool):
        self.marked = marked
        self.launches = 0
        self.lanes = 0

    def credit(self) -> None:
        """Count one replay's migration lanes (a replay while tracing)."""
        global _LANES
        _LANES += self.lanes


@contextlib.contextmanager
def capturing(device, marked: bool):
    """A GraphedStep's capture on `device`: the spans inside capture
    their marks and counters if `marked`, else nothing; the Marks this
    yields records them."""
    global _CAPTURE
    prepare(device)
    rec = _CAPTURE = Marks(marked)
    try:
        yield rec
    finally:
        _CAPTURE = None


@contextlib.contextmanager
def muted():
    """No mark and no count inside (a mesh's step: its graphs hold
    NCCL's kernels and the exchange's branches, which no traced replay
    is tested on); host ranges stay."""
    global _MUTED
    _MUTED += 1
    try:
        yield
    finally:
        _MUTED -= 1


def upload(graph, device) -> None:
    """Upload a captured torch CUDAGraph's instance on the current
    stream, so that its first replay does not (where this torch gives
    the instance, CUDAGraph.raw_cuda_graph_exec)."""
    exec_of = getattr(graph, "raw_cuda_graph_exec", None)
    if exec_of is not None:
        _check(_api().cafe_span_upload(
            exec_of(), torch.cuda.current_stream(device).cuda_stream),
            "uploading a graph")


def _mode(device: torch.device) -> Optional[str]:
    """How a span or counter on `device` acts now: "capture" (captured
    into the marked capture of a GraphedStep), "card" (launched, the
    profiler on), "host" (off the card, the profiler on) or None
    (nothing)."""
    if _MUTED:
        return None
    if device.type != "cuda":
        return "host" if tracing() else None
    if _capturing():
        return "capture" if _CAPTURE is not None and _CAPTURE.marked \
            and not _cond.in_body() else None
    return "card" if tracing() else None


def _launched(how: str, kind: int, stream: int, n: int = 0,
              total: int = 0) -> None:
    """Launch mark `kind` (the counter: 2 * len(SPANS), on `n` and
    `total`) on `stream`; a captured one counts in the capture's
    Marks."""
    if kind == _COUNTER:
        err = _API.cafe_span_count_launch(stream, n, total)
    else:
        err = _API.cafe_span_mark(stream, kind)
    _check(err, "launching a span mark")
    if how == "capture":
        _CAPTURE.launches += 1


@contextlib.contextmanager
def span(name: str, device):
    """The span `name` (one of SPANS) around the work enqueued inside,
    on `device` (module docstring)."""
    mark = 2 * _INDEX[name]
    device = torch.device(device)
    how = _mode(device)
    marks = how in ("capture", "card")
    if marks:
        prepare(device)
    with host_range(name, device):
        stream = torch.cuda.current_stream(device).cuda_stream \
            if marks else None
        if marks:
            _launched(how, mark, stream)
        yield
        if marks:
            _launched(how, mark + 1, stream)


def count_promotions(n: torch.Tensor) -> None:
    """Add `n`, a 0-d int64 tensor on the step's device, to the
    `promotions` counter, on the device (no host read)."""
    how = _mode(n.device)
    if how is None:
        return
    if n.dtype != torch.int64 or n.numel() != 1:
        raise ValueError(f"count_promotions: a 0-d int64, got "
                         f"{n.dtype} {tuple(n.shape)}")
    if how == "host":
        if n.device not in _TOTALS:
            _TOTALS[n.device] = torch.zeros(1, dtype=torch.int64,
                                            device=n.device)
        _TOTALS[n.device].add_(n.reshape(1))
        return
    dev = _key(n.device)
    prepare(dev)
    _launched(how, _COUNTER, torch.cuda.current_stream(dev).cuda_stream,
              n.data_ptr(), _TOTALS[dev].data_ptr())


def count_migration_lanes(lanes: int, device) -> None:
    """Add the `lanes` one migration writes to `migration_lanes`."""
    global _LANES
    how = _mode(torch.device(device))
    if how == "capture":
        _CAPTURE.lanes += int(lanes)
    elif how is not None:
        _LANES += int(lanes)
