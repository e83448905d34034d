"""CUDA-graph capture of the port's steps: the counterpart of the JAX
package's `jax.jit` of the train step, the K-step dispatch and the eval
step (cafe_tpu/train/step.py:95, :144, :173).

`GraphedStep(fn, carry)` wraps an eager step `fn(state, *batch)` that
runs on the card without reading a value back to the host and without a
shape that depends on the data (train/step.capture_blockers decides that
from the configuration when the step is built). For each batch signature
(the shapes and dtypes of the batch tensors) it

1. runs the first WARMUP_CALLS calls eagerly on a stream of its own:
   they are real steps, and they make what is made lazily (kernel
   libraries, cached constants, cuBLAS and K3 workspaces on that
   stream, autograd's device threads) before any capture;
2. captures the next call on that stream into a torch.cuda.CUDAGraph,
   reading the state it was handed and static batch buffers, and replays
   it once;
3. replays that graph on every later call, after copying the batch into
   the static buffers (an int `valid` is filled into an int32 tensor).

A capture that fails raises: there is no eager retry.

State. The graph reads and writes the tensors of the state it was first
captured with (the JAX step's donated buffers): tables and params update
in place, and the tensors the eager step returns new (the sketch, tick,
step) are copied back into them inside the graph, so every replay starts
from the last one's result. Every call returns that state object. A call
with a state whose tensors are not those (a checkpoint reload, a bridged
state, an eager step's output) first copies them in, leaf by leaf, so a
replay never runs on stale buffers; the caller's state is left as it
was. With `carry` False (the eval step) nothing is written back, and the
call returns the graph's output tensor, which the next replay overwrites.

Launch counts. A kernel call made while a graph is captured launches
nothing and adds to the kernel's `captured` count (kernels/build.py);
the graph keeps what its capture added and adds it to each kernel's
`launches` at every replay, so `launches` counts the kernels that ran.

Branches. `cond` (utils/cond.py, re-exported here) is the port's
`lax.cond`: inside a capture each branch becomes a conditional IF node
of the graph, so a replay runs the branch the card picks; the warm-up
calls also run the untaken branch on clones, so its lazy constants and
kernels exist before the capture. A body's launches count on the
replays that ran it (its device counter is read when a kernel's count
is next read or set, kernels/build.settle, also when the graph is gone
by then).

Meshes. A mesh step (train/step.py with a mesh) captures as one device's
does, on every rank: its NCCL collectives and K5 launches land in the
graph. At world size 1 a branch body may hold collectives too (the
exchange's full-size legs, the sharded insert's candidate all-gather),
as the JAX package's lax.conds under shard_map do; on more than one
rank the card refuses NCCL's work inside a conditional body, so
train/step.capture_blockers keeps such a step eager there (K5 is
captured in a body at any world size). Every rank calls the step with
the same
batch signatures in the same order, so the ranks warm up, run their
spare branches, capture and replay in the same order and the captured
collectives pair up; each branch predicate is the same on every rank
(parallel/exchange.any_rank). The warm-up calls create every NCCL
communicator and K5 workspace the step uses (the spare runs those of
the untaken branches), so a capture creates none.

Spans (utils/spans.py). A step that opens spans is captured twice
from the same static batch buffers, into one memory pool: first with
the spans' mark kernels, then without them. Each call reads whether the
profiler is on (one host bool) and replays the graph with the marks if
it is, else the graph the step alone makes; both are instantiated and
uploaded at the capture, so turning the profiler on instantiates
nothing. While it is on, a call is the host range `cafe_dispatch`,
holding `cafe_load` (the batch copies into the static buffers) and
`cafe_replay`, and each replay credits the migration lanes its capture
recorded.

Host steps. A step that must run eagerly at some steps (AdaEmbed's
sampled check and rebuild) gives its GraphedStep a StepMirror: the
device step counter and which steps are host steps. The GraphedStep
keeps a host mirror of that counter, read from the device when a state
is adopted or copied in and advanced by the steps a call takes; a call
that holds a host step runs eagerly on the graph's own state buffers,
every other call replays. `check_mirror` holds the mirror against the
device counter (train/loop.py, at every fence).
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, NamedTuple, Optional, Tuple

import torch

from ..kernels import KERNELS, build
from ..utils import cond as _cond
from ..utils import spans
from ..utils.cond import (branch_runs, cond, conditional_node_blocker,
                          copy_into, host_pred)
from ..utils.timing import tensors_of

__all__ = ["GraphedStep", "StepMirror", "WARMUP_CALLS", "branch_runs",
           "cond", "conditional_node_blocker", "copy_into", "host_pred"]

# eager calls of each batch signature before its capture
WARMUP_CALLS = 2
# the capture's cudaStreamCaptureMode: "thread_local" lets threads other
# than the capturing one (the NCCL process group's watchdog, which
# queries the events of earlier collectives) call the CUDA runtime
# during a capture
CAPTURE_MODE = "thread_local"


# ---------------------------------------------------------------- steps

class StepMirror(NamedTuple):
    """A step with host steps: its device step counter (a 0-d int tensor
    of the state) and which steps (the counter's value after the step)
    must run eagerly."""
    counter: Callable
    host_step: Callable[[int], bool]


def _signature(batch):
    return tuple(None if x is None else
                 ("int",) if isinstance(x, int) else
                 (tuple(x.shape), x.dtype, x.device) for x in batch)


def _static(x, device):
    """A buffer for one batch argument: an int becomes an int32 scalar."""
    if x is None:
        return None
    if isinstance(x, int):
        return torch.zeros((), dtype=torch.int32, device=device)
    return torch.empty_like(x)


class _Graph:
    """One captured call: the graph, its static batch buffers, its
    outputs, the kernel launches one replay makes outside branch bodies,
    its branches (utils/cond._Capture), its spans (utils/spans.Marks)
    and the graph replayed instead while the profiler is on (`traced`;
    None where the step opens no span: no reference back to this one,
    so a dropped graph is freed at once, never by a cyclic collection
    inside a later capture)."""

    def __init__(self, graph, batch, out, launches, capture_s, cap,
                 marks=None):
        self.graph = graph
        self.batch = batch
        self.out = out
        self.launches = launches
        self.capture_s = capture_s
        self.cap = cap
        self.bodies = cap.bodies
        self.marks = marks
        self.traced = None

    def load(self, batch) -> None:
        for dst, x in zip(self.batch, batch):
            if dst is None:
                continue
            if isinstance(x, int):
                dst.fill_(x)
            else:
                dst.copy_(x)

    def replay(self, tracing: bool = False) -> None:
        self.graph.replay()
        for kern, n in self.launches.items():
            kern.add_launches(n, in_graph=True)
        if self.bodies:
            # credited at the next count read, even if this graph is
            # gone by then
            build.PENDING.add(self.cap)
        if tracing and self.marks is not None:
            self.marks.credit()


class GraphedStep:
    """`fn` replayed as CUDA graphs, one per batch signature (module
    docstring). `graphed` is True; `__wrapped__` is `fn`, the eager
    in-place step. With a `mirror`, each call takes `steps_per_call`
    steps, and a call that holds a host step runs eagerly."""

    graphed = True
    capture_blockers = ()

    def __init__(self, fn, carry: bool, mirror: Optional[StepMirror] = None,
                 steps_per_call: int = 1):
        self.__wrapped__ = fn
        self.carry = carry
        self.mirror = mirror
        self.steps_per_call = steps_per_call
        self.state = None
        self.step_seen = None      # the host mirror of mirror.counter
        self.replays = 0
        self.host_calls = 0
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm: Dict[tuple, int] = {}
        self._streams: Dict[tuple, torch.cuda.Stream] = {}

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing, all signatures."""
        return sum(g.capture_s for g in self._graphs.values())

    def launches_per_replay(self, sig: Optional[tuple] = None
                            ) -> Dict[str, int]:
        """{kernel name: launches one replay makes outside branch bodies}
        of the graph of `sig` (default: the only one)."""
        g = self._graph_of(sig)
        names = {k: name for name, k in KERNELS.items()}
        return {names[k]: n for k, n in g.launches.items()}

    def branch_launches(self, sig: Optional[tuple] = None
                        ) -> List[tuple]:
        """[(cond name, side, {kernel name: launches a run})] of the
        branch bodies of the graph of `sig` (default: the only one)."""
        names = {k: name for name, k in KERNELS.items()}
        return [(b.name, b.side, {names[k]: n for k, n in b.launches.items()})
                for b in self._graph_of(sig).bodies]

    def span_marks(self, sig: Optional[tuple] = None) -> Tuple[int, int]:
        """(mark and counter launches in the graph of `sig` replayed
        while the profiler is off, in the one replayed while it is on)
        (default: the only signature)."""
        g = self._graph_of(sig)
        return g.marks.launches, (g.traced or g).marks.launches

    def _graph_of(self, sig):
        if sig is None:
            if len(self._graphs) != 1:
                raise ValueError(f"{len(self._graphs)} graphs: name one")
            sig = next(iter(self._graphs))
        return self._graphs[sig]

    def _adopt(self, state) -> None:
        if self.state is None:
            self.state = state
        elif state is not self.state:
            copy_into(self.state, state)
        else:
            return
        if self.mirror is not None:
            self.step_seen = int(self.mirror.counter(self.state))

    def check_mirror(self, state=None) -> None:
        """Raise when the host mirror of the step counter differs from
        the device's (one read). A state other than the graph's is copied
        in, and the mirror read from it, at the next call."""
        if self.mirror is None or self.state is None or (
                state is not None and state is not self.state):
            return
        dev = int(self.mirror.counter(self.state))
        if dev != self.step_seen:
            raise RuntimeError(f"GraphedStep: the host mirror of the step "
                               f"counter reads {self.step_seen}, the card "
                               f"{dev}")

    def _host_call_due(self) -> bool:
        return self.mirror is not None and any(
            self.mirror.host_step(self.step_seen + i)
            for i in range(1, self.steps_per_call + 1))

    def __call__(self, state, *batch):
        on = spans.tracing()
        with spans.host_range("cafe_dispatch", "cuda", on):
            return self._call(on, state, batch)

    def _call(self, on: bool, state, batch):
        sig = _signature(batch)
        g = self._graphs.get(sig)
        if g is None:
            dev = next(tensors_of(state)).device
            if sig not in self._streams:
                self._streams[sig] = torch.cuda.Stream(dev)
            stream = self._streams[sig]
            n = self._warm.get(sig, 0)
            if n < WARMUP_CALLS:
                self._warm[sig] = n + 1
                with _cond.warming():
                    return self._eager(stream, state, batch)
            self._adopt(state)
            if self._host_call_due():
                return self._host_call(stream, batch)
            g = self._capture(sig, stream, batch, dev)
        else:
            self._adopt(state)
            if self._host_call_due():
                return self._host_call(self._streams[sig], batch)
        if on and g.traced is not None:
            g = g.traced
        with spans.host_range("cafe_load", "cuda", on):
            g.load(batch)
        with spans.host_range("cafe_replay", "cuda", on):
            g.replay(on)
        self.replays += 1
        if self.step_seen is not None:
            self.step_seen += self.steps_per_call
        return (self.state, g.out) if self.carry else g.out

    def _eager(self, stream, state, batch):
        """One eager call on the signature's stream, ordered after the
        caller's queued work and before its next."""
        main = torch.cuda.current_stream(stream.device)
        stream.wait_stream(main)
        with torch.cuda.stream(stream):
            out = self.__wrapped__(state, *batch)
        main.wait_stream(stream)
        return out

    def _host_call(self, stream, batch):
        """A call that holds a host step: eager, on the graph's own state
        buffers."""
        new_state, out = self._eager(stream, self.state, batch)
        copy_into(self.state, new_state)
        self.host_calls += 1
        self.step_seen += self.steps_per_call
        return self.state, out

    def _capture(self, sig, stream, batch, dev) -> _Graph:
        static = [_static(x, dev) for x in batch]
        t0 = time.perf_counter()
        traced = self._capture_one(static, stream, dev, True, None)
        g = traced
        if traced.marks.launches:
            with torch.cuda.stream(stream):
                spans.upload(traced.graph, dev)
            # the graph the untraced replays run, in the same pool: the
            # two never run at once
            g = self._capture_one(static, stream, dev, False,
                                  traced.graph.pool())
            g.traced = traced
        g.capture_s = time.perf_counter() - t0
        self._graphs[sig] = g
        return g

    def _capture_one(self, static, stream, dev, marked: bool,
                     pool) -> _Graph:
        """One capture of the call on the static buffers, with the spans'
        marks if `marked` (utils/spans.capturing)."""
        before = {k: k.captured for k in KERNELS.values()}
        graph = torch.cuda.CUDAGraph()
        with spans.capturing(dev, marked) as marks, \
                _cond.capturing(graph, dev) as cap, \
                torch.cuda.graph(graph, pool=pool, stream=stream,
                                 capture_error_mode=CAPTURE_MODE):
            out = self.__wrapped__(self.state, *static)
            if self.carry:
                new_state, out = out
                copy_into(self.state, new_state)
        launches = {k: k.captured - n for k, n in before.items()
                    if k.captured > n}
        return _Graph(graph, static, out, launches, 0.0, cap, marks)
