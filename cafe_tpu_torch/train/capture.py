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
"""

from __future__ import annotations

import time
from typing import Dict, List, Optional

import torch

from ..kernels import KERNELS
from ..utils.timing import tensors_of

# eager calls of each batch signature before its capture
WARMUP_CALLS = 2


def _leaves(tree, path="") -> List:
    """(path, tensor) pairs of a state tree, dict keys in sorted order."""
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, torch.Tensor):
        return [(path, tree)]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k],
                                                          f"{path}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [x for i, v in enumerate(tree)
                for x in _leaves(v, f"{path}[{i}]")]
    return []


@torch.no_grad()
def copy_into(dst_tree, src_tree) -> int:
    """Copy every tensor of `src_tree` that is not the same object as its
    counterpart in `dst_tree` into it (params that require grad too).
    Returns how many were copied; raises when the trees differ in
    structure, shape or dtype."""
    dst, src = _leaves(dst_tree), _leaves(src_tree)
    if [p for p, _ in dst] != [p for p, _ in src]:
        raise ValueError("GraphedStep: the state's structure differs from "
                         "the captured one")
    n = 0
    for (path, d), (_, s) in zip(dst, src):
        if d is s:
            continue
        if d.shape != s.shape or d.dtype != s.dtype:
            raise ValueError(f"GraphedStep: state leaf {path} is "
                             f"{tuple(s.shape)} {s.dtype}, the graph's "
                             f"{tuple(d.shape)} {d.dtype}")
        d.copy_(s)
        n += 1
    return n


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
    outputs and the kernel launches one replay makes."""

    def __init__(self, graph, batch, out, launches, capture_s):
        self.graph = graph
        self.batch = batch
        self.out = out
        self.launches = launches
        self.capture_s = capture_s

    def load(self, batch) -> None:
        for dst, x in zip(self.batch, batch):
            if dst is None:
                continue
            if isinstance(x, int):
                dst.fill_(x)
            else:
                dst.copy_(x)

    def replay(self) -> None:
        self.graph.replay()
        for kern, n in self.launches.items():
            kern.launches += n
            kern.graph_launches += n


class GraphedStep:
    """`fn` replayed as CUDA graphs, one per batch signature (module
    docstring). `graphed` is True; `__wrapped__` is `fn`, the eager
    in-place step."""

    graphed = True
    capture_blockers = ()

    def __init__(self, fn, carry: bool):
        self.__wrapped__ = fn
        self.carry = carry
        self.state = None
        self.replays = 0
        self._graphs: Dict[tuple, _Graph] = {}
        self._warm: Dict[tuple, int] = {}
        self._streams: Dict[tuple, torch.cuda.Stream] = {}

    @property
    def capture_s(self) -> float:
        """Seconds spent capturing, all signatures."""
        return sum(g.capture_s for g in self._graphs.values())

    def launches_per_replay(self, sig: Optional[tuple] = None
                            ) -> Dict[str, int]:
        """{kernel name: launches one replay makes} of the graph of `sig`
        (default: the only one)."""
        if sig is None:
            if len(self._graphs) != 1:
                raise ValueError(f"{len(self._graphs)} graphs: name one")
            sig = next(iter(self._graphs))
        names = {k: name for name, k in KERNELS.items()}
        return {names[k]: n for k, n in self._graphs[sig].launches.items()}

    def _adopt(self, state) -> None:
        if self.state is None:
            self.state = state
        elif state is not self.state:
            copy_into(self.state, state)

    def __call__(self, state, *batch):
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
                return self._eager(stream, state, batch)
            g = self._capture(sig, stream, state, batch, dev)
        else:
            self._adopt(state)
        g.load(batch)
        g.replay()
        self.replays += 1
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

    def _capture(self, sig, stream, state, batch, dev) -> _Graph:
        self._adopt(state)
        static = [_static(x, dev) for x in batch]
        before = {k: k.captured for k in KERNELS.values()}
        graph = torch.cuda.CUDAGraph()
        t0 = time.perf_counter()
        with torch.cuda.graph(graph, stream=stream):
            out = self.__wrapped__(self.state, *static)
            if self.carry:
                new_state, out = out
                copy_into(self.state, new_state)
        capture_s = time.perf_counter() - t0
        launches = {k: k.captured - n for k, n in before.items()
                    if k.captured > n}
        g = _Graph(graph, static, out, launches, capture_s)
        self._graphs[sig] = g
        return g
