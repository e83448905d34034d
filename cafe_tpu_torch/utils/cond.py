"""The port's `lax.cond` (train/capture.py re-exports it; this module
sits below the train package so the sketches and the embedding parts can
import it).

`cond(pred, true_fn, false_fn, operands)` takes a branch on the device's
predicate. Inside a GraphedStep's capture each branch becomes a CUDA
graph conditional IF node, so a replay runs only the branch the card
picks. The nodes are made as torch's CUDAGraph.begin_capture_to_if_node
makes them, through the CUDA runtime (kernels/graph_cond.cu), since not
every torch build has that call: a kernel sets the node's condition from
`pred`, and the body captures on a stream of its own, its allocations
coming from a memory pool of its own that lives as long as the graph.
As in torch/_higher_order_ops/cudagraph_conditional_nodes.py, an if-else
is two IF nodes, on `pred` and on `not pred`, and the else body copies
its outputs into the if body's buffers; with no else branch
(`false_fn` None) it is one IF node whose body writes in place into its
operands and returns nothing. Anywhere else (an eager step
on the card, the CPU) it reads `pred` once on the host, through
`host_pred`, and runs one branch. During a GraphedStep's warm-up calls
it also runs the branch not taken, on clones of its operands, so both
bodies have made their lazy constants and loaded their kernels before
the capture; the kernels those spare runs launch count in each kernel's
`launches` and also in its `spare_launches`. Each body adds one to its
own slot of the capture's device
counter when it runs; the graph reads the counter when a kernel count is
next read (kernels/build.settle) and credits each body's kernel launches
and runs (`branch_runs`) by the replays that ran it. The launches made
inside a body (an eager run of the branch taken or a replay of the
body) also count in each kernel's `body_launches`, and `in_body` tells
code whether it runs inside a body (the collective recorder marks the
collectives it records there, parallel/exchange.py).
"""

from __future__ import annotations

import contextlib
import ctypes
import weakref
from typing import Dict, List, NamedTuple, Optional

import torch

from ..kernels import KERNELS, build
from .timing import tensors_of

# conditional bodies one captured graph may hold (slots of its counter)
MAX_BODIES = 1024


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


# runs of each branch by name, {name: [false runs, true runs]}: "eager"
# (host-read predicates), "graph" (replays that ran the body, counted on
# the card) and "spare" (the untaken branch of a warm-up call, on clones)
_RUNS: Dict[str, Dict[str, List[int]]] = {"eager": {}, "graph": {},
                                          "spare": {}}
_WARMING = False      # in a GraphedStep's warm-up call
_SPARE = 0            # depth of spare (warm-up, untaken) branch runs
_BODY = 0             # depth of branch bodies running or being captured
_CAPTURE = None       # the _Capture of the GraphedStep capturing now


# the caching allocator's calls that route a body's allocations to a
# pool of its own (the body captures on a stream of its own)
_POOL_CALLS = ("_cuda_beginAllocateCurrentThreadToPool",
               "_cuda_endAllocateToPool", "_cuda_releasePool")


def conditional_node_blocker(device) -> Optional[str]:
    """None when a CUDA graph can hold a branch (`cond`) for a step on
    `device` (a CPU step never captures), else why it cannot: the CUDA
    runtime predates conditional nodes (12.4), or this torch's caching
    allocator cannot give a body's stream a memory pool."""
    if torch.device(device).type != "cuda":
        return None
    cuda = torch.version.cuda or "0.0"
    if tuple(int(x) for x in cuda.split(".")[:2]) < (12, 4):
        return (f"CUDA {cuda}: CUDA graph conditional nodes need 12.4, so "
                f"a step with a device-side branch (utils/cond.cond) "
                f"cannot replay")
    missing = [c for c in _POOL_CALLS if not hasattr(torch._C, c)]
    if missing:
        return (f"torch {torch.__version__} lacks {missing}: a branch "
                f"body's allocations cannot get a memory pool, so a step "
                f"with a device-side branch (utils/cond.cond) cannot "
                f"replay")
    return None


def host_pred(pred) -> bool:
    """A branch predicate read on the host: the one host read that a
    step which replays in a CUDA graph makes when it runs eagerly (the
    CPU tests tell it apart from every other read by this function)."""
    return bool(pred)


def branch_runs() -> Dict[str, Dict[str, List[int]]]:
    """{"eager" | "graph" | "spare": {name: [false runs, true runs]}}
    of every `cond` so far (reads the graphs' device counts first)."""
    build.settle()
    return {k: {n: list(v) for n, v in d.items()} for k, d in _RUNS.items()}


def count(where: str, name: str, side: int, n: int = 1) -> None:
    _RUNS[where].setdefault(name, [0, 0])[side] += n


def _map(fn, tree):
    """`tree` with every tensor leaf replaced by fn(leaf)."""
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _map(fn, v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_map(fn, v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(_map(fn, v) for v in tree)
    return tree


def _merge(dst_tree, src_tree, name: str) -> None:
    """Copy the else body's outputs into the if body's (same structure,
    shapes and dtypes, or a ValueError)."""
    dst, src = _leaves(dst_tree), _leaves(src_tree)
    if [p for p, _ in dst] != [p for p, _ in src] or any(
            d.shape != s.shape or d.dtype != s.dtype
            for (_, d), (_, s) in zip(dst, src)):
        raise ValueError(f"cond {name}: the branches return different "
                         f"trees")
    for (_, d), (_, s) in zip(dst, src):
        d.copy_(s)


class _Body(NamedTuple):
    """One conditional body of a captured graph."""
    name: str
    side: int                  # 1: the true branch, 0: the false one
    slot: int                  # its slot in the graph's device counter
    launches: Dict             # {kernel: launches one run makes}


class _Capture:
    """The branches of one capture: a device counter with a slot a body,
    the bodies, their memory pools and predicates. It holds nothing of
    the graph, so kernels/build.PENDING can keep it, and credit the runs
    of its bodies, after the graph is gone."""

    def __init__(self, device):
        self.hits = torch.zeros(MAX_BODIES, dtype=torch.int64,
                                device=device)
        self.seen = None               # hits at the last credit
        self.bodies: List[_Body] = []
        self.slots = 0
        self.pools: List = []          # (device index, pool) a body
        self.preds: List = []

    def credit(self) -> None:
        """Count the bodies that ran since the last credit (one read of
        the device counter): their runs (branch_runs) and their kernels'
        launches."""
        hits = self.hits[:self.slots].tolist()
        seen = self.seen or [0] * len(hits)
        for b in self.bodies:
            runs = hits[b.slot] - seen[b.slot]
            if runs:
                count("graph", b.name, b.side, runs)
                for kern, n in b.launches.items():
                    kern.add_launches(runs * n, in_graph=True)
                    kern.body_launches += runs * n
        self.seen = hits


@contextlib.contextmanager
def warming():
    """A GraphedStep's warm-up call: each cond also runs its untaken
    branch, on clones of its operands."""
    global _WARMING
    _WARMING = True
    try:
        yield
    finally:
        _WARMING = False


@contextlib.contextmanager
def capturing(graph, device):
    """A capture of `graph` (a GraphedStep's, or a timing harness's): conds
    inside it become conditional bodies, recorded in the _Capture this
    yields; the bodies' memory pools live as long as `graph`."""
    global _CAPTURE
    cap = _CAPTURE = _Capture(device)
    try:
        yield cap
    finally:
        _CAPTURE = None
        if cap.pools:
            weakref.finalize(graph, release_pools, cap.pools)


@contextlib.contextmanager
def _spare():
    global _SPARE
    _SPARE += 1
    try:
        yield
    finally:
        _SPARE -= 1


@contextlib.contextmanager
def _body():
    global _BODY
    _BODY += 1
    try:
        yield
    finally:
        _BODY -= 1


def in_body() -> bool:
    """Whether the code running now is inside a branch body of a `cond`
    (an eager or spare run of a branch, or a body being captured)."""
    return _BODY > 0


def cond(pred: torch.Tensor, true_fn, false_fn, operands=(),
         name: str = "cond"):
    """true_fn(*operands) if `pred` else false_fn(*operands): the port's
    `lax.cond` (module docstring). `pred` is a bool (or 0/1) scalar
    tensor on the step's device. Both branches return trees (tensors,
    tuples, lists, dicts or None) of the same structure, shapes and
    dtypes. `false_fn` None is a branch that does nothing: `true_fn`
    then writes its result in place into its operands and returns None
    (one IF node in a graph, no copy when it does not run). A branch may
    write in place only into its operands (a warm-up call runs the
    untaken one on clones of them) and must not read a value back to
    the host. `name` labels the branch's counts (branch_runs)."""
    operands = tuple(operands)
    if pred.is_cuda and torch.cuda.is_current_stream_capturing():
        return _cond_in_graph(pred, true_fn, false_fn, operands, name)
    take = host_pred(pred)
    fn, other = (true_fn, false_fn) if take else (false_fn, true_fn)
    count("spare" if _SPARE else "eager", name, int(take))
    spare = None
    if _WARMING and other is not None:
        # cloned before `fn`, which may write into the operands
        spare = _map(lambda t: t.detach().clone(), operands)
    out = None
    if fn is not None:
        # the outermost body of an eager run credits its launches
        outer = not (_BODY or _SPARE)
        before = {k: k._launches for k in KERNELS.values()} if outer \
            else None
        with _body():
            out = fn(*operands)
        if outer:
            for k, n in before.items():
                k.body_launches += k._launches - n
    if spare is not None:
        outer = not _SPARE
        before = {k: k._launches for k in KERNELS.values()} if outer \
            else None
        with _spare(), _body():
            count("spare", name, int(not take))
            other(*spare)
        if outer:
            for k, n in before.items():
                k.spare_launches += k._launches - n
    return out


def _body_api():
    """(begin, end) C entry points of kernels/graph_cond.cu."""
    global _BODY_API
    if _BODY_API is None:
        lib = build.load("graph_cond.cu")
        begin, end = lib.cafe_cond_begin, lib.cafe_cond_end
        begin.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                          ctypes.POINTER(ctypes.c_void_p)]
        end.argtypes = [ctypes.c_void_p]
        begin.restype = end.restype = ctypes.c_int
        _BODY_API = (begin, end, lib.cafe_cuda_error_string)
    return _BODY_API


_BODY_API = None


def _check(err: int, what: str) -> None:
    if err != 0:
        msg = _body_api()[2](err).decode()
        raise RuntimeError(f"cond: {what} failed with CUDA error {err} "
                           f"({msg})")


@contextlib.contextmanager
def _if_body(cap, pred: torch.Tensor, negate: bool):
    """Everything enqueued inside lands in an IF node's body: the card
    runs it on the replays where `pred` (negated for an else body) holds
    (kernels/graph_cond.cu). The body's allocations come from a memory
    pool of its own, which the graph keeps (_Capture.pools); its kernel
    launches use the capturing stream's per-stream state
    (kernels/build.BODY_STREAMS)."""
    begin, end, _ = _body_api()
    dev = pred.device
    main = torch.cuda.current_stream(dev)
    body = ctypes.c_void_p()
    with torch.cuda.device(dev):
        _check(begin(main.cuda_stream, pred.data_ptr(), int(negate),
                     ctypes.byref(body)), "opening a branch body")
    pool = torch.cuda.graph_pool_handle()
    cap.pools.append((dev.index, pool))
    build.BODY_STREAMS[body.value] = build.owner_stream(main.cuda_stream)
    torch._C._cuda_beginAllocateCurrentThreadToPool(dev.index, pool)
    try:
        with torch.cuda.stream(torch.cuda.ExternalStream(body.value,
                                                         device=dev)):
            yield
    finally:
        torch._C._cuda_endAllocateToPool(dev.index, pool)
        del build.BODY_STREAMS[body.value]
        _check(end(body.value), "closing a branch body")


def _cond_in_graph(pred, true_fn, false_fn, operands, name):
    cap = _CAPTURE
    if cap is None:
        raise RuntimeError(f"cond {name}: only a GraphedStep's capture "
                           f"can hold a branch")
    pred = pred.reshape(()).to(torch.bool).contiguous()
    cap.preds.append(pred)        # read by the condition kernels
    owned = {t.untyped_storage().data_ptr()
             for t in tensors_of(operands)}
    outs = []
    sides = ((1, true_fn),) if false_fn is None else ((1, true_fn),
                                                      (0, false_fn))
    for side, fn in sides:
        slot = cap.slots          # nested bodies take the next ones
        cap.slots += 1
        if slot >= MAX_BODIES:
            raise RuntimeError(f"cond {name}: more than {MAX_BODIES} "
                               f"branch bodies in one graph")
        before = {k: k.captured for k in KERNELS.values()}
        with _if_body(cap, pred, negate=not side), _body():
            cap.hits[slot].add_(1)
            out = fn(*operands)
            if false_fn is None:
                if out is not None:
                    raise ValueError(f"cond {name}: with no false_fn the "
                                     f"true branch must return None")
            elif side:
                # an output that is an operand gets its own buffer, or
                # the else body's copy would write into the operand
                out = _map(lambda t: t.clone() if
                           t.untyped_storage().data_ptr() in owned else t,
                           out)
            else:
                _merge(outs[0], out, name)
        # the body's launches count on the replays that run it only
        launches = {}
        for k, n in before.items():
            if k.captured > n:
                launches[k] = k.captured - n
                k.captured = n
        cap.bodies.append(_Body(name, side, slot, launches))
        outs.append(out)
    return outs[0]


def release_pools(pools) -> None:
    """Return the branch bodies' memory pools, [(device index, pool)], of
    a destroyed graph to the caching allocator."""
    for index, pool in pools:
        torch._C._cuda_releasePool(index, pool)
