"""The train/eval step (port of cafe_tpu/train/step.py).

One call covers embedding gather -> dense towers -> BCE -> backward ->
sketch insert + migration -> sparse + dense optimizer applies (sgd,
adagrad, rows-Adam; the lr schedule of train/lr_schedule.py as an f32
tensor on the card when one is set). Embedding tables
never enter autograd: the gathered rows are made leaves with
requires_grad, their gradients come back from one autograd.grad call, and
each embedding part turns row gradients into in-place scatter updates
(embeddings/base.py), so every update stays O(batch).

With cfg.donate_state True (the default) the step updates the state IN
PLACE (dense params and tables, where the JAX package donates them) and
returns a TrainState holding the new sketch, tick and step; callers must
not reuse the old TrainState. With donate_state False the step first
clones every tensor of the incoming state and updates the clones, so the
caller's TrainState stays valid, as the JAX package's un-donated call
leaves it (at the cost of one copy of the whole state a call).

Under a mesh each rank runs the step on its contiguous slice of the
global batch (the JAX package re-jits the same function with batch
shardings). The loss is the GLOBAL batch's, sum(losses * w) /
max(sum(w), 1): each rank weights its lanes by their global positions,
divides its local sum by the global weight, and the dense gradients are
summed over the mesh. That is exactly the global gradient, so the
embedding row gradients need no rescaling; the metrics come back global.

`valid` may be a Python int or an int32 tensor; the step turns it into a
tensor on the batch's device and computes the weights from it there, so
no value is read back to the host and one CUDA graph serves every
`valid`, as one jit trace does.

On the card the three builders return CUDA-graph steps
(train/capture.GraphedStep, `.graphed` True) when the configuration
allows it, on one device or on a mesh (each rank captures its share of
the step, collectives included, as the JAX package jits its shard_map
step; on a flat mesh of one host the device branches' bodies hold only
K5's device collectives, parallel/exchange.py, and on more than one
rank a body may not hold NCCL's): `capture_blockers` lists what keeps
a train step eager, decided when the step is built. CPU steps and
`capture=False` are eager (`.graphed` False). The data-dependent
branches (the skipped insert, CAFE+'s decay and reset, AdaEmbed's
decay, the exchange's overflow legs) are conditional nodes in the
graph (utils/cond.cond); AdaEmbed's check steps run eagerly on the
graph's state, picked by its host mirror of the step counter
(train/capture.StepMirror). The graph recommenders' steps take the
same capture through `build_graphrec_step`, with
`graphrec_capture_blockers`.
"""

from __future__ import annotations

from typing import Any, Dict, List, NamedTuple, Tuple

import torch

from ..parallel.exchange import body_transport, psum
from .capture import GraphedStep, StepMirror, conditional_node_blocker
from .lr_schedule import lr_policy

EPS = 1e-7


class TrainState(NamedTuple):
    params: Any          # dense tower params {"bot": [...], "top": [...]}
    embed: Any           # embedding tables / sketch / optimizer slots
    embed_dense: Any     # differentiable embedding params ({} per part)
    opt: Any             # dense-optimizer slots: None (sgd), an acc tree
                         # (adagrad) or [m, v, t] (adam)
    step: torch.Tensor   # int32 global step


def init_state(model, embed_layer, seed: int, optimizer: str,
               params=None) -> TrainState:
    """Tables from numpy (bit-equal to the JAX package's), dense params
    from `params` when given (e.g. bridged from the JAX package) else
    from the model's own torch init."""
    if params is None:
        params = model.init(seed)
    embed_state, embed_dense = embed_layer.init(seed)
    opt = init_dense_opt([params, embed_dense], optimizer)
    return TrainState(params, embed_state, embed_dense, opt,
                      torch.zeros((), dtype=torch.int32,
                                  device=embed_layer.device))


def _zeros_like_tree(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like_tree(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_zeros_like_tree(v) for v in tree]
    return torch.zeros_like(tree)


def init_dense_opt(params, optimizer: str):
    """Dense-optimizer slots for a param tree: None (sgd), a grad^2
    accumulator tree (adagrad), or [m, v, t] (adam) — the JAX package's
    structure with tuples as lists."""
    if optimizer == "adagrad":
        return _zeros_like_tree(params)
    if optimizer == "adam":
        first = _leaves(params)[0]
        return [_zeros_like_tree(params), _zeros_like_tree(params),
                torch.zeros((), dtype=torch.int32, device=first.device)]
    if optimizer != "sgd":
        raise ValueError(f"unknown optimizer {optimizer!r}")
    return None


def clone_state(tree):
    """A copy of a state tree: every tensor cloned (detached), containers
    rebuilt with their own types, other leaves shared."""
    if isinstance(tree, torch.Tensor):
        return tree.detach().clone()
    if isinstance(tree, dict):
        return {k: clone_state(v) for k, v in tree.items()}
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(clone_state(v) for v in tree))
    if isinstance(tree, (list, tuple)):
        return type(tree)(clone_state(v) for v in tree)
    return tree


def _undonated(step_inplace):
    """`step_inplace` behind one clone of the incoming state; the in-place
    step stays reachable as `__wrapped__` (build_multi_step clones once per
    dispatch, not once per sub-step)."""
    def step(state, *args):
        return step_inplace(clone_state(state), *args)

    step.__wrapped__ = step_inplace
    return step


def _leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for v in tree for x in _leaves(v)]
    return [tree]


def _bce(p, y, w, w_total: torch.Tensor):
    """sum(losses * w) / max(w_total, 1): w_total is the whole (global)
    batch's weight, an f32 tensor, so an all-padding (sub-)batch returns
    0, not 0/0."""
    p = p.clamp(EPS, 1.0 - EPS)
    losses = -(y * torch.log(p) + (1.0 - y) * torch.log1p(-p))
    return (losses * w).sum() / w_total.clamp_min(1.0)


def _valid_tensor(valid, device) -> torch.Tensor:
    """`valid` as an int32 scalar on `device`: a tensor is moved, an int
    is written by a fill kernel (a tensor made from host memory would be
    a copy that waits for the card)."""
    if isinstance(valid, torch.Tensor):
        return valid.to(device=device, dtype=torch.int32)
    return torch.full((), int(valid), dtype=torch.int32, device=device)


def _psum_(tensors, mesh) -> None:
    """Sum each tensor over the mesh, in place, with one all-reduce."""
    flat = psum(torch.cat([t.reshape(-1) for t in tensors]), mesh)
    for t, x in zip(tensors, flat.split([t.numel() for t in tensors])):
        t.copy_(x.view_as(t))


@torch.no_grad()
def _dense_update(params, grads, opt, lr, kind):
    """sgd / adagrad (torch semantics, eps 1e-10) / adam on the leaves of
    `params`, in place (params and slots). Returns the new opt state."""
    ps = _leaves(params)
    if kind == "sgd":
        for p, g in zip(ps, grads):
            p.sub_(lr * g)
        return opt
    if kind == "adam":
        b1, b2, eps = 0.9, 0.999, 1e-8
        m, v, t = opt
        t = t + 1
        tf = t.to(torch.float32)
        bc1, bc2 = 1.0 - b1 ** tf, 1.0 - b2 ** tf
        for p, g, mm, vv in zip(ps, grads, _leaves(m), _leaves(v)):
            mm.copy_(b1 * mm + (1 - b1) * g)
            vv.copy_(b2 * vv + (1 - b2) * g * g)
            p.copy_(p - lr * (mm / bc1) / (torch.sqrt(vv / bc2) + eps))
        return [m, v, t]
    for p, g, a in zip(ps, grads, _leaves(opt)):
        a.copy_(a + g * g)
        p.copy_(p - lr * g / (torch.sqrt(a) + 1e-10))
    return opt


_UNDONATED = ("donate_state False: each replay would have to clone the "
              "whole state")


def has_branches(embed_layer) -> bool:
    """Whether the layer's step takes a device branch (utils/cond.cond):
    a part's own (the skipped insert, CAFE+'s decay and reset, AdaEmbed's
    decay) or, on a mesh, the exchange's (the unique-compact and a2a
    overflow legs, parallel/exchange.py)."""
    return any(p.conds or (p.mesh is not None and (
        p.unique_frac > 0 or p.exchange_mode != "explicit"))
        for p in embed_layer.parts)


LOOKUPS = ("train", "eval", "quantized")


def collective_branches(embed_layer, lookups: str = "train") -> List[str]:
    """The device branches of the layer's train step, float eval or
    quantized eval (`lookups`) whose bodies hold collectives: the a2a /
    pallas legs and the unique-compact legs (their overflow branch is
    the full explicit exchange), CAFE's hierarchical id legs on a
    two-level mesh (the flat route and insert) and the sharded insert
    every interval-th tick (its candidate all-gather). The quantized
    lookups take CAFE's route only."""
    if lookups not in LOOKUPS:
        raise ValueError(f"lookups: one of {LOOKUPS}, got {lookups!r}")
    out = []
    for i, p in enumerate(embed_layer.parts):
        if p.mesh is None:
            continue
        if lookups != "quantized":
            if p.exchange_mode != "explicit":
                if not p.mesh.inner:   # a two-level mesh takes no a2a leg
                    out.append(f"part{i}: the {p.exchange_mode} legs")
            elif p.unique_frac > 0:
                out.append(f"part{i}: the unique-compact legs")
        if p.id_legs and p.mesh.inner and p.unique_frac > 0:
            out.append(f"part{i}: the hierarchical id legs")
        if lookups == "train" and getattr(p, "insert_interval", 1) > 1:
            out.append(f"part{i}: the insert every {p.insert_interval} "
                       f"ticks")
    return out


def nccl_branches(embed_layer, mesh, lookups: str = "train") -> List[str]:
    """The device branches (collective_branches) whose bodies hold NCCL
    collectives on `mesh`: every one on a two-level mesh or across
    hosts, where the bodies keep the process group's collectives
    (parallel/exchange.body_transport), none on a flat mesh of one host,
    where they hold K5's device collectives."""
    if mesh is None or body_transport(mesh) == "device":
        return []
    return collective_branches(embed_layer, lookups)


def _mesh_blockers(embed_layer, mesh, lookups: str) -> List[str]:
    held = [] if mesh is None or mesh.size == 1 else nccl_branches(
        embed_layer, mesh, lookups)
    if not held:
        return []
    why = ("a two-level mesh, whose bodies run over its row and column "
           "groups (its 'dcn' level stands for links across hosts)"
           if mesh.inner else
           f"ranks on {len(set(mesh.hosts))} hosts, which K5's device "
           f"collectives cannot reach (CUDA IPC maps one host's cards)")
    return [f"a mesh of {mesh.size} ranks with NCCL collectives inside "
            f"device branches ({'; '.join(held)}) on {why}: the card "
            f"refuses to capture NCCL's work on more than one rank into a "
            f"CUDA graph conditional body ('CUDA error: invalid argument', "
            f"tools/cond_nccl_probe_torch.py --world 4)"]


def capture_blockers(cfg, embed_layer, mesh=None) -> List[str]:
    """What keeps the train step of `cfg` from replaying a CUDA graph,
    each with the code that keeps it eager; empty when nothing does.
    Decided from the configuration when the step is built, never from a
    failed capture. A mesh's collectives are captured on every rank
    (train/capture.py), and a device branch's body holds K5's device
    collectives on a flat mesh of one host; on a two-level mesh or
    across hosts its NCCL collectives keep the step eager on more than
    one rank."""
    out = []
    if not cfg.donate_state:
        out.append(_UNDONATED)
    if has_branches(embed_layer):
        no_nodes = conditional_node_blocker(embed_layer.device)
        if no_nodes:
            out.append(no_nodes)
    return out + _mesh_blockers(embed_layer, mesh, "train")


_NOT_ON_CUDA = ("not on CUDA: the step runs on the CPU, which replays no "
                "CUDA graph")


def graphrec_capture_blockers(part, device) -> List[str]:
    """What keeps a graph recommender's jitted step (LightGCN's BPR step,
    PinSAGE's train and representation steps, models/graphrec/) on
    `device` from replaying a CUDA graph, each with its reason; empty
    when nothing does. Decided from the configuration (the device and
    the node-id part), never from a failed capture: a step off the card,
    or a part with device branches on a torch or CUDA that cannot hold
    them (utils/cond.conditional_node_blocker)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [_NOT_ON_CUDA]
    no_nodes = conditional_node_blocker(device) if part.conds else None
    return [no_nodes] if no_nodes else []


def build_graphrec_step(fn, part, device, carry: bool, capture=True):
    """`fn(state, *batch)` as a graph recommender's step: with `capture`
    and no graphrec_capture_blockers a GraphedStep (`carry` True for a
    train step returning (state, out), False for an eval step), else
    `fn` run eagerly (`.graphed` False, `.capture_blockers` set)."""
    blockers = graphrec_capture_blockers(part, device)
    if capture and not blockers:
        return GraphedStep(fn, carry=carry)

    def step(state, *batch):
        return fn(state, *batch)

    return _eager(step, blockers)


def _step_mirror(embed_layer):
    """The StepMirror of a layer whose part has host steps (AdaEmbed's
    check), else None."""
    hosted = [(f"part{i}", p) for i, p in enumerate(embed_layer.parts)
              if p.host_step is not None]
    if not hosted:
        return None
    if len(hosted) > 1:
        raise ValueError("train step: more than one part with host steps")
    key, part = hosted[0]
    return StepMirror(lambda state: state.embed[key]["step"],
                      part.host_step)


def _eager(fn, blockers):
    fn.graphed = False
    fn.capture_blockers = blockers
    return fn


def build_train_step(model, embed_layer, cfg, mesh=None, capture=True):
    """The step on one device, or with `mesh` this rank's share of the
    mesh's step: `ids` etc. are this rank's slice and `valid` counts the
    valid rows of the GLOBAL batch. In place unless cfg.donate_state is
    False (module docstring). On the card, with `capture` and no
    capture_blockers, a GraphedStep; else the eager step."""
    base_lr = cfg.learning_rate
    use_sched = cfg.lr_num_warmup_steps > 0 or cfg.lr_num_decay_steps > 0
    n, rank = (1, 0) if mesh is None else (mesh.size, mesh.rank)

    def train_step(state: TrainState, dense_x, ids, labels, valid
                   ) -> Tuple[TrainState, Dict[str, torch.Tensor]]:
        b = ids.shape[0]
        if use_sched:
            lr = lr_policy(base_lr, state.step, cfg.lr_num_warmup_steps,
                           cfg.lr_decay_start_step, cfg.lr_num_decay_steps)
        else:
            lr = base_lr
        valid = _valid_tensor(valid, ids.device)
        lanes = torch.arange(rank * b, (rank + 1) * b, device=ids.device)
        w = (lanes < valid).float()
        w_total = valid.clamp(0, n * b).float()
        raws, auxs = embed_layer.gather(state.embed, ids)
        raws = {k: v.detach().requires_grad_() for k, v in raws.items()}
        dense = [state.params, state.embed_dense]
        dense_leaves = _leaves(dense)
        for p in dense_leaves:
            p.requires_grad_()

        with torch.enable_grad():
            feats = embed_layer.transform(state.embed_dense, raws)
            p = model.apply(state.params, dense_x, feats)
            loss = _bce(p, labels, w, w_total)
            grads = torch.autograd.grad(
                loss, dense_leaves + [raws[k] for k in sorted(raws)])
        g_params = grads[:len(dense_leaves)]
        g_raws = dict(zip(sorted(raws), grads[len(dense_leaves):]))
        p = p.detach()
        sums = torch.stack([loss.detach(),
                            ((torch.round(p) == labels) * w).sum(),
                            w.sum()])
        if mesh is not None:
            _psum_(list(g_params) + [sums], mesh)

        opt = _dense_update(dense, g_params, state.opt, lr, cfg.optimizer)
        embed, stats = embed_layer.apply_grads(state.embed, ids, g_raws,
                                               auxs, lr)
        metrics = {"loss": sums[0], "correct": sums[1], "weight": sums[2],
                   **stats}
        return TrainState(state.params, embed, state.embed_dense, opt,
                          state.step + 1), metrics

    blockers = capture_blockers(cfg, embed_layer, mesh)
    if capture and not blockers and embed_layer.device.type == "cuda":
        return GraphedStep(train_step, carry=True,
                           mirror=_step_mirror(embed_layer))
    return _eager(train_step if cfg.donate_state else _undonated(train_step),
                  blockers)


def _weighted(name: str) -> bool:
    return name == "loss" or name.endswith("_frac")


def build_multi_step(train_step, k: int, donate: bool = False,
                     mesh_size: int = 1):
    """k sequential train steps per call over a flat [k*B] batch: sub-batch
    i takes rows [i*B, (i+1)*B) and valid_i = clip(valid - i*B, 0, B),
    computed on the device. Metrics come back as one step's: weighted
    means (by each sub-batch's weight) for loss and *_frac, sums for the
    counters.

    On a mesh of `mesh_size` n ranks, `train_step` is the mesh's step and
    each rank passes its [k*B/n] rows, its slice of each of the k global
    batches in turn (train/loop.train_batches); `valid` counts the valid
    rows of the k global batches, so valid_i = clip(valid - i*B, 0, B)
    with the global B = n * rows / k.

    The sub-steps run the in-place step (`train_step.__wrapped__`: the
    eager step under a GraphedStep or an un-donated step). `donate` False
    clones the incoming state once per call, so the caller's state stays
    valid; True updates it in place, as the JAX package's donate_argnums
    does. With `donate` and a graphed `train_step`, the k steps are one
    GraphedStep: one replay a call."""
    inner = getattr(train_step, "__wrapped__", train_step)

    def multi_step(state: TrainState, dense_x, ids, labels, valid):
        if not donate:
            state = clone_state(state)
        b = ids.shape[0] // k
        bg = b * mesh_size
        valid = _valid_tensor(valid, ids.device)
        agg = None
        for i in range(k):
            sl = slice(i * b, (i + 1) * b)
            v_i = (valid - i * bg).clamp(0, bg)
            dx = None if dense_x is None else dense_x[sl]
            state, m = inner(state, dx, ids[sl], labels[sl], v_i)
            m = {name: v * m["weight"] if _weighted(name) else v
                 for name, v in m.items()}
            agg = m if agg is None else {name: agg[name] + v
                                         for name, v in m.items()}
        denom = agg["weight"].clamp_min(1.0)
        return state, {name: v / denom if _weighted(name) else v
                       for name, v in agg.items()}

    if donate and getattr(train_step, "graphed", False):
        return GraphedStep(multi_step, carry=True,
                           mirror=train_step.mirror, steps_per_call=k)
    blockers = list(getattr(train_step, "capture_blockers", []))
    if not donate:
        blockers.append(_UNDONATED)
    return _eager(multi_step, list(dict.fromkeys(blockers)))


def build_eval_step(model, embed_layer, capture=True, gather=None):
    """Scores [B] of a batch. On the card, with `capture` and nothing
    that keeps it eager (a mesh's collectives do not, but for a device
    branch that holds NCCL's on more than one rank), a GraphedStep whose
    output tensor the next call overwrites. `gather` (state.embed, ids)
    -> raws replaces the layer's float lookup (the quantized one)."""
    quantized = gather is not None
    gather = gather or (lambda embed, ids: embed_layer.gather(embed, ids)[0])

    @torch.no_grad()
    def eval_step(state: TrainState, dense_x, ids):
        feats = embed_layer.transform(state.embed_dense,
                                      gather(state.embed, ids))
        return model.apply(state.params, dense_x, feats)

    blockers = []
    if has_branches(embed_layer):
        no_nodes = conditional_node_blocker(embed_layer.device)
        if no_nodes:
            blockers.append(no_nodes)
    # the quantized lookups take no exchange branch, only CAFE's route
    blockers += _mesh_blockers(embed_layer, embed_layer.mesh,
                               "quantized" if quantized else "eval")
    if capture and not blockers and embed_layer.device.type == "cuda":
        return GraphedStep(eval_step, carry=False)
    return _eager(eval_step, blockers)


def build_quantized_eval_step(model, embed_layer, state: TrainState,
                              bits: int, capture=True):
    """Scores [B] of a batch served from row-wise int4 / int8 tables
    (ops/quantized.py). Each part quantizes its float row tables once,
    here, from `state`; its lookups gather codes and dequantize them.
    Routing state (sketches, hot dicts, Ada's dic) stays full precision
    and is read from the state passed at each call, except a CAFE v1
    part's on one device, which routes through the packed sketch view
    it froze here (`sk_packed`, held in `qtables` beside the codes);
    MDE / AE projections apply in f32. On the card a GraphedStep, as
    build_eval_step, on a mesh too."""
    with torch.no_grad():
        qtables = embed_layer.quantize_for_serving(state.embed, bits)
    step = build_eval_step(
        model, embed_layer, capture,
        gather=lambda embed, ids: embed_layer.gather_quantized(
            embed, qtables, ids))
    step.qtables = qtables
    return step
