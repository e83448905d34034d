"""The system dlrm_cafe: cafe_tpu_torch's DLRM with CAFE v1 and SGD on
one card, and its `train` entry.

The system object takes from the port the model, the embedding layer,
the sketch, the step builders (a CUDA-graph step on the card,
train/capture.GraphedStep) and the kernels' launch counters. The state
is the port's TrainState, filled with the weights the harness drew on
the device (benchmark/weights.py) in place of the port's host-side
numpy initialisation, as a checkpoint load would fill it, and with the
warm sketch the harness drew from the seed (benchmark/warm.py); its
layout is held against the one the configuration implies
(benchmark/counts/layout.py).

The train entry: set-up draws the traffic pool, the weights and the warm
sketch from the seed, builds the state and the step, makes the step's
first three calls on the first three batches of its own feed (the calls
the check follows; the first two run eagerly, the third captures the
CUDA graph and replays it; the sketch's decay falls in the third), then
`warmup_dispatches` replays: a freshly captured train step replays a
few per cent slower for up to tens of seconds (PERF.md), and that
belongs to set-up, not to the window. The window issues the step back
to back; the rate is every example of every call over the whole window,
the tail the gaps between the ends of successive calls (CUDA events),
over the steps a call. Then the peak, the traced window with --trace 1,
and the check: the reference from the same weights and warm sketch on
the same batches (benchmark/check.py).
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from cafe_tpu_torch.config import Config
from cafe_tpu_torch.embeddings import (CafePart, HashedTablePart,
                                       build_embedding_layer)
from cafe_tpu_torch.kernels import KERNELS
from cafe_tpu_torch.models import MODELS
from cafe_tpu_torch.sketch.hotsketch import init_sketch
from cafe_tpu_torch.train import (TrainState, build_multi_step,
                                  build_train_step, model_arch)

from .. import check, warm as warm_state
from ..cell import p95, sync
from ..counts import flops
from ..counts.layout import layout  # noqa: F401  (the system's layout)
from ..weights import CHUNK_ELEMS, change_norm, leaves, make

# seed streams of the pools
STREAM_TRAIN, STREAM_WARM = 1, 4
CHECKED_CALLS = warm_state.CHECKED_CALLS


def make_config(conf: Dict, overrides: Dict) -> Config:
    names = {f.name for f in dataclasses.fields(Config)}
    kw = {k: v for k, v in conf["config"].items() if k in names}
    kw.update(overrides)
    return Config(**kw)


class System:
    """The port's model, embedding layer, state and steps for one cell."""

    def __init__(self, conf: Dict, lay: Dict, weights: Dict[str, torch.Tensor],
                 overrides: Dict, device):
        self.dev = torch.device(device)
        self.cfg = cfg = make_config(conf, overrides)
        counts, dim = lay["counts"], lay["dim"]
        nd, ns = lay["num_dense"], len(counts)
        if list(model_arch(cfg, nd, ns)) != [lay["ln_bot"], lay["ln_top"]]:
            raise ValueError(f"the configuration's towers {lay['ln_bot']} / "
                             f"{lay['ln_top']} are not the port's "
                             f"{model_arch(cfg, nd, ns)}")
        self.model = MODELS[cfg.model](
            dim, ns, nd, lay["ln_bot"], lay["ln_top"],
            compute_dtype=torch.bfloat16 if cfg.bf16 else torch.float32,
            interaction_op=cfg.arch_interaction_op,
            interaction_itself=cfg.arch_interaction_itself,
            loss_threshold=cfg.loss_threshold, device=self.dev)
        self.embed = build_embedding_layer(cfg, counts, dim, None,
                                           device=self.dev)
        embed, self.keys = {}, {}
        for i, p in enumerate(self.embed.parts):
            key = f"part{i}"
            if isinstance(p, CafePart):
                c = lay["cafe"]
                got = (p.hotn, p.hash_sizes, p.hash_base, p.total_rows)
                want = (c["hotn"], c["hash_sizes"], c["hash_base"],
                        c["rows"])
                if got != want or p.field_idx != lay["big"]:
                    raise ValueError(f"the port's CAFE layout {got} is not "
                                     f"the configuration's {want}")
                embed[key] = {"table": weights["cafe.table"],
                              "sketch": init_sketch(p.sketch_cfg, self.dev),
                              "tick": torch.zeros((), dtype=torch.int32,
                                                  device=self.dev)}
                self.keys["cafe"] = key
            elif isinstance(p, HashedTablePart) and lay["full"] is not None \
                    and p.field_idx == lay["small"] \
                    and p.real_ns == lay["full"]["real_ns"]:
                embed[key] = {"table": weights["full.table"]}
                self.keys["full"] = key
            else:
                raise ValueError(f"part {key} ({type(p).__name__}) is not "
                                 f"in the configuration's layout")
        params = {t: [{"w": weights[f"{t}.{i}.w"], "b": weights[f"{t}.{i}.b"]}
                      for i in range(len(lay["ln_" + t]) - 1)]
                  for t in ("bot", "top")}
        self.state = TrainState(
            params, embed, {k: {} for k in embed}, None,
            torch.zeros((), dtype=torch.int32, device=self.dev))
        self._train = None

    # ------------------------------------------------------------ steps
    def train_step(self, k: int):
        """The train step of k steps a call (built once)."""
        if self._train is None:
            step = build_train_step(self.model, self.embed, self.cfg)
            if k > 1:
                step = build_multi_step(step, k, donate=self.cfg.donate_state)
            self._train = step
        return self._train

    def train(self, k: int, dense, ids, labels):
        """One call of the k-step train step on a [k * B] batch; returns
        its metrics {loss, cafe_promotions, ...} (device tensors)."""
        self.state, metrics = self.train_step(k)(
            self.state, dense, ids, labels, int(ids.shape[0]))
        return metrics

    def graphed(self) -> Dict[str, bool]:
        s = self._train
        return {} if s is None else {"train": bool(getattr(s, "graphed",
                                                           False))}

    # ------------------------------------------------------------ reads
    def leaf(self, name: str) -> torch.Tensor:
        """The state tensor of a benchmark leaf name (weights.leaves)."""
        if name in ("cafe.table", "full.table"):
            return self.state.embed[self.keys[name.split(".")[0]]]["table"]
        tower, i, wb = name.split(".")
        return self.state.params[tower][int(i)][wb]

    def sketch(self) -> Dict[str, torch.Tensor]:
        return self.state.embed[self.keys["cafe"]]["sketch"]

    def load_sketch(self, st: Dict) -> None:
        """Write a whole sketch state (benchmark/warm.py) into the port's
        arrays, before the first step."""
        sk, s = self.sketch(), st["cnt"].shape[0]
        with torch.no_grad():
            for name in ("val", "cnt", "dic"):
                sk[name][:s].copy_(torch.from_numpy(
                    st[name].astype(np.float32 if name == "cnt"
                                    else np.int32)))
            sk["free"].zero_()
            sk["free"][:len(st["free"])].copy_(torch.from_numpy(
                st["free"].astype(np.int32)))
            sk["free_top"].fill_(int(st["free_top"]))
            sk["tot"].fill_(float(st["tot"]))

    @staticmethod
    def launches() -> Dict[str, int]:
        """Each kernel's launches so far (replayed graphs included)."""
        return {name: k.launches for name, k in KERNELS.items()}


# ---------------------------------------------------------------- entry
def _cnt_change(cnt, cnt0: np.ndarray) -> float:
    """||the sketch's counts - the warm counts|| over its first S rows."""
    now = np.asarray(cnt, dtype=np.float64)[:cnt0.shape[0]]
    return float(np.linalg.norm(now - cnt0))


def _norms(run, leaf, cnt) -> Dict[str, float]:
    """Each leaf's change from its initial value: the weights' (drawn
    again from the seed) and the sketch's counts' (from the warm ones)."""
    out = {n: change_norm(run.lay, run.seed, n, leaf(n), run.scratch)
           for n, _ in leaves(run.lay)}
    out["sketch.cnt"] = _cnt_change(cnt, run.warm["cnt"])
    return out


def _follow(run, ref, pool, rows_per: int) -> Dict:
    """A reference's losses, promotions and leaf changes over the checked
    calls, on the program's batches."""
    tf = run.tf
    out = {"loss": [], "promotions": 0}
    for c in range(CHECKED_CALLS):
        d, s, lab = pool.batch(c, rows_per)
        loss, pr = ref.dispatch(d, s, lab, tf["steps_per_dispatch"],
                                tf["cafe_insert_interval"])
        out["loss"].append(loss)
        out["promotions"] += pr
        if c == 0:
            out["d1"] = _norms(run, lambda n: ref.w[n], ref.sketch.cnt)
    out["d3"] = _norms(run, lambda n: ref.w[n], ref.sketch.cnt)
    return out


def _sketch_line(sysm, s: int) -> str:
    sk = sysm.sketch()
    val, cnt, dic = (sk[n][:s].cpu().numpy() for n in ("val", "cnt", "dic"))
    return warm_state.occupancy(val, cnt, dic, int(sk["free_top"]),
                                float(sk["tot"]))


def train(run) -> Dict:
    """The train entry (see the module docstring)."""
    tf, dev, lay = run.tf, run.dev, run.lay
    if len(run.devs) != 1:
        raise ValueError("dlrm_cafe runs on one card")
    k, b = tf["steps_per_dispatch"], tf["batch"]
    rows_per = k * b
    run.scratch = torch.empty(CHUNK_ELEMS, device=dev)
    run.staged += run.scratch.numel() * 4
    run.warm = w = warm_state.warm_sketch(lay, tf, run.gen, run.seed,
                                          STREAM_WARM, dev)
    run.notes.append(
        "warm sketch: " + warm_state.occupancy(
            w["val"], w["cnt"], w["dic"], w["free_top"], w["tot"])
        + f"; the decay falls on insert {warm_state.decay_insert(tf)} of "
        f"the checked calls")
    # the warm sketch's rows go back to the card, so that the program's
    # allocations land as they would without them; the peak is the
    # program's
    run.free()
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    pool = run.pool(tf, run.pool_calls(tf, CHECKED_CALLS) * rows_per,
                    STREAM_TRAIN)
    run.phase("rows and the warm sketch")
    sysm = System(run.conf, lay, make(lay, run.seed, dev),
                  {"cafe_insert_interval": tf["cafe_insert_interval"]}, dev)
    sysm.load_sketch(w)
    if run.wrap is not None:
        run.wrap(sysm)
    run.phase("weights and state")

    def norms():
        return _norms(run, sysm.leaf, sysm.sketch()["cnt"].cpu().numpy())

    prog = {"loss": [], "promotions": 0}
    for c in range(CHECKED_CALLS):
        m = sysm.train(k, *pool.batch(c, rows_per))
        prog["loss"].append(float(m["loss"]))
        prog["promotions"] += int(m["cafe_promotions"])
        if c == 0:
            prog["d1"] = norms()
    prog["d3"] = norms()
    del m
    run.phase("the checked calls and the capture")

    if not run.quick:
        def call(i):
            return sysm.train(k, *pool.batch(i, rows_per))

        nxt = CHECKED_CALLS
        for _ in range(tf["warmup_dispatches"]):
            call(nxt)
            nxt += 1
        sync(dev)
        run.phase("warm-up")
        run.end_setup()
        n, wall, gaps = run.window(call, nxt)
        nxt += n
        gaps = [g / k for g in gaps]
        run.attempted = n
        rate = n * rows_per / wall
        run.values.update(train_examples_per_s=rate,
                          train_step_p95_ms=p95(gaps))
        run.notes.append(f"window: {n} dispatches of {k} x {b} rows in "
                         f"{wall!r} s; {len(gaps)} step-tail samples "
                         f"(p50 {float(np.median(gaps))!r} ms)")
        ctx = None
        if run.trace:
            ns = len(lay["counts"])
            ctx = run.trace_ctx(sysm, call, nxt, rate, {
                "layout": lay,
                "train_flops_per_example": flops.train_flops_per_example(
                    lay["ln_bot"], lay["ln_top"], ns, lay["dim"])})
        run.notes.append(f"pool: {pool.batches(rows_per)} distinct "
                         f"dispatches, {pool.wraps} wraps")
        run.notes.append("sketch after the window: "
                         + _sketch_line(sysm, lay["cafe"]["hotn"]))
        run.finish_program(sysm, ctx)
        del ctx
    del sysm
    run.free()

    # the reference from the same weights and warm sketch, same batches
    Reference = run.reference.Reference
    rr = _follow(run, Reference(lay, make(lay, run.seed, dev),
                                sketch_state=w), pool, rows_per)
    run.free()
    out = check.left_out(rr)
    if out:
        run.notes.append(f"leaves left out (reference change under "
                         f"{check.SMALL_LEAF} of the median): {out}")
    run.notes.append(f"losses {prog['loss']} reference {rr['loss']}; "
                     f"promotions {prog['promotions']} reference "
                     f"{rr['promotions']} (promo_gap "
                     f"{check.promo_gap(prog, rr)!r}, later_loss_gap "
                     f"{check.later_loss_gap(prog, rr)!r}, not compared)")
    migrated = run.reference.MIGRATED
    run.numbers = check.train_numbers(prog, rr, migrated)
    run.notes.extend(check.worst_leaves(prog, rr, migrated))
    if run.readings is not None:
        for name, kw in (("control_fp8", {"precision": "fp8"}),
                         ("fault_half_batch", {"fault": "half_batch"}),
                         ("fault_no_decay", {"fault": "no_decay"})):
            ro = _follow(run, Reference(lay, make(lay, run.seed, dev),
                                        sketch_state=w, **kw),
                         pool, rows_per)
            run.readings[name] = dict(check.train_numbers(ro, rr,
                                                          migrated),
                                      promo_gap=check.promo_gap(ro, rr),
                                      later_loss_gap=check.later_loss_gap(
                                          ro, rr))
            run.free()
    return run.result()


ENTRIES = {"train": train}
