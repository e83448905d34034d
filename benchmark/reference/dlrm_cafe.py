"""The plain reference of DLRM with CAFE: plain PyTorch for the towers
(autograd for the backward) and the tables, the sketch in numpy
(reference/sketch.py). It imports nothing of the port and takes nothing
the port made: it starts from the harness's weights, drawn again from
the seed (benchmark/weights.py), and the harness's warm sketch
(benchmark/warm.py), and works out the table layout from the
configuration (benchmark/counts/layout.py).

What it follows, from the description of DLRM and CAFE:
- bottom MLP (ReLU after every layer) on the dense features; the dot
  interaction: the strict upper triangle of T T^T over the bottom output
  and the field embeddings, row-major; top MLP, ReLU between layers and a
  sigmoid at the end;
- the precision the configuration states: with bf16 towers every matmul
  takes its operands rounded to bf16 and accumulates in f32 (the JAX
  package's policy), so the backward rounds the gradient through each
  rounding as well; `precision` "fp8" (float8 e4m3, clamped to its
  +-448 range) is the control a step below it;
- the BCE loss, its p clamped to [1e-7, 1 - 1e-7], summed over the
  lanes below `valid` and divided by their count;
- CAFE: each id of a compressed field reads its exclusive hot row when
  the sketch holds a slot for it, else its field's hash row
  (hash_base + hash_off[f] + (offset id mod hash_size[f])); each lane's
  importance is the L2 norm of its row gradient, scaled so a field's
  scores average the insert interval over the batch; the sketch takes
  the scores every interval-th step; at most promo_cap promotions are
  kept (the rest reverted); each kept promotion copies its id's hash row
  into its new hot row; then SGD scatters -lr * gradient into the rows
  that served the batch, duplicates summing; fields of at most
  2000 * cr ids read full tables, updated the same way;
- SGD on the tower weights.
"""

from __future__ import annotations

from typing import Dict, List, Optional

import numpy as np
import torch

from ..counts.layout import promo_cap, round_up
from .sketch import Sketch

EPS = 1e-7
FP8_MAX = 448.0
# the leaves whose rows a promotion copies (hash row into hot row)
MIGRATED = ("cafe.table",)


def rounder(precision: str):
    """The operand rounding of a matmul at `precision`."""
    if precision == "bf16":
        return lambda x: x.to(torch.bfloat16).float()
    if precision == "fp8":
        return lambda x: x.clamp(-FP8_MAX, FP8_MAX).to(
            torch.float8_e4m3fn).float()
    if precision == "f32":
        return lambda x: x
    raise ValueError(f"unknown precision {precision!r}")


class Router:
    """CAFE's routing of a batch's ids over a sketch: each id of a
    compressed field to its hot row or its field's hash row, each id of a
    small field to its full table's row."""

    def __init__(self, lay: Dict, sketch: Sketch, device):
        c = lay["cafe"]
        self.lay = lay
        self.sketch = sketch
        self.dev = torch.device(device)
        self.big = torch.tensor(lay["big"], device=self.dev)
        self.small = torch.tensor(lay["small"], device=self.dev) \
            if lay["small"] else None
        self._full_off = None if lay["full"] is None else torch.tensor(
            lay["full"]["offsets"], device=self.dev)
        self._goff = np.asarray(c["goff"], dtype=np.int64)
        self._hs = np.asarray(c["hash_sizes"], dtype=np.int64)
        self._ho = np.asarray(c["hash_off"], dtype=np.int64)

    def hash_rows(self, oids: np.ndarray) -> np.ndarray:
        """The hash row of each offset id [B, Fc] of its field column."""
        c = self.lay["cafe"]
        return c["hash_base"] + self._ho[None, :] + oids % self._hs[None, :]

    def hash_row_of(self, oids: np.ndarray) -> np.ndarray:
        """The hash row of offset ids [n], the field found from the id."""
        c = self.lay["cafe"]
        f = np.clip(np.searchsorted(self._goff, oids, side="right") - 1, 0,
                    len(self._goff) - 1)
        return c["hash_base"] + np.clip(self._ho[f] + oids % self._hs[f], 0,
                                        c["hash_rows"] - 1)

    def route(self, ids: torch.Tensor):
        """(cafe rows [B, Fc] long, offset ids [B, Fc] numpy, hot mask,
        full rows [B, Fs] long or None) of a batch's ids [B, F]."""
        oids = ids[:, self.big].cpu().numpy().astype(np.int64) \
            + self._goff[None, :]
        slot = self.sketch.query(oids.reshape(-1)).reshape(oids.shape)
        rows = np.where(slot > 0, slot, self.hash_rows(oids))
        full = None
        if self.small is not None:
            full = ids[:, self.small].long() + self._full_off[None, :]
        return (torch.from_numpy(rows).to(self.dev), oids, slot > 0, full)


class Reference:
    """The model's state (towers, tables, sketch) and its steps.

    `weights` are the initial leaves ({name: tensor}, benchmark/weights.py
    names); the reference owns and updates them. `sketch_state` is the
    sketch's initial state (benchmark/warm.py; an empty sketch without
    it). `fault` plants one of the faults a check must catch:
    "half_batch" (lanes past half the batch weigh nothing and the mean is
    over the rest), "no_decay" (the sketch's decay multiplies by 1)."""

    def __init__(self, lay: Dict, weights: Dict[str, torch.Tensor],
                 precision: str = "bf16", fault: Optional[str] = None,
                 sketch_state: Optional[Dict] = None):
        self.lay = lay
        self.w = weights
        self.q = rounder(precision)
        self.fault = fault
        self.dev = weights["cafe.table"].device
        c = lay["cafe"]
        self.bot = [(weights[f"bot.{i}.w"], weights[f"bot.{i}.b"])
                    for i in range(len(lay["ln_bot"]) - 1)]
        self.top = [(weights[f"top.{i}.w"], weights[f"top.{i}.b"])
                    for i in range(len(lay["ln_top"]) - 1)]
        self.sketch = Sketch(
            c["hotn"], c["threshold"],
            1.0 if fault == "no_decay" else c["decay"],
            free_len=round_up(c["hotn"]))
        if sketch_state is not None:
            self.sketch.load(sketch_state)
        self.router = Router(lay, self.sketch, self.dev)
        self.tick = 0
        nf = len(lay["counts"]) + 1
        iu = torch.triu_indices(nf, nf, offset=1)
        self._tri = (iu[0] * nf + iu[1]).to(self.dev)
        self._big, self._small = self.router.big, self.router.small

    # ------------------------------------------------------------ model
    def _mm(self, x, w):
        return self.q(x) @ self.q(w)

    def forward(self, dense: torch.Tensor, feats: torch.Tensor
                ) -> torch.Tensor:
        """p [B] from dense [B, 13] and the field embeddings [B, F, D]."""
        x = dense
        for w, b in self.bot:
            x = torch.relu(self._mm(x, w) + b)
        t = torch.cat([x[:, None, :], feats], dim=1)
        z = self._mm(t, t.transpose(1, 2)).reshape(t.shape[0], -1)
        r = torch.cat([x, z[:, self._tri]], dim=1)
        for i, (w, b) in enumerate(self.top):
            r = self._mm(r, w) + b
            r = torch.sigmoid(r) if i == len(self.top) - 1 \
                else torch.relu(r)
        return r[:, 0]

    def _feats(self, rows, full) -> torch.Tensor:
        """Field embeddings [B, F, D] in field order."""
        cafe_t, full_t = self.w["cafe.table"], self.w.get("full.table")
        b = rows.shape[0]
        f = len(self.lay["counts"])
        feats = torch.empty((b, f, self.lay["dim"]), device=self.dev)
        feats[:, self._big] = cafe_t[rows]
        if full is not None:
            feats[:, self._small] = full_t[full]
        return feats

    # ------------------------------------------------------------ steps
    def step(self, dense, ids, labels, interval: int = 1):
        """One SGD step on a batch; returns (loss, kept promotions)."""
        lay = self.lay
        b = ids.shape[0]
        lr = lay["lr"]
        rows, oids, _, full = self.router.route(ids)
        feats = self._feats(rows, full).requires_grad_()
        params = [t for wb in self.bot + self.top for t in wb]
        for t in params:
            t.requires_grad_()
        lanes = torch.arange(b, device=self.dev)
        valid = b // 2 if self.fault == "half_batch" else b
        w = (lanes < valid).float()
        with torch.enable_grad():
            p = self.forward(dense, feats).clamp(EPS, 1.0 - EPS)
            losses = -(labels * torch.log(p)
                       + (1.0 - labels) * torch.log1p(-p))
            loss = (losses * w).sum() / max(float(valid), 1.0)
            grads = torch.autograd.grad(loss, params + [feats])
        for t in params:
            t.requires_grad_(False)
        g_feats = grads[-1]
        with torch.no_grad():
            # CAFE: scores, the insert, the cap, the migration
            g_c = g_feats[:, self._big]
            norms = torch.sqrt((g_c * g_c).sum(dim=-1) + 1e-30)
            scores = norms * float(b * interval) / (
                norms.sum(dim=0, keepdim=True) + 1e-30)
            kept: List = []
            if self.tick % interval == 0:
                promos = self.sketch.insert(oids.reshape(-1),
                                            scores.reshape(-1).cpu().numpy())
                cap = promo_cap(lay, b)
                kept, excess = promos[:cap], promos[cap:]
                if excess:
                    self.sketch.revert(excess)
            table = self.w["cafe.table"]
            if kept:
                p_ids = np.array([k[0] for k in kept], dtype=np.int64)
                dst = torch.tensor([k[1] for k in kept], device=self.dev)
                src = torch.from_numpy(self.router.hash_row_of(p_ids)).to(
                    self.dev)
                table[dst] = table[src]
            d = lay["dim"]
            table.index_add_(0, rows.reshape(-1),
                             -lr * g_c.reshape(-1, d))
            if full is not None:
                self.w["full.table"].index_add_(
                    0, full.reshape(-1),
                    -lr * g_feats[:, self._small].reshape(-1, d))
            for t, g in zip(params, grads[:-1]):
                t.sub_(lr * g)
        self.tick += 1
        return float(loss.detach()), len(kept)

    def dispatch(self, dense, ids, labels, k: int, interval: int):
        """k steps over a [k * B] batch, as one call of the port's K-step
        dispatch reports them: (mean loss, promotions)."""
        bsz = ids.shape[0] // k
        losses, promos = [], 0
        for i in range(k):
            sl = slice(i * bsz, (i + 1) * bsz)
            loss, n = self.step(dense[sl], ids[sl], labels[sl], interval)
            losses.append(loss)
            promos += n
        return float(np.mean(losses)), promos
