"""CAFE+ two-tier HotSketch (port of cafe_tpu/sketch/hotsketch_plus.py).

* **Main tier** (n1 buckets, 90 % by default): like v1, but new ids do
  not enter here directly, only ids graduating from staging.
* **Staging tier** (n2 buckets): an LRU cache of candidate ids with
  timestamps. A staged id crossing the threshold moves into the main tier
  with its count and hot slot; a displaced LRU victim moves there too if
  it holds a slot or a count >= 5.
* **Decay**: per batch `decay_acc *= alpha`; past V = 10000 the threshold,
  the accumulator and every count are divided by V.
* **Adaptive threshold**: `real_n` counts threshold crossings; past 1.2x
  the hot capacity a reset ranks every candidate cell by count, keeps the
  top `lim - 1` hot, demotes the rest and raises the threshold to the
  cut-off count.

State is a dict of tensors with the JAX CafePlusState's 13 field names:
val1 / cnt1 / dic1 [n1p, C], val2 / cnt2 / dic2 / ts2 [n2p, C] (int32,
f32, int32; rows padded to ROW_ALIGN), free int32 [limp], free_top int32
[], threshold f32 [], real_n int32 [], decay_acc f32 [], step int32 [].
Functions return new tensors and leave their inputs untouched.

The port reproduces the JAX insert bit for bit on the same inputs (with
integer scores, so no f32 sum order can move a decision):

* where several lanes write one cell in one scatter, XLA applies the
  updates in lane order, so the last lane's value stays; the port names
  that winner explicitly (a scatter-max of lane indices), which gives the
  same answer on the card, where a plain index_put_ has no defined winner;
* sorts are stable, argmin / argmax take the first of ties;
* the JAX package's two `lax.cond`s (decay and reset) are the port's
  `cond` (utils/cond.py): in a CUDA graph each branch is a conditional
  node the card takes, so the reset's sort over every cell runs only on
  the steps where it fires; an eager step reads each predicate once;
* the decay multiplies by the f32 reciprocal of V, as the compiled JAX
  division does, on both devices.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..utils.cond import cond
from .hotsketch import (INVALID_ID, InsertResult, SketchState, _first_true,
                        _set_cells, alloc_slots, mul_u32, push_slots)

_H1 = 2654435761
_H2 = 0x85EBCA6B

DECAY_V = 10000.0
# XLA compiles the JAX package's division by the constant V into a
# multiply by its f32 reciprocal; the port multiplies by that same f32
_INV_V = float(np.float32(1.0) / np.float32(DECAY_V))
LRU_MOVE_MIN_CNT = 5.0  # a displaced staging victim worth keeping

# the fields a reset rewrites (the rest pass through it unchanged)
_RESET_FIELDS = ("dic1", "dic2", "free", "free_top", "threshold", "real_n")
# the fields the decay divides by V
_DECAY_FIELDS = ("decay_acc", "threshold", "cnt1", "cnt2")


def _decay(*fields):
    return tuple(x * _INV_V for x in fields)


def _same(*fields):
    return fields


class CafePlusConfig(NamedTuple):
    lim: int                  # hot-slot capacity (== v1 `buckets`)
    threshold: float          # initial promotion threshold
    alpha: float = 1.000001   # per-batch decay growth
    adjust_threshold: bool = True
    cells: int = 4
    insert_rounds: int = 2
    # opt-in: a newcomer displacing a DISCARDED staging victim inherits
    # its count (v1's Space-Saving rule); off for the reference's rule
    inherit: bool = False
    # the staging tier's share of the buckets (the reference's 0.1)
    staging_frac: float = 0.1

    @property
    def n1(self) -> int:
        return max(int(self.lim * (1.0 - self.staging_frac)), 1)

    @property
    def n2(self) -> int:
        return max(int(self.lim * self.staging_frac), 1)


def init_sketch_plus(cfg: CafePlusConfig, device="cuda") -> SketchState:
    """A fresh two-tier sketch on `device` (default the card; raises
    without CUDA unless device='cpu')."""
    device = resolve_device(device)
    from ..embeddings.base import round_up
    c = cfg.cells
    n1p, n2p, limp = round_up(cfg.n1), round_up(cfg.n2), round_up(cfg.lim)
    free = np.zeros(limp, dtype=np.int32)
    free[: cfg.lim - 1] = np.arange(1, cfg.lim, dtype=np.int32)

    def z(n, dtype):
        return torch.zeros((n, c), dtype=dtype, device=device)

    def scalar(v, dtype):
        return torch.tensor(v, dtype=dtype, device=device)

    return {
        "val1": z(n1p, torch.int32), "cnt1": z(n1p, torch.float32),
        "dic1": z(n1p, torch.int32),
        "val2": z(n2p, torch.int32), "cnt2": z(n2p, torch.float32),
        "dic2": z(n2p, torch.int32), "ts2": z(n2p, torch.int32),
        "free": torch.from_numpy(free).to(device),
        "free_top": scalar(cfg.lim - 1, torch.int32),
        "threshold": scalar(cfg.threshold, torch.float32),
        "real_n": scalar(0, torch.int32),
        "decay_acc": scalar(1.0, torch.float32),
        "step": scalar(0, torch.int32),
    }


def _h1(cfg: CafePlusConfig, ids: torch.Tensor) -> torch.Tensor:
    """Main-tier bucket: (uint32(id) * 2654435761 mod 2^32) % n1."""
    return (mul_u32(ids, _H1) % cfg.n1).to(torch.int32)


def _h2(cfg: CafePlusConfig, ids: torch.Tensor) -> torch.Tensor:
    """Staging bucket: (uint32(id) * 0x85EBCA6B mod 2^32) % n2."""
    return (mul_u32(ids, _H2) % cfg.n2).to(torch.int32)


def _cells_of(*arrays, rows):
    """Each [R, C] array's bucket rows `rows` [L] as [L, C] cells,
    gathered element-wise through the flat view: torch's row gather
    takes a block a row, slow for rows of C = 4 words."""
    c = arrays[0].shape[1]
    flat = rows.long()[:, None] * c + torch.arange(c, device=rows.device)
    out = tuple(a.reshape(-1)[flat] for a in arrays)
    return out if len(out) > 1 else out[0]


def _pick(x: torch.Tensor, cell: torch.Tensor) -> torch.Tensor:
    """x[i, cell[i]] of gathered cells x [L, C]."""
    return x.gather(1, cell.long()[:, None])[:, 0]


def _stable_order_pick(keys: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """For each row of keys [L, C], the cell a stable ascending sort puts
    at position r (torch.sort(keys, 1, stable=True).indices[:, r]),
    by counting: a cell's position is the number of smaller keys plus the
    number of equal keys before it (C^2 compares, no sort)."""
    c = keys.shape[1]
    less = keys[:, None, :] < keys[:, :, None]           # [L, j, k]: k<j
    tie = (keys[:, None, :] == keys[:, :, None]) & torch.ones(
        c, c, dtype=torch.bool, device=keys.device).tril(-1)
    pos = (less | tie).sum(dim=2)                        # [L, C]
    return _first_true(pos == r.long()[:, None])


def tier_slot(val, cnt, dic, rows, ids) -> torch.Tensor:
    """The hot slot of each id in its bucket row of one tier, 0 if none."""
    bv, bc, bd = _cells_of(val, cnt, dic, rows=rows)
    m = (bc > 0) & (bv == ids[:, None]) & (bd != 0)
    return torch.where(m, bd, 0).amax(dim=1)


def sketch_query_plus(cfg: CafePlusConfig, st: SketchState,
                      ids: torch.Tensor) -> torch.Tensor:
    """-hot_slot if hot in either tier, else the id."""
    slot = torch.maximum(
        tier_slot(st["val1"], st["cnt1"], st["dic1"], _h1(cfg, ids), ids),
        tier_slot(st["val2"], st["cnt2"], st["dic2"], _h2(cfg, ids), ids))
    return torch.where((ids != int(INVALID_ID)) & (slot > 0), -slot, ids)


def analyse_plus(cfg: CafePlusConfig, st: SketchState,
                 ids: torch.Tensor) -> torch.Tensor:
    """Fraction of `ids` currently hot in either tier (the in-training
    recall probe: feed it the ideal top-k ids)."""
    return (sketch_query_plus(cfg, st, ids) < 0).float().mean()


def _main_tier_insert(cfg, val1, cnt1, dic1, free, free_top,
                      ids, counts, dics, mask):
    """Place (id, count, dic) lanes of `mask` into the main tier: an empty
    cell first, else the min-count cell if it holds no slot (the count
    accumulates into the victim's); else the lane is dropped and its slot
    pushed back. `insert_rounds` rounds; of the lanes that pick one cell
    in a round, the last lane wins (XLA's scatter order). Returns the
    arrays, free stack and the dropped mask."""
    n1p, c = val1.shape
    lanes_h = _h1(cfg, ids).long()
    lane = torch.arange(ids.shape[0], dtype=torch.int32, device=ids.device)
    placed = torch.zeros_like(mask)
    for _ in range(cfg.insert_rounds):
        pend = mask & ~placed
        bc, bd = _cells_of(cnt1, dic1, rows=lanes_h)
        occ = bc > 0
        has_empty = (~occ).any(dim=1)
        cell_m = torch.argmin(bc, dim=1)
        use_empty = pend & has_empty
        can_evict = pend & ~has_empty & (_pick(bd, cell_m) == 0)
        cell = torch.where(has_empty, _first_true(~occ).long(), cell_m)
        tryw = use_empty | can_evict
        # lanes that do not try write a spare of their own (one shared
        # spare would serialise their atomics)
        flat = torch.where(tryw, lanes_h * c + cell, n1p * c + lane)
        winner = torch.full((n1p * c + lane.shape[0],), -1,
                            dtype=torch.int32, device=ids.device)
        winner.scatter_reduce_(0, flat, lane, "amax")
        won = tryw & (winner[flat] == lane)
        # an empty cell takes the count, a victim's accumulates it (as
        # the JAX package adds counts - old or counts to the cell)
        bc_c = _pick(bc, cell)
        rows = torch.where(won, lanes_h, n1p)
        val1 = _set_cells(val1, rows, cell, ids)
        cnt1 = _set_cells(cnt1, rows, cell,
                          bc_c + torch.where(use_empty, counts - bc_c,
                                             counts))
        dic1 = _set_cells(dic1, rows, cell, dics)
        placed = placed | won
    dropped = mask & ~placed
    free, free_top = push_slots(free, free_top, dics,
                                dropped & (dics != 0))
    return val1, cnt1, dic1, free, free_top, dropped


def _reset(cfg: CafePlusConfig, st: SketchState) -> SketchState:
    """Adaptive-threshold rebuild: rank every candidate cell (count >=
    threshold or holding a slot) by count; the top lim - 1 keep or gain
    slots (granted in descending count order), the rest are demoted; the
    threshold becomes the highest demoted count."""
    lim = cfg.lim
    dev = st["cnt1"].device
    cnt_all = torch.cat([st["cnt1"].reshape(-1), st["cnt2"].reshape(-1)])
    dic_all = torch.cat([st["dic1"].reshape(-1), st["dic2"].reshape(-1)])
    m = cnt_all.shape[0]
    cand = (cnt_all >= st["threshold"]) | (dic_all != 0)
    n_cand = cand.sum(dtype=torch.int32)
    key = torch.where(cand, cnt_all, float("inf"))
    sorted_cnt, order = torch.sort(key, stable=True)
    rank = torch.empty(m, dtype=torch.int32, device=dev)
    rank[order] = torch.arange(m, dtype=torch.int32, device=dev)
    cut = torch.clamp_min(n_cand - (lim - 1), 0)
    demote = cand & (rank < cut) & (dic_all != 0)
    promote = cand & (rank >= cut) & (rank < n_cand) & (dic_all == 0)

    free, free_top = push_slots(st["free"], st["free_top"], dic_all[order],
                                demote[order])
    dic_all = torch.where(demote, 0, dic_all)
    rorder = torch.flip(order, [0])
    slot_s, got_s, free_top = alloc_slots(free, free_top, promote[rorder])
    new_dic = torch.empty(m, dtype=torch.int32, device=dev)
    new_dic[rorder] = torch.where(got_s, slot_s, 0)
    dic_all = torch.where(promote, new_dic, dic_all)

    # a 1-lane gather: a 0-d tensor index would be read to the host
    at_cut = sorted_cnt[(cut - 1).clamp(0, m - 1).long().reshape(1)][0]
    thr = torch.where(cut > 0, at_cut, st["threshold"])
    n1e = st["cnt1"].numel()
    return {**st,
            "dic1": dic_all[:n1e].view(st["dic1"].shape),
            "dic2": dic_all[n1e:].view(st["dic2"].shape),
            "free": free, "free_top": free_top, "threshold": thr,
            "real_n": torch.clamp_max(n_cand, lim - 1)}


def revert_promotions_plus(cfg: CafePlusConfig, st: SketchState,
                           ids: torch.Tensor, promo: InsertResult,
                           excess: torch.Tensor) -> SketchState:
    """Undo promotions on `excess` lanes: find the cell holding (id, slot)
    in either tier, clear its slot, push the slot back. Counts stay, so
    the id re-promotes on its next touch. `ids` is unused (the report's
    own ids are re-hashed)."""
    del ids
    ids, slots = promo.ids, promo.slots
    live = excess & promo.mask & (slots != 0)
    n1p, n2p = st["val1"].shape[0], st["val2"].shape[0]

    h1 = _h1(cfg, ids).long()
    bv, bd = _cells_of(st["val1"], st["dic1"], rows=h1)
    m1 = live[:, None] & (bv == ids[:, None]) & (bd == slots[:, None])
    in1 = m1.any(dim=1)
    dic1 = _set_cells(st["dic1"], torch.where(in1, h1, n1p), _first_true(m1),
                      torch.zeros_like(slots))

    h2 = _h2(cfg, ids).long()
    bv, bd = _cells_of(st["val2"], st["dic2"], rows=h2)
    m2 = live[:, None] & ~in1[:, None] & (bv == ids[:, None]) \
        & (bd == slots[:, None])
    in2 = m2.any(dim=1)
    dic2 = _set_cells(st["dic2"], torch.where(in2, h2, n2p), _first_true(m2),
                      torch.zeros_like(slots))

    free, free_top = push_slots(st["free"], st["free_top"], slots,
                                live & (in1 | in2))
    return {**st, "dic1": dic1, "dic2": dic2, "free": free,
            "free_top": free_top}


def sketch_insert_plus(cfg: CafePlusConfig, st: SketchState,
                       ids: torch.Tensor, scores: torch.Tensor,
                       ) -> Tuple[SketchState, InsertResult]:
    """Batched insert of (id, importance) pairs; padded lanes carry
    INVALID_ID. Returns the new state and the promotions as an
    InsertResult over the B id-sorted lanes (bucket / cell None: the
    revert re-hashes)."""
    dev = ids.device
    b = ids.shape[0]
    c = cfg.cells
    n1p, n2p = st["val1"].shape[0], st["val2"].shape[0]
    lanes = torch.arange(b, device=dev)
    scores = torch.where(ids != int(INVALID_ID), scores, 0.0)

    # ---- lazy exponential decay, on the device's branch
    decay_acc = st["decay_acc"] * float(np.float32(cfg.alpha))
    decayed = cond(decay_acc > DECAY_V, _decay, _same,
                   (decay_acc, st["threshold"], st["cnt1"], st["cnt2"]),
                   name="plus_decay")
    st = {**st, **dict(zip(_DECAY_FIELDS, decayed))}

    # ---- adaptive threshold rebuild, on the device's branch
    if cfg.adjust_threshold:
        def reset(*fields):
            rs = _reset(cfg, {**st, **dict(zip(_RESET_FIELDS, fields))})
            return tuple(rs[k] for k in _RESET_FIELDS)

        st = {**st, **dict(zip(_RESET_FIELDS, cond(
            st["real_n"] > int(cfg.lim * 1.2), reset, _same,
            tuple(st[k] for k in _RESET_FIELDS), name="plus_reset")))}

    thr = st["threshold"]
    step = st["step"] + 1

    # ---- sort + dedup: each distinct id's lanes sum at its first lane
    order = torch.sort(ids, stable=True).indices
    sid, ssc = ids[order], scores[order]
    head = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                      sid[1:] != sid[:-1]])
    seg = torch.cumsum(head, 0) - 1
    uscore = torch.zeros(b, dtype=torch.float32, device=dev).index_add_(
        0, seg, ssc)[seg]
    active = head & (sid != int(INVALID_ID))

    val1, cnt1, dic1 = st["val1"], st["cnt1"], st["dic1"]
    val2, cnt2, dic2, ts2 = st["val2"], st["cnt2"], st["dic2"], st["ts2"]
    free, free_top, real_n = st["free"], st["free_top"], st["real_n"]
    promo_slot = torch.zeros(b, dtype=torch.int32, device=dev)
    steps = step.expand(b)
    h1 = _h1(cfg, sid).long()
    h2 = _h2(cfg, sid).long()

    # ---- 1. main-tier match
    bv, bc, bd = _cells_of(val1, cnt1, dic1, rows=h1)
    m1 = (bc > 0) & (bv == sid[:, None])
    matched1 = m1.any(dim=1) & active
    cell1 = _first_true(m1)
    old_cnt = _pick(bc, cell1)
    new_cnt = old_cnt + torch.where(matched1, uscore, 0.0)
    cnt1 = _set_cells(cnt1, torch.where(matched1, h1, n1p), cell1, new_cnt)
    real_n = real_n + (matched1 & (new_cnt >= thr)
                       & (old_cnt < thr)).sum(dtype=torch.int32)
    want = matched1 & (new_cnt >= thr) & (_pick(bd, cell1) == 0)
    slot, got, free_top = alloc_slots(free, free_top, want)
    dic1 = _set_cells(dic1, torch.where(got, h1, n1p), cell1, slot)
    promo_slot = torch.where(got, slot, promo_slot)

    # ---- 2. staging-tier match (the reference's insertLRU)
    pend = active & ~matched1
    sv, sc, sd = _cells_of(val2, cnt2, dic2, rows=h2)
    m2 = (sc > 0) & (sv == sid[:, None])
    matched2 = m2.any(dim=1) & pend
    cell2 = _first_true(m2)
    old2 = _pick(sc, cell2)
    new2 = old2 + torch.where(matched2, uscore, 0.0)
    hm = torch.where(matched2, h2, n2p)
    cnt2 = _set_cells(cnt2, hm, cell2, new2)
    ts2 = _set_cells(ts2, hm, cell2, steps)
    real_n = real_n + (matched2 & (new2 >= thr)
                       & (old2 < thr)).sum(dtype=torch.int32)
    want2 = matched2 & (new2 >= thr) & (_pick(sd, cell2) == 0)
    slot2, got2, free_top = alloc_slots(free, free_top, want2)
    dic2 = _set_cells(dic2, torch.where(got2, h2, n2p), cell2, slot2)
    promo_slot = torch.where(got2, slot2, promo_slot)

    # staged ids over the threshold graduate to the main tier
    graduate = matched2 & (new2 >= thr)
    gdic = torch.where(got2, slot2, _pick(sd, cell2))
    val1, cnt1, dic1, free, free_top, dropped = _main_tier_insert(
        cfg, val1, cnt1, dic1, free, free_top, sid, new2, gdic, graduate)
    # a dropped graduate lost its slot there: un-promote it
    promo_slot = torch.where(dropped & got2, 0, promo_slot)
    # its staging cell is cleared whether it moved or was dropped
    hz = torch.where(graduate, h2, n2p)
    zi = torch.zeros(b, dtype=torch.int32, device=dev)
    val2 = _set_cells(val2, hz, cell2, zi)
    cnt2 = _set_cells(cnt2, hz, cell2, zi.float())
    dic2 = _set_cells(dic2, hz, cell2, zi)
    ts2 = _set_cells(ts2, hz, cell2, zi)

    # ---- 3. new ids displace staging LRU victims: the fresh ids of a
    # bucket take distinct cells (empty ones first, ts 0, then LRU order),
    # up to `cells` a bucket a batch; the rest retry on a later batch
    fresh = pend & ~matched2
    key_b = torch.where(fresh, h2, n2p)
    order2 = torch.sort(key_b, stable=True).indices
    sh = key_b[order2]
    # a lane's rank in its bucket's run: its sorted position less the
    # run's first (the left search of its key in the sorted keys)
    seg_start = torch.searchsorted(sh, sh)
    rank = torch.empty(b, dtype=torch.int32, device=dev)
    rank[order2] = (lanes - seg_start).to(torch.int32)

    sv, sc, sd = _cells_of(val2, cnt2, dic2, rows=h2)
    placed = fresh & (rank < c)
    # the victim: the cell at position rank of the bucket's stable LRU
    # order over timestamps (empty cells, ts 0, first)
    placed_cell = _stable_order_pick(_cells_of(ts2, rows=h2),
                                     rank.clamp(0, c - 1))
    vval, vcnt, vdic = (_pick(sv, placed_cell), _pick(sc, placed_cell),
                        _pick(sd, placed_cell))
    occupied_v = vcnt > 0
    # displaced victims worth keeping move to the main tier
    vic_move = placed & occupied_v & ((vdic != 0)
                                      | (vcnt >= LRU_MOVE_MIN_CNT))
    new_cnt2 = uscore
    if cfg.inherit:
        # only from victims whose count is discarded, not moved
        new_cnt2 = uscore + torch.where(occupied_v & ~vic_move, vcnt, 0.0)
    hw = torch.where(placed, h2, n2p)
    val2 = _set_cells(val2, hw, placed_cell, sid)
    cnt2 = _set_cells(cnt2, hw, placed_cell, new_cnt2)
    dic2 = _set_cells(dic2, hw, placed_cell, zi)
    ts2 = _set_cells(ts2, hw, placed_cell, steps)
    # a placed count that already clears the threshold is a crossing and
    # earns a slot at once; the id graduates on its next touch
    crossed3 = placed & (new_cnt2 >= thr)
    real_n = real_n + crossed3.sum(dtype=torch.int32)
    slot3, got3, free_top = alloc_slots(free, free_top, crossed3)
    dic2 = _set_cells(dic2, torch.where(got3, h2, n2p), placed_cell, slot3)
    promo_slot = torch.where(got3, slot3, promo_slot)
    val1, cnt1, dic1, free, free_top, _ = _main_tier_insert(
        cfg, val1, cnt1, dic1, free, free_top,
        torch.where(vic_move, vval, 0), torch.where(vic_move, vcnt, 0.0),
        torch.where(vic_move, vdic, 0), vic_move)

    new_st = {"val1": val1, "cnt1": cnt1, "dic1": dic1,
              "val2": val2, "cnt2": cnt2, "dic2": dic2, "ts2": ts2,
              "free": free, "free_top": free_top, "threshold": thr,
              "real_n": real_n, "decay_acc": st["decay_acc"], "step": step}
    return new_st, InsertResult(ids=sid, slots=promo_slot,
                                mask=promo_slot > 0)
