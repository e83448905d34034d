"""HotSketch v1 (port of cafe_tpu/sketch/hotsketch.py).

A device-resident bucketized Space-Saving sketch: S buckets x C cells,
each cell holding (id, score, hot slot). An id's score accumulates on
every insert; crossing the threshold promotes it to an exclusive hot slot
from a free stack; new ids take an empty cell or evict the unprotected
min-score cell (inheriting its count); when the score mass since the last
decay exceeds S * threshold * 10, every count decays and hot ids that fall
below the threshold are demoted. The JAX module's docstrings give the
design (one sort by (bucket, id), one wide gather, one B-lane landing).

State is a dict of tensors with the JAX HotSketchState's field names:
val int32 [Sp, C], cnt float32 [Sp, C], dic int32 [Sp, C], free int32
[Sp], free_top int32 [], tot float32 [] (Sp = S padded to ROW_ALIGN).
Functions return new tensors and leave their inputs untouched.

The port reproduces the JAX insert bit for bit on the same inputs: the
uint32 hash wraps as in JAX (emulated in int64), the two-key sort is one
stable sort of a composite int64 key, bitcasts are Tensor.view, argmin /
argmax return the first index among ties, and gathers that JAX clamps
are clamped explicitly. No step reads a value back to the host.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Tuple

import numpy as np
import torch

from ..device import resolve_device
from ..ops.sorted_update import land_max, seg_max, use_scatter_landing

# Sentinel for padded/invalid lanes; sorts to the end of any real id range.
INVALID_ID = np.int32(2**31 - 1)

_HASH_MULT = 2654435761  # Knuth multiplicative hash (uint32)
_U32 = 0xFFFFFFFF
_I32_MAX = 2**31 - 1

# Fixed lane budget for compacted promotion lists (and round-2 retries).
PROMO_LANES = 4096

SketchState = Dict[str, torch.Tensor]


class HotSketchConfig(NamedTuple):
    """Static configuration (same fields and defaults as the JAX one)."""

    buckets: int          # S; == hot-slot limit
    threshold: float      # promotion threshold k
    decay: float = 0.99   # multiplicative decay rate
    cells: int = 4        # C cells per bucket
    insert_rounds: int = 2  # conflict-resolution rounds for new-id placement
    # landing implementation (ops/sorted_update.land_max): 'auto' lands
    # through kernel K1 at every sketch size; 'scatter' skips the landing
    # and scatters the writes (use_scatter_landing)
    land_impl: str = "auto"
    # exclusive upper bound on inserted ids; below 2^27 the landing packs
    # (cell, id) into one channel (C+1 channels instead of 2C)
    max_id: int = 2**31


class InsertResult(NamedTuple):
    """Newly promoted ids; `slots[i]` is valid only where `mask[i]`. The
    v1 sketch compacts them to <= PROMO_LANES lanes and (`bucket`,
    `cell`) locate each promoted cell for reverts; the CAFE+ sketch
    reports its B id-sorted lanes and leaves them None (its revert
    re-hashes)."""

    ids: torch.Tensor    # int32 [L]
    slots: torch.Tensor  # int32 [L]
    mask: torch.Tensor   # bool  [L]
    bucket: torch.Tensor = None  # int32 [L]
    cell: torch.Tensor = None    # int32 [L]


def init_sketch(cfg: HotSketchConfig, device="cuda") -> SketchState:
    """A fresh sketch on `device` (default the card; raises without CUDA
    unless device='cpu')."""
    device = resolve_device(device)
    # rows padded as the JAX package pads them (its sharding alignment);
    # imported here: embeddings/ imports this module
    from ..embeddings.base import round_up
    s, c = cfg.buckets, cfg.cells
    sp = round_up(s)
    free = np.zeros(sp, dtype=np.int32)
    free[: s - 1] = np.arange(1, s, dtype=np.int32)
    z = dict(device=device)
    return {
        "val": torch.zeros((sp, c), dtype=torch.int32, **z),
        "cnt": torch.zeros((sp, c), dtype=torch.float32, **z),
        "dic": torch.zeros((sp, c), dtype=torch.int32, **z),
        "free": torch.from_numpy(free).to(device),
        "free_top": torch.tensor(s - 1, dtype=torch.int32, **z),
        "tot": torch.tensor(0.0, dtype=torch.float32, **z),
    }


def mul_u32(ids: torch.Tensor, mult: int) -> torch.Tensor:
    """uint32(id) * mult mod 2^32, as int64. The wrapping uint32 product
    is formed from two partial products that stay below 2^48, so the
    int64 arithmetic never overflows."""
    x = ids.long() & _U32
    lo = x * (mult & 0xFFFF)
    hi = ((x * (mult >> 16)) & 0xFFFF) << 16
    return (lo + hi) & _U32


def _bucket_of(cfg: HotSketchConfig, ids: torch.Tensor) -> torch.Tensor:
    """(uint32(id) * 2654435761 mod 2^32) % S, as int32."""
    return (mul_u32(ids, _HASH_MULT) % cfg.buckets).to(torch.int32)


def query_cells(cfg: HotSketchConfig, val: torch.Tensor, cnt: torch.Tensor,
                dic: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """-hot_slot for hot ids, the id itself otherwise."""
    h = _bucket_of(cfg, ids).long()
    m = (cnt[h] > 0) & (val[h] == ids[:, None]) & (dic[h] != 0)
    slot = torch.where(m, dic[h], 0).amax(dim=1)
    return torch.where(slot > 0, -slot, ids)


def sketch_query(cfg: HotSketchConfig, state: SketchState,
                 ids: torch.Tensor) -> torch.Tensor:
    """For each id return -hot_slot if hot else the id itself."""
    return query_cells(cfg, state["val"], state["cnt"], state["dic"], ids)


def _cumsum32(x: torch.Tensor) -> torch.Tensor:
    return torch.cumsum(x.to(torch.int32), 0, dtype=torch.int32)


def alloc_slots(free, free_top, want_mask):
    """Pop a free hot slot per True lane of want_mask (by prefix-sum rank).
    Returns (slot, got, new_free_top)."""
    rank = _cumsum32(want_mask)
    idx = free_top - rank
    got = want_mask & (idx >= 0)
    slot = torch.where(got, free[idx.clamp(0, free.shape[0] - 1).long()], 0)
    return slot, got, free_top - got.sum(dtype=torch.int32)


def _set_drop(dst: torch.Tensor, idx: torch.Tensor,
              vals: torch.Tensor) -> torch.Tensor:
    """dst with dst[idx[i]] = vals[i] where 0 <= idx[i] < len(dst); other
    lanes are dropped (XLA scatter mode='drop'). Indices in range must be
    distinct. Returns a new tensor."""
    n = dst.shape[0]
    out = torch.cat([dst, dst[:1]])
    keep = (idx >= 0) & (idx < n)
    out[torch.where(keep, idx, n).long()] = vals.to(dst.dtype)
    return out[:n]


def _set_cells(dst: torch.Tensor, rows: torch.Tensor, cells: torch.Tensor,
               vals: torch.Tensor) -> torch.Tensor:
    """dst [R, C] with dst[rows[i], cells[i]] = vals[i] where rows[i] is in
    [0, R); lanes with rows[i] == R are dropped. Writes in range must hit
    distinct elements. Returns a new tensor."""
    r, c = dst.shape
    flat = rows.long() * c + cells.long()
    return _set_drop(dst.reshape(-1), flat, vals).view(r, c)


def push_slots(free, free_top, slots, mask):
    """Push slots[mask] onto the free stack."""
    pos = free_top + _cumsum32(mask) - 1
    pos = torch.where(mask, pos, free.shape[0])
    free = _set_drop(free, pos, slots)
    return free, free_top + mask.sum(dtype=torch.int32)


def _decay(cfg: HotSketchConfig, state: SketchState) -> SketchState:
    """Multiplicative decay + demotion of hot ids dropping below
    threshold."""
    demote = (state["dic"] != 0) & (state["cnt"] * cfg.decay < cfg.threshold)
    free, free_top = push_slots(state["free"], state["free_top"],
                                state["dic"].reshape(-1), demote.reshape(-1))
    return {**state, "cnt": state["cnt"] * cfg.decay,
            "dic": torch.where(demote, 0, state["dic"]),
            "free": free, "free_top": free_top,
            "tot": torch.zeros_like(state["tot"])}


def _prev(x: torch.Tensor, fill) -> torch.Tensor:
    """x shifted one lane right (x[i-1]), first lane = fill."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype, device=x.device),
                      x[:-1]])


def _cummax(x: torch.Tensor) -> torch.Tensor:
    return torch.cummax(x, 0).values


def _first_true(m: torch.Tensor) -> torch.Tensor:
    """Index of the first True along dim 1 (0 where none), int32."""
    return torch.argmax(m.to(torch.int32), dim=1).to(torch.int32)


def _place(bc: torch.Tensor, bd: torch.Tensor, blocked: torch.Tensor):
    """Target cell for a newcomer over gathered cells [L, C]: the first
    empty cell, else the min-count unprotected cell not `blocked`.
    Returns (use_cell, placeable, victim count)."""
    occ = bc > 0.0
    has_empty = (~occ).any(dim=1)
    bc_vic = torch.where(occ & (bd == 0) & ~blocked, bc, float("inf"))
    cell_v = torch.argmin(bc_vic, dim=1).to(torch.int32)
    can_evict = torch.isfinite(bc_vic.amin(dim=1))
    use_cell = torch.where(has_empty, _first_true(~occ), cell_v)
    cells = torch.arange(bc.shape[1], dtype=torch.int32, device=bc.device)
    bc_u = torch.where(use_cell[:, None] == cells, bc, 0.0).sum(dim=1)
    return use_cell, has_empty | can_evict, bc_u


def sketch_insert(cfg: HotSketchConfig, state: SketchState,
                  ids: torch.Tensor, scores: torch.Tensor,
                  ) -> Tuple[SketchState, InsertResult]:
    """Batched insert of (id, importance) pairs — the JAX package's
    sorted design, step for step (see its docstring for the reasons).

    Padded lanes carry id == INVALID_ID; scores must be non-negative.
    Every (bucket, cell) has at most one writer per round, and all round-1
    writes land through one `land_max` over the sorted lanes (kernel K1
    under land_impl 'auto'), or, under land_impl 'scatter', go straight
    into copies of the [Sp, C] arrays: cnt by one row scatter-max, val and
    dic by element sets whose dropped lanes write a spare element that is
    cut off (torch has no mode='drop'). Both give the same state."""
    dev = ids.device
    b = ids.shape[0]
    s, c = cfg.buckets, cfg.cells
    sp = state["val"].shape[0]
    # f32 constants as Python floats: a tensor made from a host value
    # would cost a copy that waits for the card
    k = float(np.float32(cfg.threshold))
    decay_at = float(np.float32(s) * np.float32(cfg.threshold)
                     * np.float32(10.0))
    pl = min(b, PROMO_LANES)
    cells = torch.arange(c, dtype=torch.int32, device=dev)

    valid = ids != int(INVALID_ID)
    scores = torch.where(valid, scores.clamp_min(0.0), 0.0)

    # ---- occasional global decay, as unconditional elementwise math
    # (fdec == 1.0 multiplies bit-exactly and demotes nothing)
    do_decay = state["tot"] > decay_at
    fdec = torch.where(do_decay, float(np.float32(cfg.decay)), 1.0)
    demote = (state["dic"] != 0) & (state["cnt"] * fdec < k)
    cnt = state["cnt"] * fdec
    dic = torch.where(demote, 0, state["dic"])
    free, free_top = push_slots(state["free"], state["free_top"],
                                state["dic"].reshape(-1),
                                (demote & do_decay).reshape(-1))
    val = state["val"]
    tot = torch.where(do_decay, 0.0, state["tot"])

    # ---- sort by (bucket, id); invalid lanes key to bucket s (the end).
    # One stable sort of h * 2^32 + (id + 2^31) == lax.sort(num_keys=2).
    h = torch.where(valid, _bucket_of(cfg, ids), s)
    key = h.long() * (1 << 32) + (ids.long() + (1 << 31))
    order0 = torch.sort(key, stable=True).indices
    h_s, id_s, sc_s = h[order0], ids[order0], scores[order0]
    ok = h_s < s
    hsafe = h_s.clamp_max(sp - 1).long()

    # group = one distinct (bucket, id); rep = its LAST lane
    same_prev = (h_s == _prev(h_s, -1)) & (id_s == _prev(id_s, -1))
    rep = ok & ~torch.cat([same_prev[1:],
                           torch.zeros(1, dtype=torch.bool, device=dev)])
    cs = torch.cumsum(sc_s, 0)
    pe = _prev(_cummax(torch.where(rep, cs, 0.0)), 0.0)
    gtot = cs - pe  # valid at rep lanes

    # ---- match against the (decayed) cells of each lane's bucket [B, C]
    bv = val[hsafe]
    bc = state["cnt"][hsafe] * fdec
    bd0 = state["dic"][hsafe]
    bd = torch.where((bd0 != 0) & (bc < k), 0, bd0)
    occ = bc > 0.0
    m = occ & (bv == id_s[:, None])
    m_any = m.any(dim=1)
    cell_m = _first_true(m)
    matched = m_any & rep
    bc_m = torch.where(m, bc, 0.0).sum(dim=1)
    bd_m = torch.where(m, bd, 0).sum(dim=1, dtype=torch.int32)

    # ---- per-bucket matched-cell bitmask over each bucket's lane segment
    nxt_h = torch.cat([h_s[1:], torch.full((1,), -1, dtype=h_s.dtype,
                                           device=dev)])
    rep_b = ok & (h_s != nxt_h)
    mbits = torch.where(matched, torch.ones_like(cell_m) << cell_m, 0)
    csb = _cumsum32(mbits)
    start_b = _prev(_cummax(torch.where(rep_b, csb, 0)), 0)
    end_b = torch.flip(torch.cummin(torch.flip(
        torch.where(rep_b, csb, _I32_MAX), [0]), 0).values, [0])
    bucket_mbits = end_b - start_b
    cell_is_matched = ((bucket_mbits[:, None] >> cells[None, :]) & 1) > 0

    # ---- per-bucket winner among new-id groups: first unmatched rep
    un = rep & ~m_any
    prev_un_bucket = _prev(_cummax(torch.where(un, h_s, -1)), -1)
    winner = un & (prev_un_bucket != h_s)
    use_cell, placeable, bc_u = _place(bc, bd, cell_is_matched)
    placed = winner & placeable
    place_cnt = bc_u + gtot

    # ---- promotion: matched cells crossing the threshold
    cand = matched & (bc_m + gtot >= k) & (bd_m == 0)
    rank = _cumsum32(cand)
    bound = torch.clamp_max(free_top, pl)
    got = cand & (rank <= bound)
    ft0 = free_top
    n_got = torch.minimum(rank[-1], bound)
    free_top = free_top - n_got

    # ---- THE B-lane landing: each writer encodes its cell's absolute new
    # (val, cnt), cnt as its non-negative f32 bits; -1 = no write
    mask_p = placed[:, None] & (use_cell[:, None] == cells)
    mask_w = (m & matched[:, None]) | mask_p
    cnt_new = torch.where(matched, bc_m + gtot, place_cnt)
    cnt_bits = cnt_new.to(torch.float32).view(torch.int32)
    scatter_mode = use_scatter_landing(cfg.land_impl, s)
    if scatter_mode:
        # cnt: a row scatter-max, where every written cell's new count is
        # >= its old one (matched cells add gtot >= 0, placements inherit
        # the victim's count) and the -1 payload of unwritten cells loses
        # to every count (counts are >= 0); invalid lanes max into the
        # spare row. val: <= 1 placed lane per bucket, an element set.
        rows = torch.where(ok, h_s, sp).long()[:, None].expand(-1, c)
        cnt = torch.cat([cnt, cnt[:1]]).scatter_reduce_(
            0, rows, torch.where(mask_w, cnt_new[:, None], -1.0), "amax",
            include_self=True)[:sp]
        val = _set_cells(val, torch.where(placed, h_s, sp), use_cell, id_s)
    elif cfg.max_id <= (1 << 27) and c <= 16:
        # packed landing: (target cell, id) in ONE channel. The CUDA
        # kernel lands raw payloads (no q = enc + 1 encoding), so any
        # cell < 16 packs without overflow.
        enc_pl = torch.where(placed, (use_cell << 27) | id_s, -1)
        enc = torch.cat([enc_pl[:, None],
                         torch.where(mask_w, cnt_bits[:, None], -1)], dim=1)
        mx = land_max(enc, h_s, s, cfg.land_impl)          # [S, C+1]
        mp = mx[:, 0]
        val_rows = torch.where(
            (mp[:, None] >= 0) & ((mp >> 27)[:, None] == cells[None, :]),
            (mp & ((1 << 27) - 1))[:, None], val[:s])
        cnt_rows = torch.where(mx[:, 1:] >= 0,
                               mx[:, 1:].contiguous().view(torch.float32),
                               cnt[:s])
    else:
        enc = torch.cat([torch.where(mask_p, id_s[:, None], -1),
                         torch.where(mask_w, cnt_bits[:, None], -1)], dim=1)
        mx = land_max(enc, h_s, s, cfg.land_impl)          # [S, 2C]
        val_rows = torch.where(mx[:, :c] >= 0, mx[:, :c], val[:s])
        cnt_rows = torch.where(mx[:, c:] >= 0,
                               mx[:, c:].contiguous().view(torch.float32),
                               cnt[:s])

    # ---- compact the promotion report (prio 0) and the round-2 losers
    # (prio 1) with one stable sort; slots + dic update at PROMO_LANES
    loser = un & ~winner
    prio = torch.where(got, 0, torch.where(loser, 1, 2))
    order = torch.argsort(prio, stable=True)
    lane_tab = torch.stack([id_s, h_s, cell_m, rank,
                            gtot.view(torch.int32)], dim=1)
    rp = lane_tab[order[:pl]]
    presp = torch.arange(pl, dtype=torch.int32, device=dev) < n_got
    p_id = rp[:, 0]
    p_h = torch.where(presp, rp[:, 1], s)
    p_cell = rp[:, 2]
    r_c = rp[:, 3]
    slot = torch.where(
        presp, free[(ft0 - r_c).clamp(0, free.shape[0] - 1).long()], 0)
    if scatter_mode:
        # one (bucket, cell) per promotion: set the slots directly
        dic = _set_cells(dic, torch.where(presp, p_h, sp), p_cell, slot)
    else:
        dic_enc = torch.where(presp[:, None] & (p_cell[:, None] == cells),
                              slot[:, None], -1)
        dmx = seg_max(dic_enc, p_h, s)
        dic_rows = torch.where(dmx >= 0, dmx, dic[:s])

    # ---- round 2: losing new-id groups retry against the round-1 arrays
    if cfg.insert_rounds > 1:
        order_pad = torch.cat([order, torch.zeros(pl, dtype=order.dtype,
                                                  device=dev)])
        lanes2 = n_got.long() + torch.arange(pl, device=dev)
        rl = lane_tab[order_pad[lanes2]]
        l_valid = torch.arange(pl, dtype=torch.int32, device=dev) \
            < loser.sum(dtype=torch.int32)
        l_h = torch.where(l_valid, rl[:, 1], s)
        l_hsafe = l_h.clamp_max(s - 1).long()
        l_id = rl[:, 0]
        l_g = rl[:, 4].view(torch.float32)
        bc2 = (cnt if scatter_mode else cnt_rows)[l_hsafe]
        bd2 = (dic if scatter_mode else dic_rows)[l_hsafe]
        prev_l_bucket = _prev(_cummax(torch.where(l_valid, l_h, -1)), -1)
        winner2 = l_valid & (prev_l_bucket != l_h)
        use2, placeable2, bc_u2 = _place(bc2, bd2,
                                         torch.zeros_like(bc2, dtype=bool))
        placed2 = winner2 & placeable2
        cnt2 = (bc_u2 + l_g).to(torch.float32)
        if scatter_mode:
            h2 = torch.where(placed2, l_h, sp)
            val = _set_cells(val, h2, use2, l_id)
            cnt = _set_cells(cnt, h2, use2, cnt2)
        else:
            cb2 = cnt2.view(torch.int32)
            mask_p2 = placed2[:, None] & (use2[:, None] == cells)
            enc2 = torch.cat([torch.where(mask_p2, l_id[:, None], -1),
                              torch.where(mask_p2, cb2[:, None], -1)], dim=1)
            mx2 = seg_max(enc2, l_h, s)
            val_rows = torch.where(mx2[:, :c] >= 0, mx2[:, :c], val_rows)
            cnt_rows = torch.where(
                mx2[:, c:] >= 0, mx2[:, c:].contiguous().view(torch.float32),
                cnt_rows)

    if not scatter_mode:
        val = torch.cat([val_rows, val[s:]])
        cnt = torch.cat([cnt_rows, cnt[s:]])
        dic = torch.cat([dic_rows, dic[s:]])
    new_state = {
        "val": val,
        "cnt": cnt,
        "dic": dic,
        "free": free,
        "free_top": free_top,
        "tot": tot + scores.sum(),
    }
    res = InsertResult(
        ids=torch.where(presp, p_id, int(INVALID_ID)),
        slots=slot, mask=presp, bucket=p_h, cell=p_cell)
    return new_state, res


def revert_promotions(cfg: HotSketchConfig, state: SketchState,
                      ids: torch.Tensor, promo: InsertResult,
                      excess: torch.Tensor) -> SketchState:
    """Undo the promotions on `excess` lanes of an InsertResult: clear the
    cell's slot and push it back on the free stack (lossless — the id
    re-promotes on its next touch). `ids` is unused (signature parity
    with the JAX package)."""
    del ids
    sp, c = state["dic"].shape
    live = excess & promo.mask
    flat = torch.where(live, promo.bucket.long() * c + promo.cell.long(),
                       sp * c)
    dic = _set_drop(state["dic"].reshape(-1), flat,
                    torch.zeros_like(flat, dtype=torch.int32)).view(sp, c)
    free, free_top = push_slots(state["free"], state["free_top"],
                                promo.slots, live)
    return {**state, "dic": dic, "free": free, "free_top": free_top}


def rebuild_free_list(cfg: HotSketchConfig,
                      state: SketchState) -> SketchState:
    """Rebuild the free stack from slot occupancy (after a checkpoint
    load): the free slots 1..S-1 in ascending order, then the rest; the
    padded free array keeps its shape and free_top never reaches the
    padding."""
    sp = state["free"].shape[0]
    dev = state["free"].device
    used = _set_drop(torch.zeros(sp, dtype=torch.bool, device=dev),
                     state["dic"].reshape(-1),
                     torch.ones(state["dic"].numel(), dtype=torch.bool,
                                device=dev))
    idx = torch.arange(sp, device=dev)
    free_mask = (idx >= 1) & (idx < cfg.buckets) & ~used
    order = torch.sort((~free_mask).to(torch.int32), stable=True).indices
    return {**state, "free": order.to(torch.int32),
            "free_top": free_mask.sum(dtype=torch.int32)}


def hot_fraction(cfg: HotSketchConfig, state: SketchState) -> torch.Tensor:
    """Fraction of the buckets-1 usable hot slots allocated (counted on
    the free stack)."""
    capacity = max(cfg.buckets - 1, 1)
    return (capacity - state["free_top"]) / capacity


def analyse(cfg: HotSketchConfig, state: SketchState,
            ids: torch.Tensor) -> torch.Tensor:
    """Fraction of `ids` currently hot (holding a slot): fed the offline
    ideal top-k ids, the sketch's recall."""
    return (sketch_query(cfg, state, ids) < 0).float().mean()


def analyse_tracked(cfg: HotSketchConfig, state: SketchState,
                    ids: torch.Tensor) -> torch.Tensor:
    """Fraction of `ids` present in the sketch at all (hot or cold)."""
    h = _bucket_of(cfg, ids).long()
    m = (state["cnt"][h] > 0) & (state["val"][h] == ids[:, None])
    return m.any(dim=1).float().mean()
