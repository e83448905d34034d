"""CAFE embedding (port of cafe_tpu/embeddings/cafe.py, v1 sketch, one
device).

The hot table and the per-field hash tables live in ONE table (hot rows
first, hash rows at `hash_base`), so the forward is one routed gather and
the backward one scatter:

  gather       query the sketch with field-offset ids; a hot id reads its
               exclusive row, every other id its field's hash row;
  apply_grads  per-sample importance (grad L2 norm normalised to mean 1
               per field, or 1 per occurrence with use_freq) -> sketch
               insert -> lossless promotion cap (excess promotions are
               reverted and retry on their next touch) -> migration of
               each promoted id's hash row into its new hot row -> one
               sparse SGD apply to the rows that served the batch.

State: {"table": f32 [total_rows, D], "sketch": the sketch dict,
"tick": int32 []} — the JAX part's state with the sketch's NamedTuple
as a dict. The table is updated IN PLACE (the JAX package donates it).
CAFE+ (`plus=True`) and the sharded paths are not ported yet.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.sparse import SLOT_SUFFIXES
from ..sketch.hotsketch import (
    PROMO_LANES,
    HotSketchConfig,
    init_sketch,
    revert_promotions,
    sketch_insert,
    sketch_query,
)
from .base import Part, _offsets, round_up


class CafePart(Part):
    def __init__(self, field_idx: List[int], counts: List[int],
                 global_offsets: List[int], hotn: int,
                 hash_sizes: List[int], dim: int,
                 sketch_threshold: float, sketch_decay: float,
                 max_count: int, optimizer: str = "sgd",
                 use_freq: bool = False, mig_lanes: int = 256,
                 insert_interval: int = 1, land_impl: str = "segmax"):
        self.field_idx = list(field_idx)
        self.counts = [int(c) for c in counts]
        self.global_offsets = [int(o) for o in global_offsets]
        self.hotn = int(hotn)
        self.hash_sizes = [int(h) for h in hash_sizes]
        self.dim = dim
        self.optimizer = optimizer
        self.use_freq = use_freq
        self.max_count = int(max_count)
        self.hash_off = _offsets(self.hash_sizes)
        self.hash_rows = int(sum(self.hash_sizes))
        self.hash_base = round_up(self.hotn)
        self.total_rows = self.hash_base + round_up(self.hash_rows)
        self.mig_lanes = int(mig_lanes)
        self.insert_interval = max(int(insert_interval), 1)
        max_oid = max(o + n for o, n in zip(self.global_offsets,
                                           self.counts))
        self.sketch_cfg = HotSketchConfig(
            buckets=self.hotn, threshold=float(sketch_threshold),
            decay=float(sketch_decay), land_impl=land_impl,
            max_id=int(max_oid))

    def init(self, rng: np.random.Generator) -> Dict:
        """Same numpy draws as the JAX part: the hot rows, then each
        field's hash rows."""
        table = np.zeros((self.total_rows, self.dim), dtype=np.float32)
        high_scale = np.sqrt(1.0 / self.max_count)
        table[: self.hotn] = rng.uniform(
            -high_scale, high_scale,
            size=(self.hotn, self.dim)).astype(np.float32)
        lo = self.hash_base
        for n, hs in zip(self.counts, self.hash_sizes):
            scale = np.sqrt(1.0 / n)
            table[lo:lo + hs] = rng.uniform(
                -scale, scale, size=(hs, self.dim)).astype(np.float32)
            lo += hs
        state = {
            "table": torch.from_numpy(table).to(self.device),
            "sketch": init_sketch(self.sketch_cfg, self.device),
            "tick": torch.zeros((), dtype=torch.int32, device=self.device),
        }
        return self._maybe_acc(state, "table")

    def _oids(self, ids: torch.Tensor) -> torch.Tensor:
        return ids + self._const("global_offsets")

    def _rows(self, oids, is_hot, slot):
        """Unified row index: hot slot or hash_base + per-field hash row."""
        hrow = (oids % self._const("hash_sizes")) \
            + self._const("hash_off") + self.hash_base
        return torch.where(is_hot, slot, hrow), hrow

    def gather(self, state: Dict, ids: torch.Tensor):
        b, f = ids.shape
        oids = self._oids(ids)
        q = sketch_query(self.sketch_cfg, state["sketch"],
                         oids.reshape(-1)).reshape(b, f)
        is_hot = q < 0
        slot = torch.where(is_hot, -q, 0)
        row, hrow = self._rows(oids, is_hot, slot)
        raw = state["table"][row.long()]
        return raw, (oids, row, hrow, is_hot)

    def _insert_and_compact(self, sketch_in, flat_oids, g_raw):
        """Score -> insert -> lossless promotion cap -> fixed-lane
        compaction. Returns (sketch, p_ids, p_slots, p_mask)."""
        b, f, _ = g_raw.shape
        interval = self.insert_interval
        if self.use_freq:
            scores = torch.full((b, f), float(interval), dtype=torch.float32,
                                device=g_raw.device)
        else:
            norms = torch.sqrt((g_raw * g_raw).sum(dim=-1) + 1e-30)
            scores = norms * (b * interval) / (
                norms.sum(dim=0, keepdim=True) + 1e-30)
        sk, promo = sketch_insert(self.sketch_cfg, sketch_in, flat_oids,
                                  scores.reshape(-1))
        L = promo.ids.shape[0]
        cap = min(L, self.hotn, max(self.mig_lanes * 16, 4096))
        mask = promo.mask
        if cap >= L:
            return sk, promo.ids, promo.slots, mask
        rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
        excess = mask & (rank >= cap)
        sk = revert_promotions(self.sketch_cfg, sk, flat_oids, promo, excess)
        mask = mask & ~excess
        pos = torch.where(mask, rank.clamp(0, cap - 1), cap).long()

        def compact(v):
            out = torch.zeros(cap + 1, dtype=v.dtype, device=v.device)
            out[pos] = v   # in-range positions are distinct; cap = spare
            return out[:cap]

        return sk, compact(promo.ids), compact(promo.slots), compact(mask)

    def apply_grads(self, state: Dict, ids: torch.Tensor,
                    g_raw: torch.Tensor, aux, lr: float):
        oids, row, hrow, is_hot = aux
        b, f, d = g_raw.shape
        flat_oids = oids.reshape(-1)
        interval = self.insert_interval
        if interval > 1 and int(state["tick"]) % interval != 0:
            # skipped insert: an empty report of the compacted lane count
            cap_l = min(min(flat_oids.shape[0], PROMO_LANES), self.hotn,
                        max(self.mig_lanes * 16, 4096))
            z = torch.zeros(cap_l, dtype=torch.int32, device=oids.device)
            sk, p_ids, p_slots, p_mask = state["sketch"], z, z, z.bool()
        else:
            sk, p_ids, p_slots, p_mask = self._insert_and_compact(
                state["sketch"], flat_oids, g_raw)

        # migration BEFORE the optimizer touches the cold rows (reference
        # insert_grad-then-step order). Lanes without a promotion write
        # their source row onto itself: hash rows never receive a
        # promotion, so those writes change nothing and need no mask.
        goff = self._const("global_offsets")[0]
        pfield = (torch.searchsorted(goff, p_ids, right=True) - 1).clamp(
            0, len(self.field_idx) - 1)
        prow = ((p_ids % self._const("hash_sizes")[0][pfield])
                + self._const("hash_off")[0][pfield]).clamp(
                    0, self.hash_rows - 1) + self.hash_base
        dst = torch.where(p_mask, p_slots, prow).long()
        table = state["table"]
        table[dst] = table[prow.long()]
        state = {**state, "sketch": sk, "tick": state["tick"] + 1}
        # freshly promoted slots restart their optimizer state (the same
        # write-back trick for lanes without a promotion)
        for sfx in SLOT_SUFFIXES[self.optimizer].values():
            slot_t = state["table" + sfx]
            if slot_t.dim() == 2:
                slot_t[dst] = torch.where(p_mask[:, None], 0.0,
                                          slot_t[prow.long()])

        # one scatter updates whichever row served each sample
        state = self._table_update(state, "table", row.reshape(-1),
                                   g_raw.reshape(b * f, d), lr)
        stats = {
            "cafe_promotions": p_mask.sum(),
            "cafe_hot_frac": is_hot.float().mean(),
        }
        return state, stats
