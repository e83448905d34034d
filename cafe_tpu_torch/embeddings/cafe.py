"""CAFE embedding (port of cafe_tpu/embeddings/cafe.py): the v1 sketch
or, with `plus`, the CAFE+ two-tier sketch, on one device or a mesh.

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
as a dict. The table is updated IN PLACE (the JAX package donates it;
under donate_state False the step passes a clone, train/step.py).

Under a mesh (enable_mesh) the part holds this rank's row shard and a
SHARD-LOCAL sketch (sketch/sharded.py): ids route to shards by
hash(id) % n, each shard inserts the ids it owns into its own buckets
with its own free stack, and promotions stay rank-local. The forward
all-gathers the ids and reduce-scatters the hot-row answers (id-sized
traffic) before the row exchange; the backward all-gathers (id, score)
pairs for the insert, migrates a bounded n*mig_lanes rows, then runs the
row-update exchange.

CAFE+ (`plus=True`) swaps the sketch (sketch/hotsketch_plus.py: a staging
tier, decay, an adaptive threshold) and nothing else: the sketch's init,
query, insert and revert are picked once in __init__, so the gather, the
insert and the sharded paths stay one code path. Its insert reports all
B*F lanes (v1 compacts to PROMO_LANES) before the migration cap.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.sparse import SLOT_SUFFIXES
from ..parallel.exchange import (DROP_ROW, _local_idx, _owner_rows,
                                 all_gather, psum, psum_scatter)
from ..sketch.hotsketch import (
    INVALID_ID,
    PROMO_LANES,
    HotSketchConfig,
    init_sketch,
    revert_promotions,
    sketch_insert,
    sketch_query,
)
from ..sketch.hotsketch_plus import (
    CafePlusConfig,
    init_sketch_plus,
    revert_promotions_plus,
    sketch_insert_plus,
    sketch_query_plus,
)
from ..sketch.sharded import (init_sharded_sketch, init_sharded_sketch_plus,
                              local_config, local_config_plus,
                              shard_global_view, shard_local_view, shard_of)
from .base import Part, _offsets, round_up


class CafePart(Part):
    def __init__(self, field_idx: List[int], counts: List[int],
                 global_offsets: List[int], hotn: int,
                 hash_sizes: List[int], dim: int,
                 sketch_threshold: float, sketch_decay: float,
                 max_count: int, optimizer: str = "sgd",
                 use_freq: bool = False, plus: bool = False,
                 adjust_threshold: bool = True, alpha: float = 1.000001,
                 mig_lanes: int = 256, plus_inherit: bool = False,
                 plus_staging_frac: float = 0.1, insert_interval: int = 1,
                 land_impl: str = "segmax"):
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
        self.plus = plus
        if plus:
            self.sketch_cfg = CafePlusConfig(
                lim=self.hotn, threshold=float(sketch_threshold),
                alpha=float(alpha), adjust_threshold=adjust_threshold,
                inherit=plus_inherit,
                staging_frac=float(plus_staging_frac))
            self._sk_init = init_sketch_plus
            self._sk_query = sketch_query_plus
            self._sk_insert = sketch_insert_plus
            self._sk_revert = revert_promotions_plus
        else:
            # exclusive bound on the offset ids this part inserts: below
            # 2^27 the landing packs (cell, id) into one channel
            max_oid = max(o + n for o, n in zip(self.global_offsets,
                                               self.counts))
            self.sketch_cfg = HotSketchConfig(
                buckets=self.hotn, threshold=float(sketch_threshold),
                decay=float(sketch_decay), land_impl=land_impl,
                max_id=int(max_oid))
            self._sk_init = init_sketch
            self._sk_query = sketch_query
            self._sk_insert = sketch_insert
            self._sk_revert = revert_promotions
        self.n_shards = 1

    def enable_mesh(self, mesh) -> bool:
        """Opt into the explicit exchange with a shard-local sketch (see
        the module docstring). Must be called BEFORE init()."""
        n = mesh.size
        if self.total_rows % n:
            return False
        try:
            lcfg, s_l = (local_config_plus if self.plus
                         else local_config)(self.sketch_cfg, n)
        except ValueError:
            return False
        if s_l < 2:
            return False
        self.mesh = mesh
        self.n_shards = n
        self._lcfg = lcfg
        self._s_l = s_l
        # a row of this rank's shard that no migration writes: the first
        # multiple of S_l at or after the shard's start is a shard's cold
        # sentinel slot 0 (or a hash row when >= hash_base); S_l < rows
        # per shard, so it lies inside the shard
        rows_l = self.total_rows // n
        self._spare_row = -(-mesh.rank * rows_l // s_l) * s_l \
            - mesh.rank * rows_l
        return True

    def init(self, rng: np.random.Generator) -> Dict:
        """Same numpy draws as the JAX part: the hot rows, then each
        field's hash rows. Under a mesh the GLOBAL state (the whole
        padded hot region drawn, since any shard's slot may serve, and
        the sharded sketch layout); parallel/sharding.shard_state cuts
        this rank's slices from it."""
        table = np.zeros((self.total_rows, self.dim), dtype=np.float32)
        high_scale = np.sqrt(1.0 / self.max_count)
        n_hot_init = self.hash_base if self.mesh is not None else self.hotn
        table[: n_hot_init] = rng.uniform(
            -high_scale, high_scale,
            size=(n_hot_init, self.dim)).astype(np.float32)
        lo = self.hash_base
        for n, hs in zip(self.counts, self.hash_sizes):
            scale = np.sqrt(1.0 / n)
            table[lo:lo + hs] = rng.uniform(
                -scale, scale, size=(hs, self.dim)).astype(np.float32)
            lo += hs
        if self.mesh is not None:
            sketch = (init_sharded_sketch_plus if self.plus
                      else init_sharded_sketch)(self.sketch_cfg,
                                                self.n_shards, self.device)
        else:
            sketch = self._sk_init(self.sketch_cfg, self.device)
        state = {
            "table": torch.from_numpy(table).to(self.device),
            "sketch": sketch,
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

    def _hash_rows(self, oids: torch.Tensor) -> torch.Tensor:
        """hash_base + the per-field hash row of offset ids, the field
        found by searchsorted over the global offsets (the JAX package's
        sharded and migration paths)."""
        goff = self._const("global_offsets")[0]
        pf = torch.searchsorted(goff, oids.contiguous(), right=True) - 1
        pf = pf.clamp(0, len(self.field_idx) - 1)
        return ((oids % self._const("hash_sizes")[0][pf])
                + self._const("hash_off")[0][pf]).clamp(
                    0, self.hash_rows - 1) + self.hash_base

    def gather(self, state: Dict, ids: torch.Tensor):
        if self.mesh is not None:
            return self._gather_sharded(state, ids)
        b, f = ids.shape
        oids = self._oids(ids)
        q = self._sk_query(self.sketch_cfg, state["sketch"],
                           oids.reshape(-1)).reshape(b, f)
        is_hot = q < 0
        slot = torch.where(is_hot, -q, 0)
        row, hrow = self._rows(oids, is_hot, slot)
        raw = state["table"][row.long()]
        return raw, (oids, row, hrow, is_hot)

    def _gather_sharded(self, state: Dict, ids: torch.Tensor):
        """Sharded forward: all-gather the offset ids; each sketch shard
        answers hot-routing for the ids it owns; an int32 reduce-scatter
        hands each rank its lanes' hot rows (id-sized traffic). The
        D-wide rows then move through the configured row exchange."""
        mesh, n, s_l = self.mesh, self.n_shards, self._s_l
        b, f = ids.shape
        oids = self._oids(ids)
        cand = all_gather(oids.reshape(-1), mesh)
        mine = shard_of(cand, n) == mesh.rank
        q = self._sk_query(self._lcfg, shard_local_view(state["sketch"]),
                           torch.where(mine, cand, int(INVALID_ID)))
        slot_g = torch.where(mine & (q < 0), -q + mesh.rank * s_l, 0)
        slot = psum_scatter(slot_g.to(torch.int32), mesh).reshape(b, f)
        is_hot = slot > 0
        row = torch.where(is_hot, slot, self._hash_rows(oids))
        raw = self._sharded_fetch(state["table"], row)
        return raw, (oids, row, is_hot)

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
        sk, promo = self._sk_insert(self.sketch_cfg, sketch_in, flat_oids,
                                    scores.reshape(-1))
        L = promo.ids.shape[0]
        cap = min(L, self.hotn, max(self.mig_lanes * 16, 4096))
        mask = promo.mask
        if cap >= L:
            return sk, promo.ids, promo.slots, mask
        rank = torch.cumsum(mask.to(torch.int32), 0, dtype=torch.int32) - 1
        excess = mask & (rank >= cap)
        sk = self._sk_revert(self.sketch_cfg, sk, flat_oids, promo, excess)
        mask = mask & ~excess
        pos = torch.where(mask, rank.clamp(0, cap - 1), cap).long()

        def compact(v):
            out = torch.zeros(cap + 1, dtype=v.dtype, device=v.device)
            out[pos] = v   # in-range positions are distinct; cap = spare
            return out[:cap]

        return sk, compact(promo.ids), compact(promo.slots), compact(mask)

    def apply_grads(self, state: Dict, ids: torch.Tensor,
                    g_raw: torch.Tensor, aux, lr: float):
        if self.mesh is not None:
            return self._apply_sharded(state, g_raw, aux, lr)
        oids, row, hrow, is_hot = aux
        b, f, d = g_raw.shape
        flat_oids = oids.reshape(-1)
        interval = self.insert_interval
        if interval > 1 and int(state["tick"]) % interval != 0:
            # skipped insert: an empty report of the compacted lane count
            # (the insert reports B*F lanes under CAFE+, <= PROMO_LANES
            # under v1)
            l0 = flat_oids.shape[0] if self.plus \
                else min(flat_oids.shape[0], PROMO_LANES)
            cap_l = min(l0, self.hotn, max(self.mig_lanes * 16, 4096))
            z = torch.zeros(cap_l, dtype=torch.int32, device=oids.device)
            sk, p_ids, p_slots, p_mask = state["sketch"], z, z, z.bool()
        else:
            sk, p_ids, p_slots, p_mask = self._insert_and_compact(
                state["sketch"], flat_oids, g_raw)

        # migration BEFORE the optimizer touches the cold rows (reference
        # insert_grad-then-step order). Lanes without a promotion write
        # their source row onto itself: hash rows never receive a
        # promotion, so those writes change nothing and need no mask.
        prow = self._hash_rows(p_ids)
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

    def _insert_sharded(self, sk_local, oids, scores):
        """All-gather (id, score) lanes; this shard inserts the ids it
        owns; promotions beyond the per-shard budget are reverted
        losslessly; the kept ones compact to [p_cap, 3] lanes of (id,
        global slot, mask). Returns (sketch, lanes, kept count)."""
        mesh, n, s_l = self.mesh, self.n_shards, self._s_l
        p_cap = min(self.mig_lanes, max(s_l - 1, 1))
        # ids and score bits ride one int32 all-gather
        pairs = all_gather(torch.stack(
            [oids.reshape(-1), scores.reshape(-1).view(torch.int32)], 1),
            mesh)
        cand = pairs[:, 0]
        q_ids = torch.where(shard_of(cand, n) == mesh.rank, cand,
                            int(INVALID_ID))
        st, promo = self._sk_insert(self._lcfg, sk_local, q_ids,
                                    pairs[:, 1].contiguous().view(
                                        torch.float32))
        rank = torch.cumsum(promo.mask.to(torch.int32), 0,
                            dtype=torch.int32) - 1
        excess = promo.mask & (rank >= p_cap)
        st = self._sk_revert(self._lcfg, st, q_ids, promo, excess)
        keep = promo.mask & ~excess
        pos = torch.where(keep, rank.clamp(0, p_cap - 1), p_cap).long()
        lanes = torch.zeros((p_cap + 1, 3), dtype=torch.int32,
                            device=self.device)
        lanes[:, 0] = int(INVALID_ID)
        lanes[pos] = torch.stack([promo.ids, promo.slots + mesh.rank * s_l,
                                  keep.to(torch.int32)], 1)
        return st, lanes[:p_cap], keep.sum(dtype=torch.int32)

    def _apply_sharded(self, state: Dict, g_raw: torch.Tensor, aux,
                       lr: float):
        """Sharded backward: shard-local insert, a bounded migration
        exchange (cold-row owners contribute, a psum, hot-row owners
        write), then the row-update exchange. The importance scores are
        global-batch quantities, as in the JAX package (which scores
        outside its shard_map): per-field norm sums are all-reduced and
        the batch size is the global one."""
        oids, row, is_hot = aux
        mesh, n = self.mesh, self.n_shards
        b, f, _ = g_raw.shape
        interval = self.insert_interval
        if self.use_freq:
            scores = torch.full((b, f), float(interval), dtype=torch.float32,
                                device=g_raw.device)
        else:
            norms = torch.sqrt((g_raw * g_raw).sum(dim=-1) + 1e-30)
            scores = norms * (b * n * interval) / (
                psum(norms.sum(dim=0, keepdim=True), mesh) + 1e-30)
        sk = shard_local_view(state["sketch"])
        table = state["table"]
        slots = self._slots_of(state, "table")
        # the tick is replicated: every rank takes the same branch
        if interval == 1 or int(state["tick"]) % interval == 0:
            sk, lanes, n_keep = self._insert_sharded(sk, oids, scores)
            glanes = all_gather(lanes, mesh)
            gp_mask = glanes[:, 2] > 0
            src = torch.where(gp_mask, self._hash_rows(glanes[:, 0]),
                              DROP_ROW)
            mig = psum(_owner_rows(table, src, mesh), mesh)
            dst = _local_idx(table.shape[0],
                             torch.where(gp_mask, glanes[:, 1], DROP_ROW),
                             mesh).long()
            # lanes this rank does not write rewrite the spare row with
            # its own value (promoted slots are distinct and never the
            # spare row), so the write needs no host-side mask
            live = dst < table.shape[0]
            dst = torch.where(live, dst, self._spare_row)
            table[dst] = torch.where(live[:, None], mig, table[dst])
            # promoted slots restart their optimizer state
            for slot_t in slots.values():
                if slot_t.dim() == 2:
                    slot_t[dst] = torch.where(live[:, None], 0.0,
                                              slot_t[dst])
        else:
            n_keep = torch.zeros((), dtype=torch.int32, device=table.device)
        counts = psum(torch.stack([n_keep, is_hot.sum(dtype=torch.int32)]),
                      mesh)
        table, slots = self._sharded_apply(table, slots, row, g_raw, lr)
        out = self._put_slots(
            {**state, "table": table, "sketch": shard_global_view(sk),
             "tick": state["tick"] + 1}, "table", slots)
        stats = {"cafe_promotions": counts[0],
                 "cafe_hot_frac": counts[1].float() / (n * b * f)}
        return out, stats
