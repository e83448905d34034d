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
row-update exchange. On a two-level ("dcn", "ici") mesh with
--shard_unique_frac > 0 the id legs are HIERARCHICAL, as the JAX
package's: the host's ids (and summed scores) combine over "ici" into C
distinct lanes (C = unique_cap of the host's lanes) before they cross
"dcn", with the flat leg when any host overflows C (device branches
`route_unique` and `insert_unique`, counted by
parallel/exchange.exchange_branches). The compact leg runs before its
branch; the flat one, and the whole insert at
--cafe_insert_interval > 1, run inside their branches on
parallel/exchange.body_transport.

CAFE+ (`plus=True`) swaps the sketch (sketch/hotsketch_plus.py: a staging
tier, decay, an adaptive threshold) and nothing else: the sketch's init,
query, insert and revert are picked once in __init__, so the gather, the
insert and the sharded paths stay one code path. Its insert reports all
B*F lanes (v1 compacts to PROMO_LANES) before the migration cap.

Serving (quantize_for_serving / gather_quantized) routes as `gather`
does and dequantizes the rows it fetches; on one device the v1 part
freezes a packed view of its sketch at quantize time (`sk_packed`, the
JAX package's) and routes through that view. `enable_sharded_layout(n)`
gives a part without a mesh the n-shard state layout, so the global
state of a run on n ranks (parallel/sharding.unshard_state) serves on one
device; the sketch is then queried through sketch/sharded's one-process
queries, and training in that mode raises.

Spans (utils/spans.py): on one device the apply is the spans
`cafe_insert` (around the insert's branch at an interval > 1),
`cafe_migrate` and `cafe_update`, and counts `promotions` (p_mask.sum())
and `migration_lanes`; the mesh's apply opens none.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np
import torch

from ..ops.sparse import SLOT_SUFFIXES, coalesce_compact, unique_compact
from ..parallel.exchange import (DROP_ROW, _local_idx, _owner_rows,
                                 all_gather, any_rank, body_transport, psum,
                                 psum_scatter, unique_cap)
from ..sketch.hotsketch import (
    INVALID_ID,
    PROMO_LANES,
    HotSketchConfig,
    _pack_cells,
    init_sketch,
    query_cells_packed,
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
                              query_sharded, query_sharded_plus,
                              shard_global_view, shard_local_view, shard_of)
from ..utils.cond import cond, copy_into
from ..utils.spans import count_migration_lanes, count_promotions, span
from .base import Part, _offsets, round_up


class CafePart(Part):
    # enable_sharded_layout: the n-shard state layout without a mesh
    sharded_layout = False
    id_legs = True

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
        # the skipped insert and CAFE+'s decay and reset are device
        # branches
        self.conds = plus or self.insert_interval > 1
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

    def _shard_layout(self, n: int) -> bool:
        """Take the n-shard sketch layout when it fits; False otherwise."""
        if self.total_rows % n:
            return False
        try:
            lcfg, s_l = (local_config_plus if self.plus
                         else local_config)(self.sketch_cfg, n)
        except ValueError:
            return False
        if s_l < 2:
            return False
        self.n_shards = n
        self._lcfg = lcfg
        self._s_l = s_l
        return True

    def enable_sharded_layout(self, n: int) -> bool:
        """Adopt the n-shard STATE layout without a mesh, so that the
        global state of a run on n ranks serves on one device
        (quantize_for_serving, gather_quantized and gather route through
        the sharded sketch by n_shards). n = 1 is the layout of a mesh of
        one rank (the JAX package refuses it; the port serves such a
        state too). Serving and inspection only: apply_grads raises.
        Must be called BEFORE init() or a checkpoint restore."""
        n = int(n)
        if n < 1 or self.mesh is not None or not self._shard_layout(n):
            return False
        self.sharded_layout = True
        return True

    def enable_mesh(self, mesh) -> bool:
        """Opt into the explicit exchange with a shard-local sketch (see
        the module docstring). Must be called BEFORE init()."""
        n = mesh.size
        if not self._shard_layout(n):
            return False
        self.mesh = mesh
        s_l = self._s_l
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
        field's hash rows. Under a mesh or the sharded layout the GLOBAL
        state (the whole padded hot region drawn, since any shard's slot
        may serve, and the sharded sketch layout); under a mesh
        parallel/sharding.shard_state cuts this rank's slices from it."""
        table = np.zeros((self.total_rows, self.dim), dtype=np.float32)
        high_scale = np.sqrt(1.0 / self.max_count)
        sharded = self.mesh is not None or self.sharded_layout
        n_hot_init = self.hash_base if sharded else self.hotn
        table[: n_hot_init] = rng.uniform(
            -high_scale, high_scale,
            size=(n_hot_init, self.dim)).astype(np.float32)
        lo = self.hash_base
        for n, hs in zip(self.counts, self.hash_sizes):
            scale = np.sqrt(1.0 / n)
            table[lo:lo + hs] = rng.uniform(
                -scale, scale, size=(hs, self.dim)).astype(np.float32)
            lo += hs
        if sharded:
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

    def _route(self, state: Dict, ids: torch.Tensor, packed=None):
        """Without a mesh: (oids, row, hrow, is_hot), each [B, F], from
        the sketch (through the one-process sharded query under the
        sharded layout), or from its packed view `packed`."""
        b, f = ids.shape
        oids = self._oids(ids)
        if packed is not None:
            q = query_cells_packed(self.sketch_cfg, packed, oids.reshape(-1))
        elif self.sharded_layout:
            qfn = query_sharded_plus if self.plus else query_sharded
            q = qfn(self.sketch_cfg, self.n_shards, state["sketch"],
                    oids.reshape(-1))
        else:
            q = self._sk_query(self.sketch_cfg, state["sketch"],
                               oids.reshape(-1))
        q = q.reshape(b, f)
        is_hot = q < 0
        row, hrow = self._rows(oids, is_hot, torch.where(is_hot, -q, 0))
        return oids, row, hrow, is_hot

    def gather(self, state: Dict, ids: torch.Tensor):
        if self.mesh is not None:
            return self._gather_sharded(state, ids)
        oids, row, hrow, is_hot = self._route(state, ids)
        raw = self._lookup(state, "table", row)
        return raw, (oids, row, hrow, is_hot)

    def _id_cap(self, m: int) -> int:
        """C of the hierarchical id legs for m lanes a rank: unique_cap of
        the host's lanes on a two-level mesh, else 0 (the flat legs)."""
        mesh = self.mesh
        return unique_cap(m * mesh.inner, self.unique_frac) \
            if mesh.inner else 0

    def _answer(self, state: Dict, cand: torch.Tensor) -> torch.Tensor:
        """This sketch shard's global hot slot for each candidate id it
        owns, 0 for every other lane (int32; a sum over the mesh
        publishes the answers: one owner a lane)."""
        mesh, n, s_l = self.mesh, self.n_shards, self._s_l
        mine = shard_of(cand, n) == mesh.rank
        q = self._sk_query(self._lcfg, shard_local_view(state["sketch"]),
                           torch.where(mine, cand, int(INVALID_ID)))
        return torch.where(mine & (q < 0), -q + mesh.rank * s_l,
                           0).to(torch.int32)

    def _route_flat(self, state: Dict, flat: torch.Tensor,
                    transport: str = "group") -> torch.Tensor:
        """The flat route of this rank's offset ids [m]: all-gather them,
        answer, and reduce-scatter each rank its lanes' hot slots, on
        `transport`."""
        cand = all_gather(flat, self.mesh, transport=transport)
        return psum_scatter(self._answer(state, cand), self.mesh,
                            transport=transport)

    def _route_unique(self, state: Dict, flat: torch.Tensor,
                      cap: int) -> torch.Tensor:
        """The hierarchical route (the JAX package's compact_fn): the
        host's ids all-gathered over "ici" and compacted to their `cap`
        distinct ids, which alone cross "dcn"; every rank answers the
        n_hosts * cap candidates, a sum over the mesh publishes them and
        this rank picks its lanes at host * cap + inv. The flat route
        when any host overflows."""
        mesh = self.mesh
        m = flat.shape[0]
        ici_ids = all_gather(flat, mesh, "ici")              # [m_host]
        uids, inv, nu = unique_compact(ici_ids, cap, int(INVALID_ID))
        cand = all_gather(uids, mesh, "dcn")                 # [hosts*C]
        slot_all = psum(self._answer(state, cand), mesh)
        me = mesh.ici_index
        pos = (mesh.rank // mesh.inner) * cap \
            + inv[me * m:(me + 1) * m].clamp(0, cap - 1)
        rare = body_transport(mesh)

        def compact(flat_, slot_all_, pos_):
            return slot_all_[pos_.long()]

        def full(flat_, slot_all_, pos_):
            return self._route_flat(state, flat_, rare)

        return cond(any_rank(nu > cap, mesh), full, compact,
                    (flat, slot_all, pos), name="route_unique")

    def _route_sharded(self, state: Dict, ids: torch.Tensor):
        """Sharded routing: all-gather the offset ids; each sketch shard
        answers hot-routing for the ids it owns; an int32 reduce-scatter
        hands each rank its lanes' hot rows (id-sized traffic), or on a
        two-level mesh the hierarchical route (_route_unique). Returns
        (oids, row, is_hot), each [b, F]."""
        b, f = ids.shape
        oids = self._oids(ids)
        flat = oids.reshape(-1)
        cap = self._id_cap(b * f)
        slot = (self._route_unique(state, flat, cap) if cap
                else self._route_flat(state, flat)).reshape(b, f)
        is_hot = slot > 0
        return oids, torch.where(is_hot, slot, self._hash_rows(oids)), is_hot

    def _gather_sharded(self, state: Dict, ids: torch.Tensor):
        """Sharded forward: the routing above, then the D-wide rows
        through the configured row exchange."""
        oids, row, is_hot = self._route_sharded(state, ids)
        raw = self._sharded_fetch(state["table"], row)
        return raw, (oids, row, is_hot)

    def quantize_for_serving(self, state: Dict, bits: int) -> Dict:
        """The unified table quantized (this rank's shard under a mesh).
        On one device in the flat layout the v1 part also freezes the
        packed view of its sketch (`sk_packed`, as the JAX package does):
        the served routing is the sketch as it stood here."""
        out = {"table": self._quantize(state["table"], bits)}
        if self.mesh is None and self.n_shards == 1 and not self.plus \
                and not self.sharded_layout:
            sk = state["sketch"]
            out["sk_packed"] = _pack_cells(sk["val"], sk["cnt"], sk["dic"])
        return out

    def gather_quantized(self, state: Dict, qt: Dict, ids: torch.Tensor):
        """The routing of `gather` (through the frozen view where `qt`
        holds one); the row fetch dequantizes. Under a mesh the owners
        dequantize their rows (Part._dequantize)."""
        if self.mesh is not None:
            _, row, _ = self._route_sharded(state, ids)
        else:
            _, row, _, _ = self._route(state, ids, qt.get("sk_packed"))
        return self._dequantize(qt["table"], row)

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
        if self.sharded_layout:
            # the flat insert on the sharded sketch layout would hash into
            # the wrong buckets and corrupt promotions and counters
            raise RuntimeError(
                "CafePart: training in sharded-layout mode requires the "
                "mesh (enable_mesh); enable_sharded_layout supports "
                "serving/inspection only")
        oids, row, hrow, is_hot = aux
        b, f, d = g_raw.shape
        flat_oids = oids.reshape(-1)
        interval = self.insert_interval
        dev = g_raw.device
        # the spans (utils/spans.py) wrap the insert's branch, never sit
        # in its body
        with span("cafe_insert", dev):
            if interval > 1:
                # the insert every interval-th tick, taken on the device
                # (cond: a conditional node in a CUDA graph). The insert
                # writes the new sketch into the state's sketch tensors,
                # so the skip copies nothing; the skip reports the
                # compacted lane count empty (the insert reports B*F
                # lanes under CAFE+, <= PROMO_LANES under v1)
                l0 = flat_oids.shape[0] if self.plus \
                    else min(flat_oids.shape[0], PROMO_LANES)
                cap_l = min(l0, self.hotn, max(self.mig_lanes * 16, 4096))

                def insert(sketch, oids_, g):
                    new, ids_, slots_, mask = self._insert_and_compact(
                        sketch, oids_, g)
                    copy_into(sketch, new)
                    return ids_, slots_, mask

                def skip(sketch, oids_, g):
                    z = torch.zeros(cap_l, dtype=torch.int32,
                                    device=g.device)
                    return z, torch.zeros_like(z), torch.zeros_like(z).bool()

                sk = state["sketch"]
                p_ids, p_slots, p_mask = cond(
                    state["tick"] % interval == 0, insert, skip,
                    (sk, flat_oids, g_raw), name="cafe_insert")
            else:
                sk, p_ids, p_slots, p_mask = self._insert_and_compact(
                    state["sketch"], flat_oids, g_raw)

        if self.plus and self.auto_mesh is not None:
            # the CAFE+ insert sums scores in float atomics on the card:
            # every rank takes rank 0's sketch and promotions (v1's insert
            # is deterministic: sorts, scans and K1's max)
            lanes = torch.stack([p_ids, p_slots, p_mask.to(torch.int32)])
            self._agree(*sk.values(), lanes)
            p_ids, p_slots, p_mask = lanes[0], lanes[1], lanes[2] > 0

        # migration BEFORE the optimizer touches the cold rows (reference
        # insert_grad-then-step order). Lanes without a promotion write
        # their source row onto itself: hash rows never receive a
        # promotion, so those writes change nothing and need no mask.
        with span("cafe_migrate", dev):
            prow = self._hash_rows(p_ids)
            table = state["table"]
            state = {**state, "sketch": sk, "tick": state["tick"] + 1}
            slot_ts = [state["table" + sfx]
                       for sfx in SLOT_SUFFIXES[self.optimizer].values()
                       if state["table" + sfx].dim() == 2]
            if "table" in self.auto_keys:
                # the owners of the promoted slots write them (auto)
                self._write_owned(table, p_slots,
                                  self._read_rows(state, "table", prow),
                                  p_mask)
                for slot_t in slot_ts:
                    self._write_owned(slot_t, p_slots, torch.zeros(
                        p_slots.shape[0], slot_t.shape[1],
                        device=slot_t.device), p_mask)
            else:
                dst = torch.where(p_mask, p_slots, prow).long()
                table[dst] = table[prow.long()]
                # freshly promoted slots restart their optimizer state
                # (the same write-back trick for lanes without a
                # promotion)
                for slot_t in slot_ts:
                    slot_t[dst] = torch.where(p_mask[:, None], 0.0,
                                              slot_t[prow.long()])
            count_migration_lanes(p_ids.shape[0], dev)

        # one scatter updates whichever row served each sample
        with span("cafe_update", dev):
            state = self._table_update(state, "table", row.reshape(-1),
                                       g_raw.reshape(b * f, d), lr)
        stats = {
            "cafe_promotions": p_mask.sum(),
            "cafe_hot_frac": is_hot.float().mean(),
        }
        count_promotions(stats["cafe_promotions"])
        return state, stats

    def _promo_cap(self) -> int:
        """Promotion lanes a shard keeps a sharded insert."""
        return min(self.mig_lanes, max(self._s_l - 1, 1))

    def _insert_leg(self, sk_local, cand, cand_sc):
        """This shard inserts the candidate (id, score) lanes it owns;
        promotions beyond the per-shard budget are reverted losslessly;
        the kept ones compact to [p_cap, 3] lanes of (id, global slot,
        mask). Returns (sketch, lanes, kept count)."""
        mesh, n, s_l = self.mesh, self.n_shards, self._s_l
        p_cap = self._promo_cap()
        q_ids = torch.where(shard_of(cand, n) == mesh.rank, cand,
                            int(INVALID_ID))
        st, promo = self._sk_insert(self._lcfg, sk_local, q_ids, cand_sc)
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

    def _insert_flat(self, sk_local, pairs, transport: str = "group"):
        """The flat insert: all-gather this rank's (id, score bits) pairs
        [m, 2] int32 over the mesh, on `transport`, and insert them."""
        cand = all_gather(pairs, self.mesh, transport=transport)
        return self._insert_leg(sk_local, cand[:, 0].contiguous(),
                                cand[:, 1].contiguous().view(torch.float32))

    def _insert_sharded(self, sk_local, oids, scores, transport="group"):
        """All-gather (id, score) lanes and insert the ids this shard owns
        (_insert_leg), the flat collectives on `transport`; on a
        two-level mesh the hierarchical insert (_insert_unique). Returns
        (sketch, lanes, kept count)."""
        # ids and score bits ride one int32 all-gather
        pairs = torch.stack([oids.reshape(-1),
                             scores.reshape(-1).view(torch.int32)], 1)
        cap = self._id_cap(pairs.shape[0])
        if cap:
            return self._insert_unique(sk_local, pairs, cap)
        return self._insert_flat(sk_local, pairs, transport)

    def _insert_unique(self, sk_local, pairs, cap: int):
        """The hierarchical insert (the JAX package's compact_leg): the
        host's (id, score) pairs all-gathered over "ici" and coalesced to
        `cap` (id, score-sum) lanes (the sums the insert would
        segment-sum anyway), which alone cross "dcn"; the flat insert
        when any host overflows. Both write the new sketch into
        `sk_local`. Returns (sketch, lanes, kept count)."""
        mesh = self.mesh
        host = all_gather(pairs, mesh, "ici")                # [m_host, 2]
        uids, usc, nu = coalesce_compact(
            host[:, 0].contiguous(),
            host[:, 1:].contiguous().view(torch.float32), cap,
            int(INVALID_ID))
        cand = all_gather(torch.cat([uids[:, None], usc.view(torch.int32)],
                                    1), mesh, "dcn")         # [hosts*C, 2]
        rare = body_transport(mesh)

        def insert(sk_, got):
            new, lanes_, n_keep_ = got
            copy_into(sk_, new)
            return lanes_, n_keep_

        def compact(sk_, pairs_, cand_):
            return insert(sk_, self._insert_leg(
                sk_, cand_[:, 0].contiguous(),
                cand_[:, 1].contiguous().view(torch.float32)))

        def full(sk_, pairs_, cand_):
            return insert(sk_, self._insert_flat(sk_, pairs_, rare))

        lanes, n_keep = cond(any_rank(nu > cap, mesh), full, compact,
                             (sk_local, pairs, cand), name="insert_unique")
        return sk_local, lanes, n_keep

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
        if interval > 1:
            # the insert every interval-th tick, a device branch on the
            # replicated tick (every rank takes the same one, so the
            # candidate all-gather inside it pairs up; it runs on
            # body_transport); the insert writes the new sketch into the
            # state's, the skip returns empty promotion lanes, and the
            # migration below runs on every step
            p_cap = self._promo_cap()
            rare = body_transport(mesh)

            def insert(sk_, oids_, scores_):
                new, lanes_, n_keep_ = self._insert_sharded(
                    sk_, oids_, scores_, rare)
                copy_into(sk_, new)
                return lanes_, n_keep_

            def skip(sk_, oids_, scores_):
                lanes_ = torch.zeros((p_cap, 3), dtype=torch.int32,
                                     device=scores_.device)
                lanes_[:, 0] = int(INVALID_ID)
                return lanes_, torch.zeros((), dtype=torch.int32,
                                           device=scores_.device)

            lanes, n_keep = cond(state["tick"] % interval == 0, insert,
                                 skip, (sk, oids, scores),
                                 name="cafe_insert")
        else:
            sk, lanes, n_keep = self._insert_sharded(sk, oids, scores)
        glanes = all_gather(lanes, mesh)
        gp_mask = glanes[:, 2] > 0
        src = torch.where(gp_mask, self._hash_rows(glanes[:, 0]), DROP_ROW)
        mig = psum(_owner_rows(table, src, mesh), mesh)
        dst = _local_idx(table.shape[0],
                         torch.where(gp_mask, glanes[:, 1], DROP_ROW),
                         mesh).long()
        # lanes this rank does not write rewrite the spare row with its
        # own value (promoted slots are distinct and never the spare
        # row), so the write needs no host-side mask
        live = dst < table.shape[0]
        dst = torch.where(live, dst, self._spare_row)
        table[dst] = torch.where(live[:, None], mig, table[dst])
        # promoted slots restart their optimizer state
        for slot_t in slots.values():
            if slot_t.dim() == 2:
                slot_t[dst] = torch.where(live[:, None], 0.0, slot_t[dst])
        counts = psum(torch.stack([n_keep, is_hot.sum(dtype=torch.int32)]),
                      mesh)
        table, slots = self._sharded_apply(table, slots, row, g_raw, lr)
        out = self._put_slots(
            {**state, "table": table, "sketch": shard_global_view(sk),
             "tick": state["tick"] + 1}, "table", slots)
        stats = {"cafe_promotions": counts[0],
                 "cafe_hot_frac": counts[1].float() / (n * b * f)}
        return out, stats
