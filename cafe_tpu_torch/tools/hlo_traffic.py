"""The collective byte model of a sharded step (the port's counterpart of
cafe_tpu/tools/hlo_traffic.py, whose name it keeps so that a reader
looking for that module finds this one).

Nothing here parses HLO: torch compiles no program to read. The port's
record of a step's collectives is `parallel/exchange.record_collectives`,
which notes (op, axis, result bytes) of every call; `collective_stats`
sums one step's records, which come from an eager step
(tools/wire_audit.audit builds it with capture=False: the record is
made on the host at each call, and a replayed CUDA graph makes no
call). `model_result_bytes` is the JAX module's
analytic prediction of the same result bytes, class by class, so a test
can hold the recorded total to the model across mesh sizes
(tests/test_torch_traffic_model.py), as the JAX package holds its
compiled total (tests/test_sharding.py TestTrafficPrediction).
"""

from __future__ import annotations

from typing import Dict, Iterable


def collective_stats(records: Iterable) -> Dict:
    """Sums of one step's (op, axis, bytes) records: the total result
    bytes and the bytes by axis."""
    by_axis: Dict[str, int] = {}
    for _, axis, nb in records:
        by_axis[axis] = by_axis.get(axis, 0) + nb
    return {"total": sum(by_axis.values()), "by_axis": by_axis}


def model_result_bytes(m_lanes: int, dim: int, n: int, param_bytes: int,
                       method: str = "hash", mig_cap: int = 0,
                       hotn: int = 0) -> dict:
    """Analytic per-class prediction of the sharded step's collective
    RESULT bytes (the quantity collective_stats measures), at
    shard_unique_frac = 0 on a flat n-device mesh — the byte model of
    docs/PERF.md expressed in HLO-result terms so tool and tests can
    compare prediction to compiled reality per mesh size.

    Classes (exchange.py full path):
      ids_fwd    all_gather of the flattened int32 row ids   -> M*4
      rows_fwd   psum_scatter of owner-computed rows         -> M/n*D*4
      ids_bwd    all_gather of update row ids                -> M*4
      grads_bwd  all_gather of update grads                  -> M*D*4
      towers     DP dense-grad all-reduce                    -> P*4
      route      (cafe) owner-answer row-map psum + score AG -> 2*M*4
      migration  (cafe) bounded promo exchange: 3 int legs of
                 n*cap lanes + one n*cap x D row psum
    Wire bytes per device are the PERF.md statement: multiply AG/scatter
    entries by (n-1)/n and psums by 2(n-1)/n.
    """
    out = {
        "ids_fwd": m_lanes * 4,
        "rows_fwd": (m_lanes + n - 1) // n * dim * 4,
        "ids_bwd": m_lanes * 4,
        "grads_bwd": m_lanes * dim * 4,
        "towers": param_bytes,
    }
    if method == "cafe":
        out["route"] = 2 * m_lanes * 4
        # per-shard migration lanes: min(mig_lanes, s_l - 1) where s_l is
        # the shard-local bucket count (cafe.py _apply_sharded p_cap) —
        # at large n the shard slice, not the config cap, binds
        cap = mig_cap or 256
        if hotn:
            cap = min(cap, max(hotn // n - 1, 1))
        out["migration"] = n * cap * (3 * 4 + dim * 4)
    total = sum(out.values())
    out["total"] = total
    return out
