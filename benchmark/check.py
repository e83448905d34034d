"""The numbers that decide `correct`, each held against its limit.

Training (the first three calls of the window's own step, on the first
three batches of the window's own feed, against the plain reference run
from the same weights and warm sketch on the same batches):
- loss_gap: |loss - reference loss| / |reference loss| of the first
  call (a call of K steps reports its steps' mean loss); the later
  calls' gap (later_loss_gap) is printed and not compared: a promotion
  that rounding flips moves those losses up to 1.5e-5, as far as the
  lower-precision control's least reading;
- grad_gap: by the worst leaf, the gap between the norms of the leaf's
  change after the first call (the first gradient as SGD applied it,
  times the learning rate) in the program and in the reference, over the
  larger of the reference leaf's norm and the median leaf's; the leaves
  whose rows a promotion copies (the reference's MIGRATED: the CAFE
  table) are left out of it, since their first change is led by those
  copies and a promotion that rounding flips moves it by about 1 %;
- change_gap: the same after the third call, over every leaf.
Leaves whose reference change after the first call is under a
thousandth of the median leaf's are left out of both leaf numbers. The
leaves are the towers' weights and biases, each table, and the sketch's
counts (their change from the warm ones); the CAFE table's change is led
by the promotions' migrations, so it and the counts carry the sketch's
insert, its evictions and the decay (which falls in the third call)
into the check. promo_gap (the gap between the promotions the program
and the reference made over the three calls, over the reference's) is
printed and not compared: a promotion that rounding flips moves it as
far as a fault."""

from __future__ import annotations

import math
from typing import Dict, Iterable, List

import numpy as np

SMALL_LEAF = 1e-3


def _leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
              keep: List[str]) -> float:
    med = float(np.median([ref[k] for k in keep]))
    return max(abs(prog[k] - ref[k]) / max(ref[k], med) for k in keep)


def _kept(ref: Dict) -> List[str]:
    med1 = float(np.median(list(ref["d1"].values())))
    return [k for k, v in ref["d1"].items() if v >= SMALL_LEAF * med1]


def train_numbers(prog: Dict, ref: Dict,
                  migrated: Iterable[str] = ()) -> Dict[str, float]:
    """prog / ref: {loss: [3 floats], promotions: int, d1: {leaf: norm},
    d3: {leaf: norm}}; `migrated`: the leaves grad_gap leaves out."""
    keep = _kept(ref)
    first = [k for k in keep if k not in set(migrated)]
    return {
        "loss_gap": abs(prog["loss"][0] - ref["loss"][0])
        / abs(ref["loss"][0]),
        "grad_gap": _leaf_gap(prog["d1"], ref["d1"], first),
        "change_gap": _leaf_gap(prog["d3"], ref["d3"], keep),
    }


def later_loss_gap(prog: Dict, ref: Dict) -> float:
    """The largest loss gap of the calls after the first (printed)."""
    return max((abs(p - r) / abs(r)
                for p, r in zip(prog["loss"][1:], ref["loss"][1:])),
               default=0.0)


def promo_gap(prog: Dict, ref: Dict) -> float:
    return abs(prog["promotions"] - ref["promotions"]) \
        / max(ref["promotions"], 1)


def left_out(ref: Dict) -> List[str]:
    """The leaves the small-leaf rule leaves out."""
    keep = _kept(ref)
    return [k for k in ref["d1"] if k not in keep]


def judge(numbers: Dict[str, float], limits: Dict[str, float]) -> bool:
    """Every number finite and at most its limit (a number with no limit
    is refused)."""
    return all(k in limits and math.isfinite(v) and v <= limits[k]
               for k, v in numbers.items())


def lines(numbers: Dict[str, float], limits: Dict[str, float]) -> List[str]:
    return [f"check {k} {v!r} limit {limits.get(k)!r}"
            for k, v in numbers.items()]


def worst_leaves(prog: Dict, ref: Dict,
                 migrated: Iterable[str] = ()) -> List[str]:
    """A line for each leaf number: the worst leaf, its two norms, and
    the median leaf's gap; and the first change's gap of each leaf that
    grad_gap leaves out."""
    keep = _kept(ref)
    first = [k for k in keep if k not in set(migrated)]
    out = []
    for key, kept in (("d1", first), ("d3", keep)):
        med = float(np.median([ref[key][k] for k in kept]))
        gaps = {k: abs(prog[key][k] - ref[key][k]) / max(ref[key][k], med)
                for k in kept}
        worst = max(gaps, key=gaps.get)
        med_gap = float(np.median(list(gaps.values())))
        out.append(f"{key}: worst leaf {worst} gap {gaps[worst]!r} (program "
                   f"{prog[key][worst]!r}, reference {ref[key][worst]!r}); "
                   f"median leaf gap {med_gap!r}")
    for k in keep:
        if k not in first:
            gap = abs(prog["d1"][k] - ref["d1"][k]) / ref["d1"][k]
            out.append(f"d1 of {k} (not in grad_gap): gap {gap!r} (program "
                       f"{prog['d1'][k]!r}, reference {ref['d1'][k]!r})")
    return out
