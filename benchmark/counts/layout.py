"""The table layout a configuration implies, worked out from the
configuration alone (frozen copies of the sizing rules of CAFE's
reference, init_embed.py, as the port applies them).

Fields of at most 2000 * cr ids keep a full table; the rest share one
CAFE table: `hotn` exclusive hot rows first (one per sketch bucket), the
per-field hash rows from `hash_base` on. Every table is padded to a
multiple of 512 rows. The harness makes the initial weights in this
layout and checks the port's tables against it; the plain reference
trains in it.
"""

from __future__ import annotations

import math
from typing import Dict, List

ROW_ALIGN = 512
# lanes of the sketch's compacted promotion report
PROMO_LANES = 4096
# the sketch's cells a bucket
CELLS = 4
# the port's migration-lane default (cafe_mig_lanes)
MIG_LANES = 256


def round_up(n: int, align: int = ROW_ALIGN) -> int:
    return ((max(n, 1) + align - 1) // align) * align


def _offsets(sizes: List[int]) -> List[int]:
    out, acc = [], 0
    for s in sizes:
        out.append(acc)
        acc += s
    return out


def layout(conf: Dict) -> Dict:
    """{counts, dim, small, big, full: {...} or None, cafe: {...}} of a
    configuration file's dict."""
    c = conf["config"]
    if c.get("compress_method") != "cafe" or c.get("cafe_plus"):
        raise ValueError("layout: CAFE v1 configurations only")
    if c.get("optimizer", "sgd") != "sgd":
        raise ValueError("layout: SGD configurations only")
    counts = [int(n) for n in conf["counts"]]
    mir = int(c.get("max_ind_range", -1))
    if mir > 0:
        counts = [min(n, mir) for n in counts]
    dim = int(c["embedding_dim"])
    cr = float(c["compress_rate"])
    hr = float(c.get("cafe_hash_rate", 0.5))
    th = 2000.0 * cr
    small = [i for i, n in enumerate(counts) if n <= th]
    big = [i for i, n in enumerate(counts) if n > th]
    full = None
    if small:
        real = [counts[i] for i in small]
        full = {"fields": small, "real_ns": real, "offsets": _offsets(real),
                "rows": round_up(sum(real)),
                "scales": [math.sqrt(1.0 / max(n, 5)) for n in real]}
    totn = int(sum(counts))
    hotn = int(totn * cr * (1 - hr) * (dim * 4 / (dim * 4 + 48)))
    if hotn <= 1 or not big:
        raise ValueError("layout: no hot pool at this compress rate")
    goff_all = _offsets(counts)
    hash_sizes = [int(math.ceil(cr * hr * counts[i])) for i in big]
    hash_rows = sum(hash_sizes)
    hash_base = round_up(hotn)
    goff = [goff_all[i] for i in big]
    max_id = max(o + counts[i] for o, i in zip(goff, big))
    lanes_per_row = len(big)
    cafe = {
        "fields": big, "counts": [counts[i] for i in big], "goff": goff,
        "hotn": hotn, "hash_sizes": hash_sizes,
        "hash_off": _offsets(hash_sizes), "hash_rows": hash_rows,
        "hash_base": hash_base, "rows": hash_base + round_up(hash_rows),
        "max_count": max(counts), "max_id": max_id,
        "threshold": float(c.get("cafe_sketch_threshold", 500.0)),
        "decay": float(c.get("cafe_decay", 0.99)),
        # K1 lands (cell, id) packed in one channel below 2^27 ids
        "land_channels": CELLS + 1 if max_id <= (1 << 27) else 2 * CELLS,
        "lanes_per_row": lanes_per_row,
    }
    return {"counts": counts, "dim": dim, "small": small, "big": big,
            "full": full, "cafe": cafe,
            "num_dense": int(conf.get("num_dense", 13)),
            "ln_bot": [int(x) for x in conf["ln_bot"]],
            "ln_top": [int(x) for x in conf["ln_top"]],
            "lr": float(c["learning_rate"]),
            "bf16": bool(c.get("bf16", False))}


def promo_cap(lay: Dict, batch: int) -> int:
    """Promotions a step keeps (the port's lossless cap: the rest are
    reverted and retry on their next touch)."""
    lanes = min(batch * lay["cafe"]["lanes_per_row"], PROMO_LANES)
    return min(lanes, lay["cafe"]["hotn"], max(MIG_LANES * 16, 4096))
