from .hotsketch import (
    INVALID_ID,
    PROMO_LANES,
    HotSketchConfig,
    InsertResult,
    init_sketch,
    revert_promotions,
    sketch_insert,
    sketch_query,
)

__all__ = ["INVALID_ID", "PROMO_LANES", "HotSketchConfig", "InsertResult",
           "init_sketch", "revert_promotions", "sketch_insert",
           "sketch_query"]
