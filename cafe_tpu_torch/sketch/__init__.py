from .hotsketch import (
    INVALID_ID,
    PROMO_LANES,
    HotSketchConfig,
    InsertResult,
    analyse,
    analyse_tracked,
    hot_fraction,
    init_sketch,
    rebuild_free_list,
    revert_promotions,
    sketch_insert,
    sketch_query,
)
from .hotsketch_plus import (
    CafePlusConfig,
    analyse_plus,
    init_sketch_plus,
    revert_promotions_plus,
    sketch_insert_plus,
    sketch_query_plus,
)
from .oracle import OracleSketch

__all__ = ["INVALID_ID", "PROMO_LANES", "HotSketchConfig", "InsertResult",
           "analyse", "analyse_tracked", "hot_fraction", "init_sketch",
           "rebuild_free_list", "revert_promotions", "sketch_insert",
           "sketch_query", "CafePlusConfig", "analyse_plus",
           "init_sketch_plus", "revert_promotions_plus",
           "sketch_insert_plus", "sketch_query_plus", "OracleSketch"]
