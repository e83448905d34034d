"""The graph recommenders (port of cafe_tpu/models/graphrec/): LightGCN
and PinSAGE over a CAFE or full node-id table."""

from .lightgcn import LightGCN, LightGCNConfig, build_bipartite_graph
from .pinsage import PinSAGE, PinSAGEConfig, RandomWalkSampler
from .sampling import sample_negative

__all__ = ["LightGCN", "LightGCNConfig", "build_bipartite_graph",
           "PinSAGE", "PinSAGEConfig", "RandomWalkSampler",
           "sample_negative"]
