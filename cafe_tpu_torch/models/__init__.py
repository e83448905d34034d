from .dlrm import DLRM
from .mlp import apply_mlp, init_mlp

# wdl and dcn are not ported yet
MODELS = {"dlrm": DLRM}

__all__ = ["init_mlp", "apply_mlp", "DLRM", "MODELS"]
