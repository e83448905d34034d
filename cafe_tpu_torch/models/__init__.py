from .dcn import DCN
from .dlrm import DLRM
from .mlp import apply_mlp, init_mlp
from .wdl import WDL

MODELS = {"dlrm": DLRM, "wdl": WDL, "dcn": DCN}

__all__ = ["init_mlp", "apply_mlp", "DLRM", "WDL", "DCN", "MODELS"]
