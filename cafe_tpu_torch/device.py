"""Device resolution for the port's entry points.

Entry points default to the card. Nothing drops silently to the CPU: a
caller who wants the CPU (the tests) says device="cpu".
"""

from __future__ import annotations

import torch


def resolve_device(device="cuda") -> torch.device:
    """torch.device for `device`; raises if it names CUDA and CUDA is
    absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "cafe_tpu_torch: CUDA was requested but torch.cuda.is_available() "
            "is False; pass device='cpu' to run the plain PyTorch versions")
    return dev
