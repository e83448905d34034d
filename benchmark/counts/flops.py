"""Analytic matmul FLOPs of the DLRM towers (a frozen copy of
bench_torch.step_flops_per_example's arithmetic).

Forward: 2 FLOPs a multiply-accumulate over the bottom and top MLPs and
the dot interaction's batched product; backward twice the forward.
Gathers, scatters and the sketch move memory and are not counted, so
the share of the peak these give is a lower bound of the towers' own.
"""

from __future__ import annotations

from typing import Sequence


def macs_per_example(ln_bot: Sequence[int], ln_top: Sequence[int],
                     num_sparse: int, dim: int) -> int:
    """Multiply-accumulates of one example's forward."""
    macs = sum(a * b for a, b in zip(ln_bot, ln_bot[1:]))
    macs += sum(a * b for a, b in zip(ln_top, ln_top[1:]))
    num_fea = num_sparse + 1
    return macs + num_fea * num_fea * dim


def train_flops_per_example(ln_bot, ln_top, num_sparse: int,
                            dim: int) -> float:
    """Forward and backward FLOPs of one training example."""
    return 3.0 * 2.0 * macs_per_example(ln_bot, ln_top, num_sparse, dim)

