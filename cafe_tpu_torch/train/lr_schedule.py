"""LR policy: linear warmup + quadratic decay + freeze (port of
cafe_tpu/train/lr_schedule.py).

Reference: LRPolicyScheduler (dlrm_s_pytorch.py:171-208) — scale ramps
linearly over num_warmup_steps, holds, decays as
((remaining)/num_decay_steps)^2 down to 1e-7 between decay_start and
decay_start+num_decay_steps, then freezes at the last value. A function
of the step tensor: the result is an f32 tensor on the step's device,
computed there, so the train step never reads the step back to the host.
"""

from __future__ import annotations

import torch

MIN_LR = 1e-7


def lr_policy(base_lr: float, step: torch.Tensor, num_warmup_steps: int,
              decay_start_step: int, num_decay_steps: int) -> torch.Tensor:
    """torch's _LRScheduler calls step() in __init__, so the reference's
    optimizer step t sees _step_count = t+1: the FIRST step trains at
    base/warm (never 0), and because the between-warmup-and-decay branch
    freezes at `last_lr`, the plateau holds the last warmup value
    base*(warm-1)/warm, not base (dlrm_s_pytorch.py:184-207)."""
    if num_warmup_steps > 0 and decay_start_step < num_warmup_steps:
        raise ValueError(
            "Learning rate warmup must finish before the decay starts")
    s1 = step.to(torch.float32) + 1.0  # torch's _step_count
    lr = torch.full_like(s1, base_lr)
    if num_warmup_steps > 0:
        if num_decay_steps > 0:
            # frozen at the last computed warmup value until decay starts
            lr = torch.full_like(
                s1, base_lr * (num_warmup_steps - 1) / num_warmup_steps)
        warm = base_lr * s1 / num_warmup_steps
        lr = torch.where(s1 < num_warmup_steps, warm, lr)
    if num_decay_steps > 0:
        decayed = s1 - decay_start_step
        scale = ((num_decay_steps - decayed) / num_decay_steps) ** 2
        dec = torch.clamp(base_lr * scale, min=MIN_LR)
        end = decay_start_step + num_decay_steps
        frozen = torch.full_like(
            s1, max(MIN_LR, base_lr * (1.0 / num_decay_steps) ** 2))
        lr = torch.where(s1 >= decay_start_step,
                         torch.where(s1 < end, dec, frozen), lr)
    return lr
