"""Step-size and learning-rate schedules (`repro/optim/schedule.py`).

Plain functions of the step: a Python number gives a Python float, so a
sampler whose step is a host-side int computes its step size with no device
work and no sync; a tensor gives a float32 tensor, as the reference's
jnp arrays do.
"""
from __future__ import annotations

import math

import torch

__all__ = ["cosine_schedule", "sgld_step_schedule"]


def sgld_step_schedule(step, *, peak: float, decay: float = 0.33, t0: float = 200.0,
                       floor: float = 0.0):
    """Polynomial SGLD step-size decay: eps_t = peak * (t0 / (t0 + t))^decay.

    The Welling & Teh (2011) a(b + t)^-gamma family, written so that `peak`
    is eps_0. `decay` < 1 keeps the sum of the steps divergent (the chain
    keeps exploring) while the discretisation bias shrinks; `floor` pins a
    last step size for an unbounded run, where a fully decayed chain would
    stop mixing.
    """
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
        return torch.clamp(peak * (t0 / (t0 + step)) ** decay, min=floor)
    return max(peak * (t0 / (t0 + float(step))) ** decay, floor)


def cosine_schedule(step, *, peak_lr: float, warmup_steps: int, total_steps: int,
                    min_ratio: float = 0.1):
    """Linear warm-up to `peak_lr` over `warmup_steps`, then a cosine decay
    to `min_ratio * peak_lr` at `total_steps`."""
    span = max(total_steps - warmup_steps, 1)
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
        warm = peak_lr * step / max(warmup_steps, 1)
        frac = torch.clamp((step - warmup_steps) / span, 0.0, 1.0)
        cos = peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup_steps, warm, cos)
    step = float(step)
    if step < warmup_steps:
        return peak_lr * step / max(warmup_steps, 1)
    frac = min(max((step - warmup_steps) / span, 0.0), 1.0)
    return peak_lr * (min_ratio + (1 - min_ratio) * 0.5 * (1 + math.cos(math.pi * frac)))
