"""LR schedules: pure functions of the step counter. Mirrors
``repro/optim/schedule.py``."""
from __future__ import annotations

import math

import torch


def cosine_schedule(step, *, base_lr, warmup_steps, total_steps, min_ratio=0.1):
    """Linear warm-up to ``base_lr`` over ``warmup_steps``, then a cosine
    decay to ``min_ratio * base_lr`` at ``total_steps``. ``step`` is a
    tensor (the optimizer's ``count``) or a number; the lr is an fp32
    tensor on ``step``'s device, so a captured step reads it from the state
    and never from the host."""
    if isinstance(step, torch.Tensor):
        step = step.to(torch.float32)
    else:
        step = torch.tensor(float(step), dtype=torch.float32)
    warm = base_lr * torch.clamp((step + 1) / max(warmup_steps, 1), max=1.0)
    frac = torch.clamp((step - warmup_steps) / max(total_steps - warmup_steps, 1),
                       0.0, 1.0)
    cos = min_ratio + (1 - min_ratio) * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(step < warmup_steps, warm, base_lr * cos)
