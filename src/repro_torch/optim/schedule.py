"""LR schedules."""

from __future__ import annotations

import math

import torch


def warmup_cosine(peak_lr: float, warmup: int, total: int, floor: float = 0.1):
    """Linear warm-up to ``peak_lr`` over ``warmup`` steps, then a cosine
    down to ``floor · peak_lr`` at ``total``; a float32 tensor of the step."""
    def fn(step):
        step = torch.as_tensor(step).float()
        warm = peak_lr * step / max(warmup, 1)
        frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
        cos = peak_lr * (floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac)))
        return torch.where(step < warmup, warm, cos)

    return fn
