"""LR schedules, mirroring ``repro.optim.schedule`` formula for formula."""

from __future__ import annotations

import math

import torch


def cosine_warmup(step, *, peak_lr: float, warmup: int, total: int,
                  floor_frac: float = 0.1):
    """Linear warmup to ``peak_lr`` over ``warmup`` steps (step s gives
    peak * (s + 1) / warmup), then a cosine down to ``floor_frac`` of the
    peak at ``total``.  ``step``: an int or a 0-d tensor; returns a 0-d f32
    tensor on its device."""
    s = (step.float() if torch.is_tensor(step)
         else torch.tensor(float(step), dtype=torch.float32))
    warm = peak_lr * torch.clamp((s + 1) / max(warmup, 1), max=1.0)
    prog = torch.clamp((s - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor_frac + (1 - floor_frac) * 0.5 * (1 + torch.cos(math.pi * prog))
    return torch.where(s < warmup, warm, peak_lr * cos)
