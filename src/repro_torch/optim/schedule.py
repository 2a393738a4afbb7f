"""LR schedules as functions of the step counter (an int or a 0-d
tensor, whose device the result keeps), computed in f32."""

from __future__ import annotations

import math

import torch

F32 = torch.float32


def cosine_schedule(step, *, warmup: int, total: int, floor: float = 0.1):
    """Linear warmup then cosine decay to ``floor`` of peak; returns scale."""
    step = torch.as_tensor(step).to(F32)
    warm = torch.clamp_max(step / max(warmup, 1), 1.0)
    frac = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = floor + (1 - floor) * 0.5 * (1 + torch.cos(math.pi * frac))
    return warm * cos
