"""Z-normalization — the paper's precondition (4): zero sample mean, unit
sample variance per series."""

from __future__ import annotations

import torch


def znormalize(x, axis: int = -1, eps: float = 1e-12):
    """Normalize each series to mean 0 / variance 1 along ``axis``
    (population variance, as the reference)."""
    mu = x.mean(dim=axis, keepdim=True)
    sd = x.std(dim=axis, keepdim=True, correction=0)
    return (x - mu) / torch.clamp_min(sd, eps)
