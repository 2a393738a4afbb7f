"""Z-normalization — the paper's precondition (4): zero sample mean, unit
sample variance per series."""

from __future__ import annotations

import torch
import torch.nn.functional as F


def _halving_sum(x):
    """Sum over the last axis in one fixed order, (..., m) -> (..., 1):
    zero-pad m to a power of two, then add the upper half onto the lower
    half until one column is left.  Every step is an elementwise f32 add,
    correctly rounded on the CPU and on CUDA alike, so a row's sum has
    the same bits on either device and in any batch (a library reduction
    may pick its order by shape and device)."""
    m = x.shape[-1]
    p = 1 << max(m - 1, 0).bit_length()
    if p != m:
        x = F.pad(x, (0, p - m))
    while x.shape[-1] > 1:
        h = x.shape[-1] // 2
        x = x[..., :h] + x[..., h:]
    return x


def znormalize(x, axis: int = -1, eps: float = 1e-12):
    """Normalize each series to mean 0 / variance 1 along ``axis``
    (population variance, as the reference), with sums in the fixed
    order of :func:`_halving_sum`: the result has the same bits on the
    CPU and on a card, whatever batch a series sits in.  The divisor is
    a tensor, never a Python scalar, which CUDA would turn into a
    multiplication by its reciprocal."""
    x = x.movedim(axis, -1)
    s = _halving_sum(x)
    n = torch.full_like(s, x.shape[-1])
    mu = s / n
    d = x - mu
    var = _halving_sum(d * d) / n
    # the card's f32 sqrt is not the CPU's on every input (torch 2.11 on
    # an H100; chip_smoke.py counts them); the f64 sqrt is correctly
    # rounded on both, and rounding it to f32 gives the same f32 root
    sd = torch.sqrt(var.to(torch.float64)).to(var.dtype)
    return (d / torch.clamp_min(sd, eps)).movedim(-1, axis)
