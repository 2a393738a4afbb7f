"""Breakpoint construction.

SAX assumes N(0,1) segment means; sSAX/tSAX instead use component-aware
scales (Eqs. 17/18/31) — Gaussian quantiles of N(0, sd) — and a *uniform*
alphabet over [-phi_max, phi_max] for the tSAX trend angle (Eq. 29).
A-1 interior breakpoints split R into A equiprobable intervals; symbol s
occupies [b_{s-1}, b_s) (0-based: bp[s-1] .. bp[s]).

Breakpoints are f32 and computed on the CPU, so every device discretizes
against the same values; callers move them to their data's device.
"""

from __future__ import annotations

import torch


def gaussian_breakpoints(alphabet: int, sd: float = 1.0):
    """A-1 interior breakpoints of N(0, sd) with equal mass 1/A."""
    if alphabet < 2:
        raise ValueError(f"alphabet must be >= 2, got {alphabet}")
    qs = torch.arange(1, alphabet, dtype=torch.float32) / alphabet
    return sd * torch.special.ndtri(qs)


def uniform_breakpoints(alphabet: int, lo: float, hi: float):
    """A-1 interior breakpoints splitting [lo, hi] uniformly."""
    if alphabet < 2:
        raise ValueError(f"alphabet must be >= 2, got {alphabet}")
    i = torch.arange(1, alphabet, dtype=torch.float32)
    return lo + (hi - lo) * i / alphabet


def discretize(values, breakpoints):
    """Map real values to 0-based int32 symbols via the breakpoint grid
    (``right=True`` is the reference's ``side="right"``)."""
    bp = breakpoints.to(values.device)
    return torch.searchsorted(bp, values.contiguous(), right=True,
                              out_int32=True)


def lower_bounds(breakpoints):
    """Per-symbol lower interval edge; symbol 0 -> -inf."""
    inf = torch.full((1,), -torch.inf, dtype=breakpoints.dtype,
                     device=breakpoints.device)
    return torch.cat([inf, breakpoints])


def upper_bounds(breakpoints):
    """Per-symbol upper interval edge; last symbol -> +inf."""
    inf = torch.full((1,), torch.inf, dtype=breakpoints.dtype,
                     device=breakpoints.device)
    return torch.cat([breakpoints, inf])
