"""sSAX — season-aware symbolic approximation (paper §3.1).

Model: x = seas + res.  The season mask sigma (Eq. 13) is the per-phase
mean over T/L periods; residual segment means are the PAA of x - seas.
Representation: (sigma discretized into A_seas, res-means into A_res),
with breakpoints from N(0, sd(seas)) / N(0, sd(res)) where
sd(res) = sqrt(1 - R^2_seas) (Eqs. 16-18).

Distance (Table 2 + Eq. 20): with c_s(a, a') = lower(a) - upper(a'),

    cell(s, s', r, r') = max(0, c_s(s,s') + c_s(r,r'),
                              c_s(s',s) + c_s(r',r))

(the three-case Eq. 20 collapses to this max).  The paper's 4WL lookups
become L + W gathers plus an (L, W) broadcast-add.

d_sSAX = sqrt(T/(W*L)) * sqrt(sum_{l,w} cell(...)^2), requiring W*L | T.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.breakpoints import (
    discretize, gaussian_breakpoints, lower_bounds, upper_bounds)
from repro_torch.core.paa import paa


def _tile(seas, reps: int):
    """Repeat the last axis ``reps`` times (``jnp.tile`` on that axis)."""
    return seas.repeat(*([1] * (seas.ndim - 1)), reps)


def season_mask(x, L: int):
    """Per-phase mean (Eq. 13).  x: (..., T) -> (..., L)."""
    T = x.shape[-1]
    if T % L:
        raise ValueError(f"L={L} must divide T={T}")
    return x.reshape(*x.shape[:-1], T // L, L).mean(-2)


def remove_season(x, L: int):
    """(residuals, mask): x minus its tiled season mask."""
    seas = season_mask(x, L)
    return x - _tile(seas, x.shape[-1] // L), seas


def season_strength(x, L: int):
    """R^2_seas (Eq. 16) per series: 1 - var(res)/var(x)."""
    res, _ = remove_season(x, L)
    return 1.0 - res.var(-1, correction=0) / torch.clamp_min(
        x.var(-1, correction=0), 1e-12)


def cs_pair(sym_a, sym_b, lo, hi):
    """c_s(a, b) = lower(a) - upper(b), broadcast over symbol arrays."""
    return lo[sym_a.long()] - hi[sym_b.long()]


def cell_sum(sa, sb, wa, wb, b_seas, b_res):
    """sum_{l,w} cell(s, s', r, r')^2 of Eq. 20 over broadcast reps."""
    lo_s, hi_s = lower_bounds(b_seas), upper_bounds(b_seas)
    lo_r, hi_r = lower_bounds(b_res), upper_bounds(b_res)
    case1 = cs_pair(sa, sb, lo_s, hi_s)[..., :, None] + \
        cs_pair(wa, wb, lo_r, hi_r)[..., None, :]
    case2 = cs_pair(sb, sa, lo_s, hi_s)[..., :, None] + \
        cs_pair(wb, wa, lo_r, hi_r)[..., None, :]
    cell = torch.clamp_min(torch.maximum(case1, case2), 0.0)  # (..., L, W)
    return cell.square().sum(dim=(-2, -1))


@dataclass(frozen=True)
class SSAX:
    """Season-aware SAX for fixed (T, W, L, A_seas, A_res, R^2_seas)."""

    T: int
    W: int
    L: int
    A_seas: int
    A_res: int
    r2_season: float = 0.5      # dataset-level mean season strength

    def __post_init__(self):
        if self.T % (self.W * self.L):
            raise ValueError(f"W*L={self.W * self.L} must divide T={self.T}")

    @property
    def sd_res(self) -> float:
        return math.sqrt(max(1.0 - self.r2_season, 1e-9))      # Eq. 17

    @property
    def sd_seas(self) -> float:
        return math.sqrt(max(1.0 - self.sd_res ** 2, 1e-9))    # Eq. 18

    @property
    def b_seas(self):
        return gaussian_breakpoints(self.A_seas, self.sd_seas)

    @property
    def b_res(self):
        return gaussian_breakpoints(self.A_res, self.sd_res)

    @property
    def bits(self) -> float:
        return self.L * math.log2(self.A_seas) + self.W * math.log2(self.A_res)

    # -- representation -------------------------------------------------
    def features(self, x):
        """sPAA features (Eq. 14): (sigma (..., L), res-means (..., W))."""
        res, seas = remove_season(x, self.L)
        return seas, paa(res, self.W)

    def encode(self, x):
        """-> (season symbols (..., L), residual symbols (..., W))."""
        seas, res_bar = self.features(x)
        return (discretize(seas, self.b_seas),
                discretize(res_bar, self.b_res))

    # -- distances -------------------------------------------------------
    def spaa_distance(self, fa, fb):
        """d_sPAA (Table 2) between feature pairs (sigma, res_bar)."""
        comb = (fa[0] - fb[0])[..., :, None] + (fa[1] - fb[1])[..., None, :]
        return math.sqrt(self.T / (self.W * self.L)) * \
            torch.sqrt(comb.square().sum(dim=(-2, -1)))

    def distance(self, ra, rb):
        """d_sSAX (Table 2/Eq. 20) between encoded reps (sig_sym, res_sym)."""
        dev = ra[0].device
        s = cell_sum(ra[0], rb[0], ra[1], rb[1], self.b_seas.to(dev),
                     self.b_res.to(dev))
        return math.sqrt(self.T / (self.W * self.L)) * torch.sqrt(s)

    def pairwise_distance(self, rq, rx):
        """queries (Q,L)/(Q,W) x dataset (N,L)/(N,W) -> (Q, N)."""
        sq, wq = rq
        sx, wx = rx
        return self.distance((sq[:, None], wq[:, None]),
                             (sx[None, :], wx[None, :]))
