"""stSAX — season- AND trend-aware symbolic approximation.

This implements the paper's stated FUTURE WORK (§6: "representing
combinations of deterministic components ... seasonal components in
combination with a trend").  Model:

    x = tr + seas + res,

extracted in order: linear-regression trend first (so Eqs. 23-25 hold for
the detrended remainder), then the per-phase season mask of the detrended
series, then residual segment means.  Representation:

    (phi_hat, sigma_hat_1..L, res_hat_1..W)

with the tSAX uniform trend alphabet and the sSAX Gaussian season/residual
alphabets; strengths compose as sd(res) = sqrt(1 - R2_tr - R2_seas').

Lower-bounding distance: ``seas + res`` IS the least-squares residual of
the trend fit, so the trend difference is orthogonal to it:

    d_ED^2 = sum_t (d_tr_t)^2 + sum_t (d_seas_t + d_res_t)^2
    >= c_t(phi, phi')^2 + (T/(W*L)) * sum_{l,w} cell(sig, sig', res, res')^2

so d_stSAX^2 = c_t^2 + d_sSAX-part^2 lower-bounds d_ED^2.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.breakpoints import (
    discretize, gaussian_breakpoints, uniform_breakpoints)
from repro_torch.core.paa import paa
from repro_torch.core.ssax import _tile, cell_sum, season_mask
from repro_torch.core.tsax import phi_max, remove_trend, trend_cell_table


@dataclass(frozen=True)
class STSAX:
    """Combined season+trend-aware SAX for fixed
    (T, W, L, A_tr, A_seas, A_res, strengths)."""

    T: int
    W: int
    L: int
    A_tr: int
    A_seas: int
    A_res: int
    r2_trend: float = 0.3
    r2_season: float = 0.3      # season strength of the detrended series

    def __post_init__(self):
        if self.T % (self.W * self.L):
            raise ValueError(f"W*L={self.W * self.L} must divide T={self.T}")

    # -- alphabets -------------------------------------------------------
    @property
    def phi_max(self) -> float:
        return phi_max(self.T)

    @property
    def b_tr(self):
        return uniform_breakpoints(self.A_tr, -self.phi_max, self.phi_max)

    @property
    def sd_detrended(self) -> float:
        return math.sqrt(max(1.0 - self.r2_trend, 1e-9))

    @property
    def sd_seas(self) -> float:
        # season variance within the detrended remainder
        return self.sd_detrended * math.sqrt(max(self.r2_season, 1e-9))

    @property
    def sd_res(self) -> float:
        return self.sd_detrended * math.sqrt(max(1.0 - self.r2_season, 1e-9))

    @property
    def b_seas(self):
        return gaussian_breakpoints(self.A_seas, self.sd_seas)

    @property
    def b_res(self):
        return gaussian_breakpoints(self.A_res, self.sd_res)

    @property
    def bits(self) -> float:
        return (math.log2(self.A_tr) + self.L * math.log2(self.A_seas)
                + self.W * math.log2(self.A_res))

    # -- representation ---------------------------------------------------
    def features(self, x):
        """-> (phi (...,), sigma (..., L), res-means (..., W))."""
        detr, _, t2 = remove_trend(x)
        seas = season_mask(detr, self.L)
        res = detr - _tile(seas, self.T // self.L)
        return torch.arctan(t2), seas, paa(res, self.W)

    def encode(self, x):
        phi, seas, res_bar = self.features(x)
        return (discretize(phi, self.b_tr),
                discretize(seas, self.b_seas),
                discretize(res_bar, self.b_res))

    # -- distance -----------------------------------------------------------
    def ct_table(self):
        return trend_cell_table(self.T, self.b_tr)

    def distance(self, ra, rb, ct=None):
        """d_stSAX between encoded reps (phi_sym, sig_syms, res_syms)."""
        pa, sa, wa = ra
        pb, sb, wb = rb
        dev = pa.device
        ct = self.ct_table().to(dev) if ct is None else ct
        trend_term = ct[pa.long(), pb.long()].square()
        seas_res_term = (self.T / (self.W * self.L)) * cell_sum(
            sa, sb, wa, wb, self.b_seas.to(dev), self.b_res.to(dev))
        return torch.sqrt(trend_term + seas_res_term)

    def pairwise_distance(self, rq, rx):
        pq, sq, wq = rq
        px, sx, wx = rx
        return self.distance((pq[:, None], sq[:, None], wq[:, None]),
                             (px[None, :], sx[None, :], wx[None, :]))
