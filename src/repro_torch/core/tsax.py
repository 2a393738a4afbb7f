"""tSAX — trend-aware symbolic approximation (paper §3.2).

Model: x = tr + res with tr_t = theta1 + theta2*(t-1) from least squares.
Normalization ties theta2 = -2*theta1/(T-1) (Eq. 25), so the single angle
phi = arctan(theta2) (Eq. 26) captures the trend, bounded by
phi_max = arctan(sqrt(1/var(t))) (Eq. 29).  phi is discretized against a
*uniform* alphabet on [-phi_max, phi_max]; residual means against
N(0, sqrt(1 - R^2_tr)) (Eq. 31).

Distances (Table 2):
  d_tPAA = sqrt(sum_t (d_theta1 + d_theta2*(t-1) + d_resbar_{seg(t)})^2)
  d_tSAX = sqrt(c_t(phi, phi')^2 + (T/W) * sum_w cell(res_w, res'_w)^2)

c_t is the minimum trend-component distance between two phi cells: with
theta2 in [tan(lo), tan(hi)] per cell and
||tr - tr'||_2 = |d_theta2| * sqrt(T * var(t)),

  c_t(a, b) = sqrt(T*var(t)) * max(0, tan(lo_a) - tan(hi_b),
                                      tan(lo_b) - tan(hi_a)).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.breakpoints import (
    discretize, gaussian_breakpoints, uniform_breakpoints)
from repro_torch.core.paa import paa
from repro_torch.core.sax import cell_table


def time_variance(T: int) -> float:
    """Population variance of (1..T) == variance of (0..T-1)."""
    return (T * T - 1) / 12.0


def phi_max(T: int) -> float:
    return math.atan(math.sqrt(1.0 / time_variance(T)))


def trend_features(x):
    """Least-squares (theta1, theta2) per series over s = 0..T-1."""
    T = x.shape[-1]
    s = torch.arange(T, dtype=x.dtype, device=x.device)
    s_bar = (T - 1) / 2.0
    den = (s - s_bar).square().sum()
    theta2 = (x * (s - s_bar)).sum(-1) / den
    theta1 = x.mean(-1) - theta2 * s_bar
    return theta1, theta2


def remove_trend(x):
    """(residuals, theta1, theta2)."""
    T = x.shape[-1]
    t1, t2 = trend_features(x)
    s = torch.arange(T, dtype=x.dtype, device=x.device)
    return x - (t1[..., None] + t2[..., None] * s), t1, t2


def trend_strength(x):
    """R^2_tr (Eq. 30) per series."""
    res, _, _ = remove_trend(x)
    return 1.0 - res.var(-1, correction=0) / torch.clamp_min(
        x.var(-1, correction=0), 1e-12)


def trend_cell_table(T: int, b_tr):
    """(A_tr, A_tr) minimum trend-distance lookup table c_t."""
    pm = torch.tensor([phi_max(T)], dtype=torch.float32)
    edges = torch.cat([-pm, b_tr.to(torch.float32), pm])
    lo = torch.tan(edges[:-1])                     # theta2 cell edges
    hi = torch.tan(edges[1:])
    scale = math.sqrt(T * time_variance(T))
    d = torch.maximum(lo[:, None] - hi[None, :], lo[None, :] - hi[:, None])
    return scale * torch.clamp_min(d, 0.0)


@dataclass(frozen=True)
class TSAX:
    """Trend-aware SAX for fixed (T, W, A_tr, A_res, R^2_tr)."""

    T: int
    W: int
    A_tr: int
    A_res: int
    r2_trend: float = 0.5

    @property
    def sd_res(self) -> float:
        return float(math.sqrt(max(1.0 - self.r2_trend, 1e-9)))

    @property
    def phi_max(self) -> float:
        return phi_max(self.T)

    @property
    def b_tr(self):
        return uniform_breakpoints(self.A_tr, -self.phi_max, self.phi_max)

    @property
    def b_res(self):
        return gaussian_breakpoints(self.A_res, self.sd_res)

    @property
    def bits(self) -> float:
        return math.log2(self.A_tr) + self.W * math.log2(self.A_res)

    # -- representation -------------------------------------------------
    def features(self, x):
        """tPAA features (Eq. 27): (phi (...,), res-means (..., W))."""
        res, _, t2 = remove_trend(x)
        return torch.arctan(t2), paa(res, self.W)

    def encode(self, x):
        """-> (phi symbol (...,), residual symbols (..., W))."""
        phi, res_bar = self.features(x)
        return (discretize(phi, self.b_tr), discretize(res_bar, self.b_res))

    # -- distances -------------------------------------------------------
    def tpaa_distance(self, fa, fb):
        """d_tPAA (Table 2) between feature pairs (phi, res_bar)."""
        T, W = self.T, self.W
        s = torch.arange(T, dtype=torch.float32, device=fa[0].device)
        dt2 = torch.tan(fa[0]) - torch.tan(fb[0])
        dt1 = -dt2 * (T - 1) / 2.0                 # Eq. 25
        dres = fa[1] - fb[1]                       # (..., W)
        seg = torch.div(s, T // W, rounding_mode="floor").long()
        comb = dt1[..., None] + dt2[..., None] * s + dres[..., seg]
        return torch.sqrt(comb.square().sum(-1))

    def ct_table(self):
        """(A_tr, A_tr) minimum trend-distance lookup table."""
        return trend_cell_table(self.T, self.b_tr)

    def distance(self, ra, rb, ct=None, cell=None):
        """d_tSAX (Table 2) between encoded reps (phi_sym, res_syms)."""
        pa, wa = ra
        pb, wb = rb
        dev = pa.device
        ct = self.ct_table().to(dev) if ct is None else ct
        cell = cell_table(self.b_res.to(dev)) if cell is None else cell
        trend_term = ct[pa.long(), pb.long()].square()
        res_term = (self.T / self.W) * \
            cell[wa.long(), wb.long()].square().sum(-1)
        return torch.sqrt(trend_term + res_term)

    def pairwise_distance(self, rq, rx):
        """queries x dataset -> (Q, N)."""
        pq, wq = rq
        px, wx = rx
        return self.distance((pq[:, None], wq[:, None, :]),
                             (px[None, :], wx[None, :, :]))
