"""1d-SAX (Malinowski et al., IDA 2013) — the only SAX extension with the
same representation size, used as the trend-aware baseline on Economy.

Each segment is summarized by (mean at segment midpoint, slope) from a
per-segment linear regression; both are quantized — the mean against
N(0,1) quantiles (alphabet A_a), the slope against N(0, sigma_s^2)
quantiles with sigma_s^2 = 0.03 / seg_len (the paper's recommended
heuristic).  The distance reconstructs the per-segment line from symbol
centroids and sums squared differences — faithful to the original; as the
survey table notes, it is *not* proven lower-bounding (we measure this
empirically in the TLB benchmark).

Breakpoints and centroids come from ``torch.special.ndtri`` on the CPU
(``core.breakpoints``); they differ from the JAX package's by at most a
few f32 ulps, inside the snapshot breakpoint check's tolerance.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.breakpoints import discretize, gaussian_breakpoints


def _centroids(alphabet: int, sd: float, device=None):
    """Gaussian cell centroids (median of each equiprobable cell)."""
    qs = (torch.arange(alphabet, dtype=torch.float32) + 0.5) / alphabet
    return (sd * torch.special.ndtri(qs)).to(device)


def segment_regression(x, W: int):
    """Per-segment (midpoint value, slope).  x: (..., T) -> two (..., W)."""
    T = x.shape[-1]
    if T % W:
        raise ValueError(f"W={W} must divide T={T}")
    n = T // W
    xs = x.reshape(*x.shape[:-1], W, n)
    s = torch.arange(n, dtype=x.dtype, device=x.device)
    s_bar = (n - 1) / 2.0
    den = (s - s_bar).square().sum()
    slope = (xs * (s - s_bar)).sum(-1) / torch.clamp_min(den, 1e-12)
    mid = xs.mean(-1)                     # value of the fit at the midpoint
    return mid, slope


@dataclass(frozen=True)
class OneDSAX:
    T: int
    W: int
    A_a: int          # mean alphabet
    A_s: int          # slope alphabet

    @property
    def seg_len(self) -> int:
        return self.T // self.W

    @property
    def sd_slope(self) -> float:
        return math.sqrt(0.03 / self.seg_len)

    @property
    def bits(self) -> float:
        return self.W * (math.log2(self.A_a) + math.log2(self.A_s))

    def encode(self, x):
        mid, slope = segment_regression(x, self.W)
        sa = discretize(mid, gaussian_breakpoints(self.A_a, 1.0))
        ss = discretize(slope, gaussian_breakpoints(self.A_s, self.sd_slope))
        return sa, ss

    def reconstruct(self, rep):
        """Symbol centroids -> per-timestep reconstruction (..., T)."""
        sa, ss = rep
        dev = sa.device
        mid = _centroids(self.A_a, 1.0, dev)[sa.long()]      # (..., W)
        slope = _centroids(self.A_s, self.sd_slope, dev)[ss.long()]
        n = self.seg_len
        s = torch.arange(n, dtype=torch.float32, device=dev) - (n - 1) / 2.0
        vals = mid[..., None] + slope[..., None] * s   # (..., W, n)
        return vals.reshape(*sa.shape[:-1], self.T)

    def distance(self, ra, rb):
        va = self.reconstruct(ra)
        vb = self.reconstruct(rb)
        return torch.sqrt((va - vb).square().sum(-1))

    def pairwise_distance(self, rq, rx):
        vq = self.reconstruct(rq)                       # (Q, T)
        vx = self.reconstruct(rx)                       # (N, T)
        d2 = (vq * vq).sum(-1)[:, None] + (vx * vx).sum(-1)[None, :] \
            - 2.0 * vq @ vx.T
        return torch.sqrt(torch.clamp_min(d2, 0.0))
