"""Original SAX (Lin et al. 2003): PAA segment means discretized against
N(0,1)-quantile breakpoints, with the MINDIST lower-bounding distance.

The ``cell`` lookup table implements Eq. 11 in its standard (Lin) indexing:
with 0-based symbols and interior breakpoints bp[0..A-2],

    cell(r, c) = 0                      if |r - c| <= 1
               = bp[max(r,c)-1] - bp[min(r,c)]   otherwise

(the paper's Eq. 11 subscripts carry an off-by-one typo; the proofs in
Appendix A use the standard form, which we follow).  Equivalently
``cell = max(0, lower(r)-upper(c), lower(c)-upper(r))`` — the form our
sSAX/tSAX generalizations reuse.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.breakpoints import (
    discretize, gaussian_breakpoints, lower_bounds, upper_bounds)
from repro_torch.core.paa import paa


def cell_table(breakpoints):
    """(A, A) MINDIST lookup table from interior breakpoints."""
    lo = lower_bounds(breakpoints)           # (A,)
    hi = upper_bounds(breakpoints)
    d = torch.maximum(lo[:, None] - hi[None, :], lo[None, :] - hi[:, None])
    return torch.clamp_min(d, 0.0)


@dataclass(frozen=True)
class SAX:
    """SAX encoder/distance for fixed (T, W, A)."""

    T: int
    W: int
    A: int
    sd: float = 1.0

    @property
    def breakpoints(self):
        return gaussian_breakpoints(self.A, self.sd)

    @property
    def bits(self) -> float:
        return self.W * math.log2(self.A)

    def encode(self, x):
        """x: (..., T) normalized -> symbols (..., W) int32."""
        return discretize(paa(x, self.W), self.breakpoints)

    def distance(self, s, s_prime, table=None):
        """d_SAX (Eq. 10) between symbol vectors (..., W)."""
        if table is None:
            table = cell_table(self.breakpoints.to(s.device))
        c = table[s.long(), s_prime.long()]
        return math.sqrt(self.T / self.W) * torch.sqrt(c.square().sum(-1))

    def pairwise_distance(self, queries, dataset, table=None):
        """(Q, W) x (N, W) -> (Q, N) symbolic distances."""
        return self.distance(queries[:, None, :], dataset[None, :, :],
                             table=table)
