"""SAX extensions from the paper's §2.4 survey (Table 1), implemented as
additional baselines: ESAX, SAX_SD, TD-SAX.

These are *survey* baselines — the paper's own evaluation compares against
SAX and 1d-SAX only; they serve the Table-1 property benchmark
(representation size / #lookups / lower-bounding) and extra TLB
ablations.  Distances follow the cited originals; each one states whether
it is lower-bounding.  Segment means run through the port's ``paa`` (the
K4 kernel for a CUDA tensor, its plain version on the CPU).
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from repro_torch.core.breakpoints import discretize, gaussian_breakpoints
from repro_torch.core.paa import paa
from repro_torch.core.sax import cell_table


def _segments(x, T: int, W: int):
    return x.reshape(*x.shape[:-1], W, T // W)


def _table(A: int, device):
    return cell_table(gaussian_breakpoints(A, 1.0)).to(device)


def _mindist_cells(tab, a, b):
    return tab[a.long(), b.long()]


@dataclass(frozen=True)
class ESAX:
    """ESAX (Lkhagva et al. 2006): (min, mean, max) symbol per segment.

    Lower-bounding: the mean-symbol MINDIST term alone already
    lower-bounds d_ED; the min/max terms are used only as tie-sharpeners
    in the original (which proposes max over feature distances — NOT
    guaranteed LB).  ``distance`` is the safe variant: SAX MINDIST on the
    mean symbols (LB); ``distance_maxfeat`` is the original behaviour.
    """

    T: int
    W: int
    A: int

    @property
    def bits(self) -> float:
        return 3 * self.W * math.log2(self.A)

    def encode(self, x):
        xs = _segments(x, self.T, self.W)
        bp = gaussian_breakpoints(self.A, 1.0)
        return (discretize(xs.amin(-1), bp),
                discretize(paa(x, self.W), bp),
                discretize(xs.amax(-1), bp))

    def distance(self, ra, rb):
        c = _mindist_cells(_table(self.A, ra[1].device), ra[1], rb[1])
        return math.sqrt(self.T / self.W) * torch.sqrt(c.square().sum(-1))

    def distance_maxfeat(self, ra, rb):
        tab = _table(self.A, ra[0].device)
        cs = torch.stack([_mindist_cells(tab, ra[i], rb[i])
                          for i in range(3)], dim=0)
        c = cs.amax(0)
        return math.sqrt(self.T / self.W) * torch.sqrt(c.square().sum(-1))


@dataclass(frozen=True)
class SAXSD:
    """SAX_SD (Zan & Yamana 2016): mean symbol + raw stddev per segment.

    Distance adds the segment-stddev gap to MINDIST; LB per the original.
    Representation grows by 32 bits/segment (Table 1).
    """

    T: int
    W: int
    A: int

    @property
    def bits(self) -> float:
        return self.W * (math.log2(self.A) + 32)

    def encode(self, x):
        xs = _segments(x, self.T, self.W)
        bp = gaussian_breakpoints(self.A, 1.0)
        return (discretize(paa(x, self.W), bp),
                torch.std(xs, -1, correction=0))

    def distance(self, ra, rb):
        c = _mindist_cells(_table(self.A, ra[0].device), ra[0], rb[0])
        sd_gap = (ra[1] - rb[1]).abs()
        return math.sqrt(self.T / self.W) * \
            torch.sqrt((c.square() + sd_gap.square()).sum(-1))


@dataclass(frozen=True)
class TDSAX:
    """TD-SAX (Sun et al. 2014): mean symbol + raw (start, end) trend values.

    Distance: MINDIST + weighted trend distance on the real-valued
    start/end deltas (not a LUT).  LB per the original's Theorem 1 with
    weight <= 1; the conservative w=0 trend weight serves exact matching
    (pure MINDIST) and w=0.5 accuracy experiments.
    """

    T: int
    W: int
    A: int
    trend_weight: float = 0.5

    @property
    def bits(self) -> float:
        return self.W * (math.log2(self.A) + 32) + 32

    def encode(self, x):
        xs = _segments(x, self.T, self.W)
        bp = gaussian_breakpoints(self.A, 1.0)
        return (discretize(paa(x, self.W), bp), xs[..., 0], xs[..., -1])

    def distance(self, ra, rb):
        c = _mindist_cells(_table(self.A, ra[0].device), ra[0], rb[0])
        mind = (self.T / self.W) * c.square().sum(-1)
        tr = ((ra[1] - rb[1]).square() + (ra[2] - rb[2]).square()).sum(-1)
        return torch.sqrt(mind + self.trend_weight * tr)
