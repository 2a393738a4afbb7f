"""Time-series matching (paper §4.1) on top of any lower-bounding
representation distance.

Exact matching: the paper scans candidates in representation-distance order
and stops when best-so-far ED <= next representation distance.  The engine
works in fixed-size *verification batches*: sort once, verify a batch of
raw candidates, tighten best-so-far, and stop at the first batch whose
leading representation distance already exceeds best-so-far.  Because the
representation distance lower-bounds ED, no pruned candidate can win —
results are identical to the paper's scan, and the number of raw accesses
differs by at most one batch of padding.

A ``RawStore`` abstracts the cold storage the paper keeps on HDD/SSD; the
cost model converts raw accesses into modeled I/O time at configurable
rates so the Table-5 experiment can be reproduced without a 100 Gb disk.
The store and its accounting are host-side numpy, as in the reference.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch


def euclidean(a, b):
    """d_ED (Eq. 3) along the last axis."""
    return torch.sqrt((a - b).square().sum(-1))


# ---------------------------------------------------------------------------
# Raw store (simulated cold storage)
# ---------------------------------------------------------------------------

# (seek_seconds, bytes_per_second) presets — the single source of truth
# for the RawStore constructors below
MEDIA = {
    "hdd": (5e-3, 150e6),
    "ssd": (6e-5, 500e6),
    "hbm": (1e-7, 819e9),
}


@dataclass
class RawStore:
    """Raw time-series access with an I/O cost model.

    rates are (seek_seconds, bytes_per_second); defaults model the paper's
    HDD.  ``hbm()`` models raw rows resident in device memory — the
    paper's disk-bound gap becomes a bandwidth gap.
    """

    data: np.ndarray                  # (N, T) float32
    seek_s: float = 5e-3
    read_bps: float = 150e6
    accesses: int = 0                 # rows read
    fetches: int = 0                  # fetch() calls (modeled seeks)

    @staticmethod
    def hdd(data):
        return RawStore(data, *MEDIA["hdd"])

    @staticmethod
    def ssd(data):
        return RawStore(data, *MEDIA["ssd"])

    @staticmethod
    def hbm(data):
        return RawStore(data, *MEDIA["hbm"])

    def fetch(self, idx) -> np.ndarray:
        idx = np.asarray(idx)
        if idx.dtype == bool:            # boolean masks keep working
            idx = np.nonzero(idx)[0]
        idx = idx.astype(np.int64)
        if idx.size == 0:
            # an all-pruned round touches no media: no seek, no rows
            return np.empty((0,) + self.data.shape[1:], self.data.dtype)
        # a physical row is read once per fetch no matter how many times
        # it appears in idx — bill deduplicated
        self.accesses += int(np.unique(idx).size)
        self.fetches += 1
        return self.data[idx]

    def modeled_io_seconds(self, n_accesses: Optional[int] = None,
                           n_fetches: Optional[int] = None) -> float:
        """Batch-accounted I/O model: one seek per fetch() call plus a
        bandwidth term per row.  With an explicit ``n_accesses`` and no
        ``n_fetches`` every access pays its own seek (the paper's
        row-at-a-time baseline)."""
        if n_accesses is None:
            n, f = self.accesses, self.fetches
        else:
            n = int(n_accesses)
            f = n if n_fetches is None else int(n_fetches)
        bytes_per = self.data.shape[-1] * 4
        return f * self.seek_s + n * bytes_per / self.read_bps

    def reset_counters(self):
        """Zero the I/O accounting (``accesses`` / ``fetches``), the phase
        boundary between two measured runs."""
        self.accesses = 0
        self.fetches = 0

    def reset(self):
        self.reset_counters()


# ---------------------------------------------------------------------------
# Exact matching with lower-bound pruning
# ---------------------------------------------------------------------------

@dataclass
class MatchResult:
    index: int
    distance: float
    raw_accesses: int
    pruned_fraction: float
    repr_distances: Optional[np.ndarray] = None


def exact_match(query_raw, repr_dists, store: RawStore, *,
                batch_size: int = 64) -> MatchResult:
    """Exact nearest neighbour under d_ED using lower-bounding repr dists.

    Thin single-query wrapper over the batched k-NN core
    (``core.engine.topk_verify``) with the host verifier."""
    from repro_torch.core.engine import topk_verify
    res = topk_verify(np.asarray(query_raw)[None],
                      np.asarray(repr_dists)[None], store,
                      k=1, batch_size=batch_size)
    return MatchResult(index=int(res.indices[0, 0]),
                       distance=float(res.distances[0, 0]),
                       raw_accesses=int(res.raw_accesses[0]),
                       pruned_fraction=float(res.pruned_fraction[0]))


def approximate_match(query_raw, repr_dists, store: RawStore, *,
                      rtol: float = 1e-6) -> MatchResult:
    """Paper's approximate matching: min representation distance; ties
    broken by true ED among the tied set."""
    repr_dists = np.asarray(repr_dists)
    N = repr_dists.shape[0]
    dmin = repr_dists.min()
    ties = np.nonzero(repr_dists <= dmin + rtol * (1.0 + dmin))[0]
    start0 = store.accesses
    if len(ties) == 1:
        idx = int(ties[0])
        rows = store.fetch(np.asarray([idx]))
        d = float(np.sqrt(np.sum((rows[0] - np.asarray(query_raw)) ** 2)))
    else:
        rows = store.fetch(ties)
        ds = np.sqrt(np.sum((rows - np.asarray(query_raw)[None]) ** 2, -1))
        j = int(np.argmin(ds))
        idx, d = int(ties[j]), float(ds[j])
    return MatchResult(index=idx, distance=d,
                       raw_accesses=store.accesses - start0,
                       pruned_fraction=1.0 - (store.accesses - start0) / N)


def pruning_power(query_raw, repr_dists, raw_data, k: int = 1) -> float:
    """Fraction of observations never verified (paper, Chen et al. [3]):
    with the true k-NN distance d*_k, everything with repr dist > d*_k is
    pruned."""
    d_true = np.sqrt(np.sum((np.asarray(raw_data)
                             - np.asarray(query_raw)[None]) ** 2, -1))
    d_star = np.sort(d_true)[min(k, d_true.shape[0]) - 1]
    repr_dists = np.asarray(repr_dists)
    return float(np.mean(repr_dists > d_star))


def tightness_of_lower_bound(repr_d, true_d, eps: float = 1e-12):
    """TLB (Eq. 33) averaged over all pairs; inputs (..., ) matched."""
    r = np.asarray(repr_d, dtype=np.float64)
    t = np.asarray(true_d, dtype=np.float64)
    mask = t > eps
    return float(np.mean(np.where(mask, r / np.maximum(t, eps), 1.0)))
