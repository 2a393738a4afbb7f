"""``CandidateSource``: where ``topk_verify`` gets its candidates.

The engine's exactness argument (``core.engine`` docstring) only needs a
set of candidates with valid d_ED lower bounds, consumed in bound order
with the k-th-best early stop.  This module abstracts WHERE that set
comes from.  :class:`LinearSweep` is the paper's linear scan: the full
(Q, N) representation-distance matrix, every row a candidate.  The
split-tree source comes with the index.

Every source flows through :func:`topk_from_source`, so all of them share
one verification path and identical exactness guarantees.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np


@dataclass
class CandidateSet:
    """What a source hands the verification scan.

    Either ``bounds`` (host matrix; ``col_ids`` maps columns to dataset
    ids) or ``stream`` (a device-ordered candidate stream — global ids,
    no host matrix) is set, never both."""

    bounds: Optional[np.ndarray]       # (Q, C) d_ED lower bounds
    col_ids: Optional[np.ndarray]      # (C,) dataset id per column
                                       # (None: column j IS row j)
    init_d: Optional[np.ndarray] = None  # (Q, <=k) pre-verified frontier
    init_i: Optional[np.ndarray] = None
    seed_res: Optional[object] = None  # TopKResult of the seed phase
    stream: Optional[object] = None    # device-ordered candidate stream


@runtime_checkable
class CandidateSource(Protocol):
    def candidate_bounds(self, queries_raw, k: int,
                         verify: Callable) -> CandidateSet:
        """Produce the candidate set for a (Q, T) query batch.
        ``verify(cand_idx) -> TopKResult`` verifies a (Q, S) id matrix
        against raw storage (engine-supplied; sources that need a
        verified upper bound call it)."""
        ...


class LinearSweep:
    """The full lower-bound sweep as a candidate source.

    ``stream_fn`` (queries_raw -> device-ordered stream) replaces the
    host (Q, N) matrix with a stream — same candidates in the same
    (bound, id) order, zero host materialization."""

    def __init__(self, repr_fn: Callable,
                 stream_fn: Optional[Callable] = None):
        self._repr_fn = repr_fn       # queries_raw -> (Q, N) bounds
        self._stream_fn = stream_fn

    def candidate_bounds(self, queries_raw, k: int,
                         verify: Callable) -> CandidateSet:
        if self._stream_fn is not None:
            return CandidateSet(bounds=None, col_ids=None,
                                stream=self._stream_fn(queries_raw))
        return CandidateSet(bounds=np.asarray(self._repr_fn(queries_raw)),
                            col_ids=None)


def topk_from_source(queries_raw, source: CandidateSource, store, *,
                     k: int = 1, batch_size: int = 64, verifier=None,
                     merge=None, total: Optional[int] = None,
                     dist_fn=None, on_verified=None, trace=None):
    """Exact top-k through any candidate source — one verification path
    (``core.engine.topk_verify``) for every source.

    ``total``: corpus size for access accounting (``pruned_fraction``);
    defaults to the candidate-column count (correct for dense sources).
    Returns ``core.engine.TopKResult`` with combined accounting across
    the source's seed phase and the pruned scan.  ``dist_fn`` /
    ``on_verified`` follow the ``core.engine.topk_verify`` contracts and
    apply to both phases.  ``trace`` must be None until tracing is
    ported.
    """
    from repro_torch.core.engine import (
        TopKResult, merge_topk_numpy, numpy_verifier, topk_verify,
        verify_candidates)
    if trace is not None:
        raise NotImplementedError("tracing is not ported yet")
    verifier = verifier or numpy_verifier
    merge = merge or merge_topk_numpy

    qs = np.asarray(queries_raw)
    if qs.ndim == 1:
        qs = qs[None]

    def verify(cand_idx):
        return verify_candidates(qs, cand_idx, store, k=k,
                                 verifier=verifier, merge=merge,
                                 dist_fn=dist_fn, on_verified=on_verified)

    cs = source.candidate_bounds(qs, k, verify)
    res = topk_verify(qs, cs.bounds, store, k=k, batch_size=batch_size,
                      verifier=verifier, merge=merge, col_ids=cs.col_ids,
                      init_d=cs.init_d, init_i=cs.init_i,
                      dist_fn=dist_fn, on_verified=on_verified,
                      stream=cs.stream)
    width = (int(cs.stream.width) if cs.stream is not None
             else cs.bounds.shape[1])
    n = width if total is None else int(total)
    if cs.seed_res is None:
        if total is not None and n != width and n != 0:
            res = dataclasses.replace(
                res, pruned_fraction=1.0 - res.raw_accesses / n)
    else:
        seed = cs.seed_res
        acc = res.raw_accesses + seed.raw_accesses
        res = TopKResult(
            indices=res.indices, distances=res.distances,
            raw_accesses=acc,
            pruned_fraction=1.0 - acc / max(n, 1),
            store_accesses=res.store_accesses + seed.store_accesses,
            store_fetches=res.store_fetches + seed.store_fetches,
            io_seconds=res.io_seconds + seed.io_seconds,
            rounds=res.rounds + seed.rounds)
    return res
