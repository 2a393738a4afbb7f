"""``CandidateSource``: where ``topk_verify`` gets its candidates.

The engine's exactness argument (``core.engine`` docstring) only needs a
set of candidates with valid d_ED lower bounds, consumed in bound order
with the k-th-best early stop.  This module abstracts WHERE that set
comes from:

* :class:`LinearSweep` — the paper's linear scan: the full (Q, N)
  representation-distance matrix (device sweep), every row a candidate.
* :class:`TreeCandidates` — sublinear generation from a
  :class:`repro_torch.index.tree.SplitTree`:

  1. *Seed*: per query, walk leaves best-first until >= k members; the
     engine verifies them in one batched fetch — the k-th verified
     distance U upper-bounds the true k-th NN.
  2. *Collect*: walk the tree pruning subtrees with box bound > U;
     surviving members with feature bound <= U become a COMPACT
     candidate set (everything else provably cannot enter the top-k,
     even on ties, since bound > U >= d_k implies d > d_k).
  3. The engine's ``topk_verify`` consumes the compact bounds in sorted
     order with the same k-th-best early stop (``col_ids`` maps columns
     to dataset rows), seeded with the phase-1 frontier (seed members
     are excluded so no candidate is verified twice).

Both sources flow through :func:`topk_from_source`, so indexed and
linear top-k share one verification path and identical exactness
guarantees — results are bit-identical (same verifier, same (distance,
id) tie-break), only the number of candidates examined differs.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Callable, Optional, Protocol, runtime_checkable

import numpy as np

from repro_torch.core.engine import merge_topk_numpy
from repro_torch.index.tree import SplitTree


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
    # approximate mode only: per-query lower bounds of the candidates
    # the bounded collect DROPPED — the certificate behind the result's
    # ``kth_lb`` / ``error_bar`` (None on exact paths)
    approx_dropped: Optional[list] = None


@runtime_checkable
class CandidateSource(Protocol):
    def candidate_bounds(self, queries_raw, k: int,
                         verify: Callable) -> CandidateSet:
        """Produce the candidate set for a (Q, T) query batch.
        ``verify(cand_idx) -> TopKResult`` verifies a (Q, S) id matrix
        against raw storage (engine-supplied; sources that need a
        verified upper bound — the tree's seed phase — call it)."""
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


class TreeCandidates:
    """Sublinear candidate generation from a split tree.

    ``query_features`` maps the engine's query batch to (Q, D) adapter
    features — precomputed-feature callers pass a closure ignoring the
    raw queries.

    Frontier reuse (exclusion widening): ``prior_d`` / ``prior_i`` seed
    an already-verified frontier ((Q, <=k) ascending, -1 / +inf padded)
    and ``seen`` lists EVERY id verified in earlier rounds (a per-query
    superset of the prior ids).  The seed walk then only verifies ids
    never seen before, and the collect phase excludes all seen ids — so
    across widening rounds no id is ever verified twice.  Exactness is
    preserved under the caller's contract that ``prior`` holds the best
    ``min(k, |verified|)`` of the accumulated verified set: a seen id
    outside that frontier is dominated by >= k verified better ids and
    can never re-enter the top-k.

    ``device_order=True`` sorts the compact union bounds on ``device``
    (``core.distributed.host_order_stream``: f64 bounds rounded down to
    f32) and streams ids to the scan instead of a host bound matrix.

    ``approx_collect=C`` is the APPROXIMATE mode (the planner's anytime
    tier): the seed walk still runs exactly, but the collect phase keeps
    only the C best-(bound, id) survivors per query and records the
    dropped candidates' lower bounds in ``CandidateSet.approx_dropped``.
    ``topk_from_source`` turns those into a certified per-query
    ``kth_lb`` (the k-th smallest over verified true distances and
    dropped bounds — every dropped candidate's true distance is >= its
    bound, so the true k-th NN distance is >= ``kth_lb``) and
    ``error_bar = d_k - kth_lb``; an ``error_bar`` of zero proves the
    answer exact despite the cap.
    """

    def __init__(self, tree: SplitTree, query_features: Callable, *,
                 prior_d=None, prior_i=None, seen=None,
                 device_order: bool = False,
                 approx_collect: Optional[int] = None,
                 epoch=None, device="cuda"):
        self.tree = tree
        self._device_order = bool(device_order)
        self._device = device
        self._query_features = query_features
        # as-of frontier: only items with id < epoch are generated (a
        # ``CorpusEpoch`` or plain row count; None = live).  Inserts
        # only extend the tree, so the filter happens inside the
        # traversals (tree.seed_candidates / collect_bounds max_id) —
        # no copy-on-write, bit-identical to a tree truncated there.
        from repro_torch.store.symbolic import epoch_rows
        self._epoch = epoch_rows(epoch)
        if approx_collect is not None and approx_collect < 0:
            raise ValueError("approx_collect must be >= 0")
        self._approx_collect = approx_collect
        # prior and seen travel together: seen ids without their verified
        # frontier cannot be excluded exactly (their distances are lost),
        # and a seeded frontier without the seen set would be re-collected
        # and double-merged
        if (seen is None) != (prior_i is None) or \
                (prior_d is None) != (prior_i is None):
            raise ValueError("prior_d, prior_i and seen must be passed "
                             "together (or all omitted)")
        self._prior_d = prior_d
        self._prior_i = prior_i
        self._seen = seen

    @property
    def is_approx(self) -> bool:
        return self._approx_collect is not None

    def _fresh_seeds(self, qf_r, k: int, n_prior: int, seen_r):
        """Best-first seed ids never verified before, walking deeper
        until prior + fresh can pin the k-th-NN upper bound U (or the
        tree is exhausted)."""
        need = k - n_prior
        if need <= 0:
            return np.empty(0, np.int64)
        m = k
        while True:
            s = np.asarray(self.tree.seed_candidates(
                qf_r, m, max_id=self._epoch), np.int64)
            fresh = s[~np.isin(s, seen_r)]
            if len(fresh) >= need or len(s) < m:   # < m: walk exhausted
                return fresh
            m *= 2

    def candidate_bounds(self, queries_raw, k: int,
                         verify: Callable) -> CandidateSet:
        tree = self.tree
        qf = np.asarray(self._query_features(queries_raw), np.float32)
        if qf.ndim == 1:
            qf = qf[None]
        q_n = qf.shape[0]
        n_vis = tree.n if self._epoch is None \
            else min(tree.n, self._epoch)
        if n_vis == 0:
            return CandidateSet(
                bounds=np.empty((q_n, 0)), col_ids=None,
                approx_dropped=([np.empty(0)] * q_n if self.is_approx
                                else None))
        k = min(k, n_vis)

        seen = self._seen if self._seen is not None \
            else [np.empty(0, np.int64)] * q_n
        seen = [np.asarray(s, np.int64) for s in seen]
        if self._prior_i is not None:
            prior_d = np.asarray(self._prior_d, np.float64)
            prior_i = np.asarray(self._prior_i, np.int64)
            n_prior = (prior_i >= 0).sum(axis=1)
        else:
            prior_d = prior_i = None
            n_prior = np.zeros(q_n, np.int64)

        seeds = [self._fresh_seeds(qf[r], k, int(n_prior[r]), seen[r])
                 for r in range(q_n)]
        width = max(len(s) for s in seeds)
        seed_res = None
        if width:
            cand = np.full((q_n, width), -1, np.int64)
            for r, s in enumerate(seeds):
                cand[r, :len(s)] = s
            seed_res = verify(cand)

        # merged frontier: prior rounds + freshly verified seeds — this
        # seeds the scan (init_d/init_i) and pins U per query
        if seed_res is None:
            merged_d = prior_d[:, :k]
            merged_i = prior_i[:, :k]
        elif prior_d is None:
            merged_d, merged_i = seed_res.distances, seed_res.indices
        else:
            merged_d, merged_i = merge_topk_numpy(
                np.concatenate([prior_d, seed_res.distances], axis=1),
                np.concatenate([prior_i, seed_res.indices], axis=1), k)

        all_ids, all_lbs = [], []
        dropped = [] if self.is_approx else None
        for r in range(q_n):
            # U upper-bounds the true k-th NN only once k members are
            # verified; a short frontier (corpus < k) collects everything
            u = (float(merged_d[r, k - 1])
                 if merged_d.shape[1] >= k else np.inf)
            ids_r, lb_r = tree.collect_bounds(qf[r], u,
                                              max_id=self._epoch)
            drop = np.concatenate([seen[r], seeds[r]])
            keep = ~np.isin(ids_r, drop)   # verified ids never re-enter
            ids_r, lb_r = ids_r[keep], lb_r[keep]
            if self.is_approx and ids_r.size > self._approx_collect:
                # bounded collect: keep the C best survivors in the scan
                # order (bound, id); the dropped bounds are the error
                # certificate — every dropped true distance >= its bound
                order = np.lexsort((ids_r, lb_r))
                cut = order[self._approx_collect:]
                dropped.append(lb_r[cut].copy())
                sel = np.sort(order[:self._approx_collect])
                ids_r, lb_r = ids_r[sel], lb_r[sel]
            elif self.is_approx:
                dropped.append(np.empty(0))
            all_ids.append(ids_r)
            all_lbs.append(lb_r)
        union = np.unique(np.concatenate(all_ids))     # sorted row ids
        bounds = np.full((q_n, union.size), np.inf, np.float64)
        for r in range(q_n):
            bounds[r, np.searchsorted(union, all_ids[r])] = all_lbs[r]
        if self._device_order and union.size:
            from repro_torch.core.distributed import host_order_stream
            return CandidateSet(bounds=None, col_ids=None,
                                stream=host_order_stream(bounds, union,
                                                         self._device),
                                init_d=merged_d, init_i=merged_i,
                                seed_res=seed_res, approx_dropped=dropped)
        return CandidateSet(bounds=bounds, col_ids=union,
                            init_d=merged_d,
                            init_i=merged_i, seed_res=seed_res,
                            approx_dropped=dropped)


def topk_from_source(queries_raw, source: CandidateSource, store, *,
                     k: int = 1, batch_size: int = 64, verifier=None,
                     merge=None, total: Optional[int] = None,
                     dist_fn=None, on_verified=None, trace=None):
    """Exact top-k through any candidate source — one verification path
    (``core.engine.topk_verify``) for linear and indexed search.

    ``total``: corpus size for access accounting (``pruned_fraction``);
    defaults to the candidate-column count (correct for dense sources).
    Returns ``core.engine.TopKResult`` with combined accounting across
    the source's seed phase and the pruned scan.

    ``dist_fn`` / ``on_verified`` follow the ``core.engine.topk_verify``
    contracts and apply to BOTH phases — with a ``dist_fn`` the seed
    verification is device-resident too.

    ``trace``: optional ``repro_torch.obs.Trace`` — candidate generation is
    recorded as span "order" (the tree's seed verification nests as
    "order/seed") and the pruned scan as span "verify"; off (None) the
    call path is unchanged.
    """
    from repro_torch.core.engine import (
        TopKResult, numpy_verifier, topk_verify, verify_candidates)
    from repro_torch.obs.trace import block_until_ready, maybe_span, span
    verifier = verifier or numpy_verifier
    merge = merge or merge_topk_numpy

    qs = np.asarray(queries_raw)
    if qs.ndim == 1:
        qs = qs[None]

    def verify(cand_idx):
        with maybe_span(trace, "seed"):
            return verify_candidates(qs, cand_idx, store, k=k,
                                     verifier=verifier, merge=merge,
                                     dist_fn=dist_fn,
                                     on_verified=on_verified, trace=trace)

    with maybe_span(trace, "order") as order_span:
        # encode, sweep and order, up to the candidate stream being ready
        with span("match.sweep"):
            cs = source.candidate_bounds(qs, k, verify)
        if trace is not None and cs.stream is not None:
            # the stream's sort ran on device — fence it so the "order"
            # wall-clock is the kernel time, not the launch time
            block_until_ready((getattr(cs.stream, "_b", None),
                               getattr(cs.stream, "_i", None)))
            order_span.meta["stream"] = True
    with maybe_span(trace, "verify"):
        res = topk_verify(qs, cs.bounds, store, k=k, batch_size=batch_size,
                          verifier=verifier, merge=merge,
                          col_ids=cs.col_ids,
                          init_d=cs.init_d, init_i=cs.init_i,
                          dist_fn=dist_fn, on_verified=on_verified,
                          stream=cs.stream, trace=trace)
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
    if cs.approx_dropped is not None:
        _attach_error_bar(res, cs.approx_dropped, k, trace)
    return res


def _attach_error_bar(res, dropped: list, k: int, trace=None) -> None:
    """Approximate-mode certificate: ``res.kth_lb[r]`` is the k-th
    smallest over (verified true distances, dropped candidates' lower
    bounds) — a valid lower bound on the true k-th-NN distance because
    every dropped candidate's true distance is >= its bound.
    ``res.error_bar = d_k - kth_lb`` (0 proves exactness; inf when
    fewer than k candidates were verified at all)."""
    q_n = res.distances.shape[0]
    kth_lb = np.full(q_n, np.inf)
    for r in range(q_n):
        row = res.distances[r]
        vals = np.concatenate([row[np.isfinite(row)],
                               np.asarray(dropped[r], np.float64)])
        if vals.size:
            vals.sort()
            kth_lb[r] = vals[min(k, vals.size) - 1]
    dk = res.distances[:, -1].astype(np.float64)
    # dk finite -> kth_lb <= dk (the union includes the verified row);
    # dk inf with a finite dropped bound -> genuinely unbounded error;
    # both inf (empty corpus) -> vacuously exact
    res.kth_lb = kth_lb
    res.error_bar = np.where(
        np.isfinite(dk), np.maximum(dk - kth_lb, 0.0),
        np.where(np.isfinite(kth_lb), np.inf, 0.0))
    if trace is not None:
        trace.set("kth_lb", kth_lb.copy())
        trace.set("error_bar", res.error_bar.copy())
