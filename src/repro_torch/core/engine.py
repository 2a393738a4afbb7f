"""Unified batched k-NN matching engine.

``MatchEngine`` answers batched multi-query **top-k** matching — exact
(lower-bound pruned scan) and approximate (representation top-k then
verify) — over any encoder with ``encode`` + ``pairwise_distance``
(SAX, sSAX, tSAX, stSAX) and a ``RawStore`` for raw verification.

API
---
::

    engine = MatchEngine(encoder, RawStore.ssd(D))    # device="cuda"
    res = engine.topk(queries, k=32)                  # exact k-NN
    res = engine.topk(queries, k=32, exact=False)     # approximate
    res = engine.verify_candidates(queries, cand_idx) # external candidates

``res`` is a :class:`TopKResult`: per-query ``indices``/``distances``
(Q, k), per-query ``raw_accesses`` / ``pruned_fraction``, and the
store-level deduplicated access count + modeled I/O seconds.

Batched-verification correctness argument
-----------------------------------------
The paper's sequential exact scan visits candidates in representation-
distance order and stops when best-so-far ED <= the next representation
distance; since every representation distance lower-bounds d_ED
(Appendix A.1–A.5), no pruned candidate can be the NN.  The engine
generalizes this to top-k and to fixed-size batches:

* Per query it maintains a best-k *frontier* (the k smallest verified
  true distances so far, with their indices).  The pruning threshold is
  the k-th best frontier distance — ``inf`` until k candidates are
  verified, so the first ceil(k / batch) batches are never pruned.
* Candidates are consumed in representation-distance order in batches
  of ``batch_size``.  Before verifying a batch, the engine checks
  ``kth_best < repr_dist(next unseen)``; because the candidate order is
  sorted, that single comparison lower-bounds *every* unseen candidate,
  so stopping there cannot drop a true top-k member.  The comparison is
  strict: a candidate whose bound exactly equals the k-th best could
  still TIE the k-th member's true distance and win on the (distance,
  dataset index) tie-break, so boundary-equal candidates are verified.
* Therefore the surviving frontier equals the sequential scan's result
  exactly; batching only over-fetches by at most one batch per query.

The host logic is numpy, line for line the reference's.  The encode and
the sweep run on the engine's device (through the K4, K2 and K3 kernels
on a card); verification on a card goes through the K1 kernel, whose
reduction order per (query, row) is fixed, so every route that verifies
through it — and a K1 brute force over the whole corpus — gives
bit-identical distances.  ``verify="numpy"`` is the host path,
bit-identical to a numpy brute-force scan.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.matching import RawStore
from repro_torch.kernels.euclid import euclid_gather
from repro_torch.obs.trace import maybe_span, span


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist — there
    is no silent fall back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "to run on the CPU")
    return dev


# ---------------------------------------------------------------------------
# Results
# ---------------------------------------------------------------------------

@dataclass
class TopKResult:
    """Batched top-k matches.  Rows padded with index -1 / distance inf
    when fewer than k candidates exist."""

    indices: np.ndarray          # (Q, k) int64 dataset rows, best first
    distances: np.ndarray        # (Q, k) true d_ED (verifier dtype)
    raw_accesses: np.ndarray     # (Q,) candidates verified per query
    pruned_fraction: np.ndarray  # (Q,) 1 - raw_accesses / N
    store_accesses: int          # deduplicated physical row reads
    store_fetches: int           # batched fetch() calls (modeled seeks)
    io_seconds: float            # batch-accounted modeled I/O
    rounds: int = 0              # verification rounds (verifier calls)


# ---------------------------------------------------------------------------
# Verifiers: (union_rows (U, T), queries (Qa, T), gather (Qa, B)) -> (Qa, B)
# ---------------------------------------------------------------------------

def numpy_verifier(rows: np.ndarray, qs: np.ndarray,
                   gather: np.ndarray) -> np.ndarray:
    """Host verification, bit-identical to a numpy brute-force scan (each
    row's sum runs over the same contiguous T values)."""
    per_q = rows[gather]                             # (Qa, B, T)
    d2 = np.sum(np.square(per_q - qs[:, None, :]), axis=-1)
    return np.sqrt(d2)


def kernel_verifier(rows: np.ndarray, qs: np.ndarray, gather: np.ndarray,
                    *, device="cuda") -> np.ndarray:
    """Verification through the K1 euclid kernel on ``device`` (its plain
    version for a CPU device): one gathered launch per round.  The
    round's fetched rows, its queries and the gather go to the device
    once; each query is distanced against its own candidate rows only.
    The square root is numpy's, as in a K1 brute force, so the two agree
    bitwise."""
    dev = torch.device(device)
    rows_d = torch.as_tensor(np.asarray(rows), dtype=torch.float32).to(dev)
    qs_d = torch.as_tensor(np.asarray(qs), dtype=torch.float32).to(dev)
    d2 = euclid_gather(rows_d, qs_d, np.asarray(gather, np.int64))
    with span("wait"):
        d2 = d2.cpu()
    return np.sqrt(np.maximum(d2.numpy(), 0.0))


def make_verifier(mode: str, device="cuda") -> Callable:
    """``"numpy"`` is the host path; ``"kernel"`` and ``"host"`` verify
    through K1 on ``device``: "host" is the host-side twin of the
    device-resident route and must use the same kernel math.  ``"auto"``
    is K1 on a CUDA device and numpy on the CPU."""
    if mode == "numpy":
        return numpy_verifier
    if mode in ("kernel", "host"):
        return functools.partial(kernel_verifier, device=device)
    if mode == "auto":
        return (functools.partial(kernel_verifier, device=device)
                if torch.device(device).type == "cuda" else numpy_verifier)
    raise ValueError(f"unknown verify mode {mode!r}")


# ---------------------------------------------------------------------------
# Frontier merge: keep the k smallest of (frontier ++ batch) per query
# ---------------------------------------------------------------------------

def merge_topk_numpy(all_d: np.ndarray, all_i: np.ndarray, k: int):
    """(Qa, M) -> (Qa, k); ties broken by smaller dataset index, matching
    a stable argsort of the full distance array."""
    n_big = np.int64(np.iinfo(np.int64).max)
    tie = np.where(all_i < 0, n_big, all_i)
    out_d = np.empty((all_d.shape[0], k), all_d.dtype)
    out_i = np.empty((all_i.shape[0], k), np.int64)
    for r in range(all_d.shape[0]):
        sel = np.lexsort((tie[r], all_d[r]))[:k]
        out_d[r] = all_d[r][sel]
        out_i[r] = all_i[r][sel]
    return out_d, out_i


def merge_topk_device(all_d: np.ndarray, all_i: np.ndarray, k: int, *,
                      device="cuda"):
    """Device merge with the host tie-break contract: a lexicographic
    sort on (distance, dataset index) as two stable sorts, id first, then
    distance — ties at exactly-equal distances resolve to the smaller
    dataset index, padding index -1 sorts last.  Runs in f32: the
    returned distances are the ones the sort saw, so distances distinct
    in f64 but equal in f32 count as ties."""
    d = torch.as_tensor(np.asarray(all_d), dtype=torch.float32).to(device)
    i = torch.as_tensor(np.asarray(all_i, np.int64)).to(device)
    tie = torch.where(i < 0, torch.iinfo(torch.int64).max, i)
    by_id = torch.sort(tie, dim=1, stable=True).indices
    by_d = torch.sort(torch.gather(d, 1, by_id), dim=1, stable=True).indices
    sel = torch.gather(by_id, 1, by_d)[:, :k]
    out_d, out_i = torch.gather(d, 1, sel), torch.gather(i, 1, sel)
    with span("wait"):                  # both copies block
        out_d, out_i = out_d.cpu(), out_i.cpu()
    return out_d.numpy(), out_i.numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# Core batched scan
# ---------------------------------------------------------------------------

def topk_verify(queries_raw, repr_dists, store: RawStore, *, k: int = 1,
                batch_size: int = 64, verifier: Callable = numpy_verifier,
                merge: Callable = merge_topk_numpy,
                init_d=None, init_i=None, col_ids=None,
                dist_fn: Optional[Callable] = None,
                on_verified: Optional[Callable] = None,
                stream=None, trace=None) -> TopKResult:
    """Exact top-k under d_ED for a query batch given lower-bounding
    representation distances (Q, N).  See the module docstring for the
    correctness argument.

    ``init_d`` / ``init_i``: optional (Q, <=k) already-verified frontier
    (sorted ascending, ties by index) to seed the best-k with.  Seeded
    candidates must carry +inf in ``repr_dists`` (or be absent).

    ``col_ids``: optional (N,) dataset row ids, one per ``repr_dists``
    column, STRICTLY INCREASING (column j means row ``col_ids[j]``;
    ``pruned_fraction`` is then relative to the candidate set).

    ``dist_fn``: optional device-resident verification hook:
    ``dist_fn(q_idx, cand) -> (Qa, B) true distances`` computed without
    fetching the store.  ``-1`` candidate entries are masked to +inf.

    ``on_verified``: optional ``on_verified(qi, ids, dists)`` callback
    fired once per verification round per active query.

    ``stream``: optional device-ordered candidate stream (``peek() ->
    (Q,) next unverified bound``, ``take(aq, batch) -> (len(aq), batch)
    global ids, -1-padded``, ``width``) replacing ``repr_dists``.

    ``trace``: optional ``repro_torch.obs.Trace``.  Every recording site
    is guarded by ``trace is None`` and records host copies after the
    round's computation, so a traced call launches the same kernels on
    the same inputs as an untraced one and returns the same result."""
    qs = np.asarray(queries_raw)        # native dtype: the host verifier
    if qs.ndim == 1:                    # stays bit-identical to brute force
        qs = qs[None]
    if stream is not None:
        if repr_dists is not None or col_ids is not None:
            raise ValueError("stream replaces the bound matrix and yields "
                             "global ids")
        rd = None
        q_n, n = qs.shape[0], int(stream.width)
    else:
        rd = np.asarray(repr_dists)
        if rd.ndim == 1:
            rd = rd[None]
        q_n, n = rd.shape
        if col_ids is not None:
            col_ids = np.asarray(col_ids, np.int64)
            if col_ids.shape != (n,):
                raise ValueError(f"col_ids {col_ids.shape} vs {n} columns")

    init_w = 0
    if init_d is not None:
        init_d = np.asarray(init_d, np.float64)
        init_i = np.asarray(init_i, np.int64)
        if init_d.ndim == 1:
            init_d, init_i = init_d[None], init_i[None]
        init_w = init_d.shape[1]
    k = min(k, n + init_w)
    front_d = np.full((q_n, k), np.inf, np.float64)
    front_i = np.full((q_n, k), -1, np.int64)
    if init_w:
        m = min(k, init_w)
        front_d[:, :m] = init_d[:, :m]
        front_i[:, :m] = init_i[:, :m]
    if n == 0:                          # nothing to scan: seeded frontier
        return TopKResult(indices=front_i, distances=front_d,
                          raw_accesses=np.zeros(q_n, np.int64),
                          pruned_fraction=np.ones(q_n),
                          store_accesses=0, store_fetches=0, io_seconds=0.0)
    if stream is None:
        order = np.argsort(rd, axis=1, kind="stable")
        sorted_d = np.take_along_axis(rd, order, axis=1)
        # +inf bounds mark non-candidates: they must never enter a
        # verification batch, even as over-fetch
        n_fin = np.isfinite(rd).sum(axis=1)
    pos = np.zeros(q_n, np.int64)
    acc = np.zeros(q_n, np.int64)
    n_round = 0
    start_acc, start_fetch = store.accesses, store.fetches
    if trace is not None:                # candidates handed to this scan
        if stream is None:
            gen = n_fin.astype(np.int64)
            # the ids behind the accumulated count, so the engine can
            # report a deduplicated per-query "generated_unique"
            for qi in range(q_n):
                fin = np.nonzero(np.isfinite(rd[qi]))[0]
                trace.note_ids("generated", qi,
                               col_ids[fin] if col_ids is not None else fin)
        else:
            nf = getattr(stream, "n_finite", None)
            gen = (np.asarray(nf, np.int64) if nf is not None
                   else np.full(q_n, n, np.int64))
            # a stream never re-hands an id: its count is already unique
            trace.note_counts("generated", gen)
        trace.add("generated", gen)

    while True:
        # one pass: peek, take, K1, merge; the pass whose peek finds no
        # active query ends the scan and is no round
        with span("match.round", timed=trace is not None) as rnd:
            # >= (not >): a candidate whose bound ties the k-th best
            # verified distance may tie it in true distance too and then
            # win on the smaller dataset index — it must be verified, not
            # pruned
            if stream is None:
                nxt = sorted_d[np.arange(q_n), np.minimum(pos, n - 1)]
                active = ((pos < n) & np.isfinite(nxt)
                          & (front_d[:, -1] >= nxt))
            else:
                nxt = stream.peek()
                active = np.isfinite(nxt) & (front_d[:, -1] >= nxt)
            if not active.any():
                break
            aq = np.nonzero(active)[0]
            if stream is None:
                cand = np.full((len(aq), batch_size), -1, np.int64)
                for r, qi in enumerate(aq):
                    c = order[qi, pos[qi]:min(pos[qi] + batch_size,
                                              n_fin[qi])]
                    cand[r, :len(c)] = c
                if col_ids is not None:  # column -> dataset row translation
                    cand = np.where(cand >= 0, col_ids[cand], -1)
            else:                        # global ids straight off device
                cand = np.asarray(stream.take(aq, batch_size), np.int64)
            mask = cand >= 0
            n_round += 1
            if dist_fn is not None:      # device-resident: no host fetch
                d = np.asarray(dist_fn(aq, cand))
            else:
                ids = np.unique(cand[mask])          # sorted
                rows = store.fetch(ids)              # one physical fetch/round
                gather = np.searchsorted(ids, np.where(mask, cand, ids[0]))
                d = verifier(rows, qs[aq], gather)
            d = np.where(mask, d, np.inf)
            if on_verified is not None:
                for r, qi in enumerate(aq):
                    on_verified(int(qi), cand[r][mask[r]],
                                np.asarray(d[r][mask[r]], np.float64))

            new_d, new_i = merge(np.concatenate([front_d[aq], d], axis=1),
                                 np.concatenate([front_i[aq], cand], axis=1),
                                 k)
            front_d[aq] = new_d
            front_i[aq] = new_i
            n_real = mask.sum(axis=1)
            acc[aq] += n_real
            if stream is None:           # a stream advances its own cursor
                pos[aq] += n_real
        if trace is not None:            # round telemetry: the k-th-best
            trace.record_round(          # threshold after this merge
                phase="scan", active=int(len(aq)),
                examined=int(n_real.sum()), kth=front_d[aq, -1].copy(),
                wall_s=rnd.seconds)

    total = store.accesses - start_acc
    n_fetch = store.fetches - start_fetch
    io_s = store.modeled_io_seconds(total, n_fetch)
    if trace is not None:
        trace.add("examined", acc)
        trace.add("verified", acc)
        trace.add("rows_fetched", int(total))
        trace.add("seeks", int(n_fetch))
        trace.add("modeled_io_s", float(io_s))
    return TopKResult(indices=front_i, distances=front_d,
                      raw_accesses=acc,
                      pruned_fraction=1.0 - acc / n,
                      store_accesses=total, store_fetches=n_fetch,
                      io_seconds=io_s, rounds=n_round)


def verify_candidates(queries_raw, cand_idx, store: RawStore, *,
                      k: Optional[int] = None,
                      verifier: Callable = numpy_verifier,
                      merge: Callable = merge_topk_numpy,
                      dist_fn: Optional[Callable] = None,
                      on_verified: Optional[Callable] = None,
                      trace=None, trace_phase: str = "seed") -> TopKResult:
    """Approximate top-k: verify an externally supplied candidate set and
    rank by true d_ED.  cand_idx: (Q, C) dataset rows; -1 entries are
    padding.  ``dist_fn`` / ``on_verified``: same contracts as
    :func:`topk_verify`.  ``trace`` records this call as one
    verification round labelled ``trace_phase`` ("seed" for the tree
    seed walk, "approx" for the approximate path)."""
    qs = np.asarray(queries_raw)
    if qs.ndim == 1:
        qs = qs[None]
    cand = np.asarray(cand_idx, np.int64)
    if cand.ndim == 1:
        cand = cand[None]
    q_n, c = cand.shape
    k = c if k is None else min(k, c)
    n = getattr(store, "n", None)
    if n is None:
        n = store.data.shape[0]
    with span("match.round", timed=trace is not None) as rnd:
        mask = cand >= 0
        ids = np.unique(cand[mask])
        if ids.size == 0:
            return TopKResult(indices=np.full((q_n, k), -1, np.int64),
                              distances=np.full((q_n, k), np.inf),
                              raw_accesses=np.zeros(q_n, np.int64),
                              pruned_fraction=np.ones(q_n),
                              store_accesses=0, store_fetches=0,
                              io_seconds=0.0)
        start_acc, start_fetch = store.accesses, store.fetches
        if dist_fn is not None:                  # device-resident path
            d = np.asarray(dist_fn(np.arange(q_n), cand))
        else:
            rows = store.fetch(ids)              # one batched fetch
            gather = np.searchsorted(ids, np.where(mask, cand, ids[0]))
            d = verifier(rows, qs, gather)
        d = np.where(mask, d, np.inf)
        if on_verified is not None:
            for r in range(q_n):
                on_verified(r, cand[r][mask[r]],
                            np.asarray(d[r][mask[r]], np.float64))
        out_d, out_i = merge(d, cand, k)
    total = store.accesses - start_acc
    n_fetch = store.fetches - start_fetch
    acc = mask.sum(axis=1)
    io_s = store.modeled_io_seconds(total, n_fetch)
    if trace is not None:
        trace.add("generated", acc.astype(np.int64))
        for r in range(q_n):
            trace.note_ids("generated", r, cand[r][mask[r]])
        trace.add("examined", acc.astype(np.int64))
        trace.add("verified", acc.astype(np.int64))
        trace.add("rows_fetched", int(total))
        trace.add("seeks", int(n_fetch))
        trace.add("modeled_io_s", float(io_s))
        trace.record_round(phase=trace_phase, active=q_n,
                           examined=int(acc.sum()),
                           kth=out_d[:, -1].copy(),
                           wall_s=rnd.seconds)
    return TopKResult(indices=out_i, distances=out_d, raw_accesses=acc,
                      pruned_fraction=1.0 - acc / n,
                      store_accesses=total, store_fetches=n_fetch,
                      io_seconds=io_s, rounds=1)


# ---------------------------------------------------------------------------
# Engine
# ---------------------------------------------------------------------------

def _to_device(rep, device):
    if isinstance(rep, tuple):
        return tuple(_to_device(r, device) for r in rep)
    return torch.as_tensor(rep).to(device)


def _to_numpy(x) -> np.ndarray:
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class DeviceRepCache:
    """Device-resident copy of a live representation — anything with the
    ``rep_view()`` + ``version`` protocol — refreshed only when the
    version changes, so appends are served without a host->device
    transfer per query."""

    def __init__(self, store, device):
        self._store = store
        self._device = device
        self._val = None
        self._version = -1

    def get(self):
        if self._version != self._store.version:
            self._val = _to_device(self._store.rep_view(), self._device)
            self._version = self._store.version
        return self._val


class MatchEngine:
    """Batched multi-query top-k matcher over one encoder + store.

    Parameters
    ----------
    encoder:    SAX / SSAX / TSAX / STSAX instance.
    store:      a ``RawStore`` over the (N, T) raw dataset (the engine
                pays a one-shot encode on ``device`` at construction), or
                a store with the ``rep_view()`` + ``version`` protocol
                that owns its live representation.
    batch_size: verification batch per query per round.
    verify:     "auto" (K1 kernel on a CUDA device, numpy host on the
                CPU), "kernel" / "host" (always K1 on ``device``; "host"
                is the host-side twin of the device-resident route),
                "numpy" (bit-identical to a host brute-force scan), or
                "device" (device-resident verification: raw rows never
                move to the host; requires ``dist_factory``, wired by
                ``core.distributed.make_engine_service``; bitwise equal
                to "host").
    pairwise:   representation sweep ``(rq, rx) -> (Q, N)``; defaults to
                the encoder's plain ``pairwise_distance``.
                ``kernels.ops.make_pairwise`` gives the K2/K3 sweep.
    rep:        precomputed dataset representation (skips encode), e.g.
                ``core.techniques.rep_from_numpy`` of the reference's.
    repr_fn:    override for representation distances
                (queries_raw -> (Q, N)).
    cand_fn:    override for approximate candidates
                (queries_raw, k -> (Q, k) indices).
    stream_factory: override producing a device-ordered candidate
                stream for exact top-k (queries_raw ->
                ``core.distributed.DeviceOrderedStream``); the linear
                sweep and the index source then feed ``topk_verify``
                through it, and the (Q, N) bound matrix never reaches
                the host.  Wired by ``make_engine_service``.
    device:     where encode, sweep and kernel verification run.  The
                default is the CUDA card, and construction raises when
                there is none; pass ``device="cpu"`` to run on the CPU.
    metrics:    optional ``repro_torch.obs.MetricsRegistry``: per-call
                counters and a latency histogram, recorded after the
                result exists; None (the default) records nothing.

    Candidate sources: exact ``topk`` consumes candidates from a
    ``repro_torch.index.candidates.CandidateSource``.  The default is the
    linear lower-bound sweep; ``source="index"`` generates them from the
    backing store's split-tree index (``store.build_index()``) with
    bit-identical results.
    """

    def __init__(self, encoder, store, *, batch_size: int = 64,
                 verify: str = "auto", pairwise: Callable | None = None,
                 rep=None, repr_fn: Callable | None = None,
                 cand_fn: Callable | None = None,
                 device_merge: bool = False,
                 dist_factory: Callable | None = None,
                 stream_factory: Callable | None = None,
                 metrics=None, device="cuda"):
        self.device = resolve_device(device)
        self.encoder = encoder
        self.store = store
        self.batch_size = batch_size
        self.verify_mode = verify
        self.metrics = metrics
        self.device_verify = verify == "device"
        if self.device_verify and dist_factory is None:
            raise ValueError(
                'verify="device" needs a dist_factory (device-resident '
                "sharded verification; build the engine through "
                "core.distributed.make_engine_service)")
        self._dist_factory = dist_factory
        # the device path's host twin is the kernel verifier: same f32
        # distance definition, so "device" and "host" are bit-identical
        self.verifier = make_verifier("kernel" if self.device_verify
                                      else verify, self.device)
        self.merge = (functools.partial(merge_topk_device,
                                        device=self.device)
                      if device_merge or self.device_verify
                      else merge_topk_numpy)
        self._pw = pairwise or encoder.pairwise_distance
        self._repr_fn = repr_fn
        self._cand_fn = cand_fn
        self._stream_factory = stream_factory
        self._sym = store if hasattr(store, "rep_view") else None
        if self._sym is not None and self._sym.encoder != encoder:
            raise ValueError("the store was built for a different "
                             "encoder configuration than this engine's")
        self._rep_cache = (DeviceRepCache(self._sym, self.device)
                           if self._sym is not None else None)
        if rep is not None:
            self._rep = _to_device(rep, self.device)
        elif repr_fn is not None or self._sym is not None:
            self._rep = None             # live view, refreshed on append
        else:
            x = torch.as_tensor(np.asarray(store.data), dtype=torch.float32)
            self._rep = encoder.encode(x.to(self.device))

    @property
    def rep(self):
        """Dataset representation on the engine's device."""
        if self._rep is not None:
            return self._rep
        if self._rep_cache is None:
            return None
        return self._rep_cache.get()

    def append(self, rows) -> np.ndarray:
        """Ingest rows into the backing ``SymbolicStore`` (incremental
        encode; an attached index is maintained); they are matchable on
        the next ``topk`` call."""
        if self._sym is None:
            raise TypeError("append() needs a SymbolicStore-backed engine; "
                            "this one wraps a static RawStore")
        return self._sym.append(rows)

    # -- representation sweep -------------------------------------------
    def encode_queries(self, queries_raw):
        q = torch.as_tensor(np.asarray(queries_raw), dtype=torch.float32)
        return self.encoder.encode(q.to(self.device))

    def repr_distances(self, queries_raw) -> np.ndarray:
        """(Q, N) lower-bounding representation distances."""
        if self._repr_fn is not None:
            return _to_numpy(self._repr_fn(queries_raw))
        return _to_numpy(self._pw(self.encode_queries(queries_raw),
                                  self.rep))

    def candidates(self, queries_raw, k: int) -> np.ndarray:
        """(Q, k) approximate candidates by representation distance."""
        if self._cand_fn is not None:
            return _to_numpy(self._cand_fn(queries_raw, k))
        rd = self.repr_distances(queries_raw)
        k = min(k, rd.shape[1])
        if k == 0:
            return np.empty((rd.shape[0], 0), np.int64)
        part = np.argpartition(rd, k - 1, axis=1)[:, :k]
        part_d = np.take_along_axis(rd, part, axis=1)
        return np.take_along_axis(part, np.argsort(part_d, axis=1,
                                                   kind="stable"), axis=1)

    def index_source(self, epoch=None):
        """The backing store's split-tree index as a candidate source."""
        idx = getattr(self.store, "index", None)
        if idx is None:
            raise ValueError("store has no index; call "
                             "store.build_index() first")
        return idx.source(device_order=self._stream_factory is not None,
                          epoch=epoch)

    # -- matching --------------------------------------------------------
    def topk(self, queries_raw, k: int = 1, *, exact: bool = True,
             batch_size: Optional[int] = None, expand: int = 4,
             source=None, trace=None, explain: bool = False,
             epoch=None) -> TopKResult:
        """Top-k matches for a (Q, T) query batch (or a single (T,) query).

        exact=True:  pruned scan, provably identical to brute force.
                     ``source`` picks the candidate generator: None for
                     the linear lower-bound sweep, "index" for the
                     store's index, or any ``CandidateSource``.
        exact=False: verify the top ``k * expand`` representation
                     candidates only (the paper's approximate matching,
                     generalized to k-NN); ``source`` is ignored.

        epoch: pin the answer to a published corpus frontier (an object
        with ``n_rows``, or a plain row count): only rows with id below
        it are generated, verified or returned.

        trace / explain: ``trace`` records a per-query
        ``repro_torch.obs.Trace`` into the given object; ``explain=True``
        creates one and attaches it to the result as ``res.trace``
        (render with ``repro_torch.obs.render_trace``).  A traced call
        launches the same kernels on the same inputs as an untraced one
        and returns the same result.

        Program spans (``match.topk``, ``match.sweep``, ``match.round``
        and its ``wait``s; ``repro_torch.obs.trace``) go to the calling
        thread's recorder, which a ``MatchSession`` dispatch sets (or a
        caller, through ``repro_torch.obs.recording``); the engine sets
        none, so its own registry keeps the JAX package's metric names.
        """
        qs = np.asarray(queries_raw)
        if qs.ndim == 1:
            qs = qs[None]
        if explain and trace is None:
            from repro_torch.obs import Trace
            trace = Trace("match.topk")
        observing = trace is not None or self.metrics is not None
        sweep = getattr(self, "sweep", None)
        hob0 = sweep.host_order_bytes if sweep is not None else 0
        h2d0 = sweep.h2d_bytes if sweep is not None else 0
        with span("match.topk", count="match.rounds",
                  timed=observing) as call:
            res, total = self._topk(qs, k, exact=exact,
                                    batch_size=batch_size, expand=expand,
                                    source=source, trace=trace, epoch=epoch)
            if call is not None:
                call.n = res.rounds
        if observing:
            self._observe(trace, res, sweep, total, qs.shape[0],
                          call.seconds, hob0, h2d0)
        if trace is not None:
            res.trace = trace
        return res

    def _topk(self, qs, k, *, exact, batch_size, expand, source, trace,
              epoch):
        """The body of :meth:`topk`: (result, rows the call covers)."""
        from repro_torch.store.symbolic import epoch_rows
        total = getattr(self.store, "n", None)
        if total is None:
            total = self.store.data.shape[0]
        n_e = epoch_rows(epoch)
        if n_e is not None:
            total = min(total, n_e)
        if trace is not None:
            approx_src = bool(getattr(source, "is_approx", False))
            src_name = ("index" if source == "index" else
                        "linear" if source is None else
                        "index-approx" if approx_src else
                        type(source).__name__)
            trace.meta.update(engine="match", k=int(k),
                              exact=bool(exact) and not approx_src,
                              q_n=int(qs.shape[0]), total=int(total),
                              source=src_name, verify=self.verify_mode)
            if n_e is not None:
                trace.meta["epoch_rows"] = int(n_e)
        dfn = self._make_dist_fn(qs)
        if exact:
            from repro_torch.index.candidates import (
                LinearSweep, topk_from_source)
            if source is None:
                if n_e is None:
                    source = LinearSweep(self.repr_distances,
                                         stream_fn=self._stream_factory)
                else:
                    # epoch-clamped linear sweep: the stream masks rows
                    # past the frontier to +inf on the device; the host
                    # matrix path trims columns to the epoch prefix
                    stream_fn = None
                    if self._stream_factory is not None:
                        def stream_fn(q, _n=n_e):
                            return self._stream_factory(
                                q, mask_fn=lambda ids: ids >= _n)
                    source = LinearSweep(
                        lambda q, _n=n_e: self.repr_distances(q)[:, :_n],
                        stream_fn=stream_fn)
            elif source == "index":
                source = self.index_source(epoch=n_e)
            res = topk_from_source(
                qs, source, self.store, k=k,
                batch_size=batch_size or self.batch_size,
                verifier=self.verifier, merge=self.merge, total=total,
                dist_fn=dfn, trace=trace)
        else:
            with maybe_span(trace, "order"), span("match.sweep"):
                cand = self.candidates(qs, k * max(expand, 1))
                if n_e is not None:
                    # epoch filter on the approximate frontier: rows past
                    # the pinned frontier are dropped (-1 padding),
                    # never returned
                    cand = np.where(cand < n_e, cand, -1)
            with maybe_span(trace, "verify"):
                res = verify_candidates(
                    qs, cand, self.store, k=k, verifier=self.verifier,
                    merge=self.merge, dist_fn=dfn, trace=trace,
                    trace_phase="approx")
        return res, total

    def topk_approx(self, queries_raw, k: int = 1, *,
                    collect: Optional[int] = None, trace=None,
                    explain: bool = False, epoch=None) -> TopKResult:
        """Anytime/approximate top-k with a per-query error bar.

        When the backing store carries a split-tree index, routes
        through ``TreeCandidates`` approximate mode: the exact seed walk
        runs in full, then the collect phase keeps only the ``collect``
        best-bound survivors (default ``max(4 * k, 32)``).  The result
        carries ``res.kth_lb`` (the k-th smallest of verified true
        distances and the dropped candidates' lower bounds — a certified
        lower bound on the true k-th-NN distance) and ``res.error_bar``
        (``d_k - kth_lb``, >= 0; zero proves the answer exact).  Without
        an index it falls back to the representation-top-k approximate
        path (``exact=False``), which carries no certificate."""
        idx = getattr(self.store, "index", None)
        if idx is None:
            return self.topk(queries_raw, k=k, exact=False, trace=trace,
                             explain=explain, epoch=epoch)
        src = idx.source(device_order=self._stream_factory is not None,
                         approx_collect=(collect if collect is not None
                                         else max(4 * k, 32)),
                         epoch=epoch)
        return self.topk(queries_raw, k=k, source=src, trace=trace,
                         explain=explain, epoch=epoch)

    def _observe(self, trace, res: TopKResult, sweep, total: int, q_n: int,
                 wall_s: float, hob0: int, h2d0: int) -> None:
        """Post-call recording: transfer deltas of a sharded sweep,
        pruning power, deduplicated generated counts and registry
        metrics.  Runs only when a trace or a registry is attached and
        only after the result exists.  The metric names are the JAX
        package's."""
        hob = (sweep.host_order_bytes - hob0) if sweep is not None else None
        h2d = (sweep.h2d_bytes - h2d0) if sweep is not None else None
        # the device path never fetches the store; any store accesses
        # during a device-verified call are rows moved to the host
        rth = int(res.store_accesses) if self.device_verify else None
        if trace is not None:
            trace.set("wall_s", wall_s)
            trace.set("pruning_power", res.pruned_fraction.copy())
            gu = trace.unique_counts("generated", q_n)
            if gu is not None:
                trace.set("generated_unique", gu)
            if sweep is not None:
                trace.set("host_order_bytes", int(hob))
                trace.set("h2d_bytes", int(h2d))
            if rth is not None:
                trace.set("rows_to_host", rth)
        if self.metrics is not None:
            m = self.metrics
            m.counter("match.queries").inc(q_n)
            m.counter("match.candidates_verified").inc(
                int(res.raw_accesses.sum()))
            m.counter("match.rows_fetched").inc(int(res.store_accesses))
            m.counter("match.seeks").inc(int(res.store_fetches))
            m.counter("match.modeled_io_s").inc(float(res.io_seconds))
            m.gauge("match.pruning_power").set(
                float(res.pruned_fraction.mean()))
            m.histogram("match.topk_latency_s").observe(wall_s)
            if hob is not None:
                m.counter("match.host_order_bytes").inc(int(hob))
                m.counter("match.h2d_bytes").inc(int(h2d))
            if rth is not None:
                m.counter("match.rows_to_host").inc(rth)

    def _make_dist_fn(self, qs) -> Optional[Callable]:
        """Device-resident verification closure for this query batch
        (None outside verify="device")."""
        if not self.device_verify:
            return None
        return self._dist_factory(qs)

    def verify_candidates(self, queries_raw, cand_idx,
                          k: Optional[int] = None) -> TopKResult:
        """Rank an external candidate frontier by true d_ED (one batched
        raw fetch)."""
        qs = np.asarray(queries_raw)
        if qs.ndim == 1:
            qs = qs[None]
        return verify_candidates(qs, cand_idx, self.store, k=k,
                                 verifier=self.verifier, merge=self.merge,
                                 dist_fn=self._make_dist_fn(qs))
