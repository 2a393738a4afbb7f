"""Exact matrix-profile self-join over a ``WindowView``.

Every window of the corpus is queried against the corpus's own window
set; the nearest neighbor OUTSIDE the trivial-match zone (same source
row, start samples closer than ``exclusion`` — the same non-overlap
predicate ``SubseqEngine._suppress`` applies between reported matches)
is found exactly through ``core.engine.topk_verify``:

* linear route — the (chunk, n_windows) lower-bound matrix on the host
  with the trivial zone masked to +inf before the k-th-best early-stop
  scan;
* indexed route — the split tree's seed/collect walk with the trivial
  zone handed over as the already-``seen`` id set (the exclusion-
  widening contract of ``repro_torch.index.candidates.TreeCandidates``);
* stream route — with a mesh, ``ShardedWindowSweep.candidate_stream``
  with a device ``mask_fn`` lifting trivial bounds to +inf BEFORE the
  device sort, so candidate order never touches the host; with
  ``verify="device"`` the candidate windows are cut, z-normalized and
  verified on the device too (``rows_to_host == 0``).

All routes verify through the same verifier (K1 on a card) and the same
(distance, window id) tie-break, so the profile — and therefore
``topk_motifs`` / ``topk_discords``, which are pure functions of it — is
bit-identical to the brute-force oracle ``scan_profile``.  The FFT
dot-product path (``kernels.fft_dot``) never feeds verification.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.engine import topk_verify
from repro_torch.obs.trace import maybe_span
from repro_torch.subseq.search import SubseqEngine
from repro_torch.subseq.windows import WindowView, znorm_windows


@dataclass
class MatrixProfile:
    """Per-window nearest non-trivial neighbor of a corpus self-join.

    ``neighbors[i] == -1`` / ``distances[i] == inf`` when window ``i``
    has no candidate outside its trivial zone (single short row)."""

    distances: np.ndarray        # (n,) f64 true z-normalized d_ED
    neighbors: np.ndarray        # (n,) int64 window id of the NN
    exclusion: int               # trivial-zone half-width in samples
    source: str                  # "linear" | "index" | "stream" | "scan"
    raw_accesses: np.ndarray     # (n,) windows verified per query window
    pruned_fraction: np.ndarray  # (n,) 1 - verified / n
    store_accesses: int          # deduplicated underlying-row reads
    store_fetches: int           # batched fetch rounds (modeled seeks)
    io_seconds: float            # modeled I/O incl. the query-side pass
    rounds: int = 0              # verification rounds (verifier calls)
    trace: object = field(default=None, repr=False)

    @property
    def n(self) -> int:
        return int(self.distances.shape[0])


def topk_motifs(profile: MatrixProfile, locate, k: int = 1):
    """Top-k motif pairs: the closest mutually non-trivial window pairs
    in ascending (distance, window id) order, greedily filtered so no
    selected window overlaps an already-selected one (same source row,
    starts closer than ``profile.exclusion``).  The mirror entry of a
    selected pair clashes with the pair itself, so each motif is
    reported once.

    Pure function of the profile (``locate`` is ``WindowView.locate``),
    so bit-identity of motifs reduces to bit-identity of profiles.
    Returns a list of ``(window_a, window_b, distance)`` tuples."""
    d, nb = profile.distances, profile.neighbors
    n = d.shape[0]
    rows, starts = locate(np.arange(n, dtype=np.int64))
    order = np.lexsort((np.arange(n), d))
    excl = profile.exclusion
    taken_rows, taken_starts = [], []

    def clash(wid) -> bool:
        r, s = rows[wid], starts[wid]
        return any(tr == r and abs(ts - s) < excl
                   for tr, ts in zip(taken_rows, taken_starts))

    out = []
    for a in order:
        b = nb[a]
        if b < 0 or not np.isfinite(d[a]):
            continue
        if clash(a) or clash(b):
            continue
        out.append((int(a), int(b), float(d[a])))
        for w in (a, b):
            taken_rows.append(rows[w])
            taken_starts.append(starts[w])
        if len(out) == k:
            break
    return out


def topk_discords(profile: MatrixProfile, locate, k: int = 1):
    """Top-k discords: windows whose nearest non-trivial neighbor is
    FARTHEST, in descending distance order (ties to the smaller window
    id), greedily filtered by the same non-overlap predicate as
    :func:`topk_motifs`.  Windows with no non-trivial candidate at all
    (distance +inf) are skipped.  Returns ``(window, distance)``
    tuples."""
    d = profile.distances
    n = d.shape[0]
    rows, starts = locate(np.arange(n, dtype=np.int64))
    order = np.lexsort((np.arange(n), -d))
    excl = profile.exclusion
    taken_rows, taken_starts = [], []
    out = []
    for w in order:
        if profile.neighbors[w] < 0 or not np.isfinite(d[w]):
            continue
        r, s = rows[w], starts[w]
        if any(tr == r and abs(ts - s) < excl
               for tr, ts in zip(taken_rows, taken_starts)):
            continue
        out.append((int(w), float(d[w])))
        taken_rows.append(r)
        taken_starts.append(s)
        if len(out) == k:
            break
    return out


class _ChunkTrace:
    """Per-chunk adapter handed to ``topk_verify`` in place of the real
    trace: ``Trace.add`` accumulates arrays ELEMENTWISE (same-shape
    contract), but self-join chunks have different query counts, so
    per-query vectors are collapsed to scalar totals before forwarding.
    The per-id layer (``note_ids`` / ``note_counts``) is dropped: its
    query axis is chunk-local too."""

    def __init__(self, parent):
        self._p = parent

    def add(self, key, value):
        if isinstance(value, np.ndarray):
            value = int(value.sum())
        self._p.add(key, value)

    def set(self, key, value):
        self._p.set(key, value)

    def get(self, key, default=None):
        return self._p.get(key, default)

    def note_ids(self, key, qi, ids):
        pass

    def note_counts(self, key, counts):
        pass

    def record_round(self, **fields):
        self._p.record_round(**fields)

    def span(self, name, **kw):
        return self._p.span(name, **kw)

    @property
    def meta(self):
        return self._p.meta


class SelfJoinEngine:
    """Exact matrix-profile self-join over a :class:`WindowView`.

    Parameters
    ----------
    view:       the window view (encoder + corpus) to self-join.
    batch_size: verification batch per query window per round.
    verify:     "auto" | "numpy" | "kernel" | "host" | "device" — the
                contract of :class:`SubseqEngine` (an inner engine
                supplies verifier, merge and the sharded sweep).
    pairwise:   representation sweep; ``kernels.ops.make_pairwise``
                gives the K2 / K3 sweep (default: the encoder's plain
                ``pairwise_distance``).
    mesh:       optional ``core.distributed.ShardMesh``: shards the
                window sweep and orders candidates on its device; with
                ``verify="device"`` verification stays there too.  Over
                a world mesh each rank masks the trivial zone of its own
                candidates before its sort, and every rank computes the
                same profile.
    exclusion:  trivial-zone half-width in SAMPLES (two windows of the
                same source row with |start - start'| < exclusion are
                trivial matches of each other).  Defaults to
                ``max(1, m // 4)``; must be >= 1 so a window never
                matches itself.
    chunk:      query windows per profile step (bounds the transient
                (chunk, n_windows) structures).
    metrics:    optional ``repro_torch.obs.MetricsRegistry``
                (``selfjoin.*``).
    """

    def __init__(self, view: WindowView, *, batch_size: int = 64,
                 verify: str = "auto", pairwise: Callable | None = None,
                 mesh=None, exclusion: Optional[int] = None,
                 chunk: int = 32, metrics=None):
        if exclusion is None:
            exclusion = max(1, view.m // 4)
        if exclusion < 1:
            raise ValueError(f"exclusion must be >= 1 (a window is "
                             f"always its own trivial match), got "
                             f"{exclusion}")
        self.view = view
        self.exclusion = int(exclusion)
        self.chunk = int(chunk)
        self.metrics = metrics
        # the inner engine supplies verifier / merge / sharded sweep /
        # device dist_fn — the one source of the verification semantics
        self._sub = SubseqEngine(view, batch_size=batch_size, verify=verify,
                                 pairwise=pairwise, mesh=mesh)
        self._cache = None               # (key, MatrixProfile)

    # -- delegated machinery ----------------------------------------------
    @property
    def verify_mode(self) -> str:
        return self._sub.verify_mode

    @property
    def verifier(self):
        return self._sub.verifier

    @property
    def merge(self):
        return self._sub.merge

    @property
    def _device(self) -> bool:
        return self._sub._device

    @property
    def _sweep(self):
        return self._sub._sweep

    # -- trivial-match geometry -------------------------------------------
    def trivial_ids(self, wid: int) -> np.ndarray:
        """Window ids in ``wid``'s trivial zone (same source row,
        |start - start'| < exclusion), ``wid`` itself included."""
        nw = self.view.windows_per_row
        stride = self.view.stride
        r, j0 = int(wid) // nw, int(wid) % nw
        half = (self.exclusion - 1) // stride
        lo, hi = max(0, j0 - half), min(nw - 1, j0 + half)
        return np.arange(r * nw + lo, r * nw + hi + 1, dtype=np.int64)

    def _mask_fn(self, wids: np.ndarray):
        """Device mask closure for ``candidate_stream``: the (n,) natural
        window ids -> (Q, n) True where the candidate is a trivial match
        of one of the chunk's query windows, from id arithmetic on the
        sweep's device (the ids never come to the host)."""
        nw = self.view.windows_per_row
        stride = self.view.stride
        excl = self.exclusion
        w = torch.as_tensor(np.asarray(wids, np.int64),
                            device=self._sweep.device)
        q_r = (w // nw)[:, None]
        q_j = (w % nw)[:, None]

        def mask(ids):
            same = (ids[None, :] // nw) == q_r
            near = (ids[None, :] % nw - q_j).abs() * stride < excl
            return same & near

        return mask

    def _query_windows(self, wids: np.ndarray) -> np.ndarray:
        """Z-normalized query windows cut straight from the host source
        array — NOT through ``view.fetch``: the query side of the
        self-join is one streaming pass over the corpus, billed once in
        :meth:`profile` (billing fetches here would double-count rows
        and break the device route's ``rows_to_host == 0``).  They are
        normalized by ``znorm_windows``, the definition every route's
        candidate windows share, so a window has the same bits on both
        sides of a pair."""
        nw, stride, m = (self.view.windows_per_row, self.view.stride,
                         self.view.m)
        rows = wids // nw
        starts = (wids % nw) * stride
        data = self.view.source.data
        w = data[rows[:, None],
                 starts[:, None] + np.arange(m, dtype=np.int64)[None, :]]
        return znorm_windows(np.asarray(w, np.float32))

    # -- profile -----------------------------------------------------------
    def profile(self, *, use_index: object = "auto",
                batch_size: Optional[int] = None, trace=None,
                explain: bool = False,
                refresh: bool = False) -> MatrixProfile:
        """The full matrix profile — nearest non-trivial neighbor (true
        z-normalized d_ED, (distance, window id) tie-break) of every
        window.  Cached per (corpus version, exclusion, source, verify);
        any append invalidates it.  ``use_index`` follows
        ``SubseqEngine``: "auto" uses ``view.index`` when built, True
        requires it, False forces the linear sweep (the device stream
        when a mesh was given)."""
        if explain and trace is None:
            from repro_torch.obs import Trace
            trace = Trace("selfjoin.profile")
        idx = self.view.index if use_index in ("auto", True) else None
        if use_index is True and idx is None:
            raise ValueError("use_index=True but the view has no index; "
                             "call view.build_index() first")
        if idx is not None and idx.n != self.view.n:
            raise ValueError(f"window index covers {idx.n} of "
                             f"{self.view.n} windows; call view.sync()")
        source = ("index" if idx is not None
                  else "stream" if self._sweep is not None else "linear")
        key = (self.view.version, self.exclusion, source,
               self.verify_mode)
        # a cache hit is free — only a trace request (EXPLAIN measures
        # the real run) or an explicit refresh recomputes; metrics record
        # computed profiles, not cache reads
        if (not refresh and trace is None
                and self._cache is not None and self._cache[0] == key):
            return self._cache[1]
        observing = trace is not None or self.metrics is not None
        t0 = time.perf_counter()
        rows0 = self.view.accesses
        hob0 = self._sweep.host_order_bytes if self._sweep is not None \
            else 0
        h2d0 = self._sweep.h2d_bytes if self._sweep is not None else 0
        prof = self._profile(idx, source,
                             batch_size or self._sub.batch_size, trace)
        if observing:
            self._observe(trace, prof, time.perf_counter() - t0,
                          self.view.accesses - rows0, hob0, h2d0)
        if trace is not None:
            prof.trace = trace
        self._cache = (key, prof)
        return prof

    def _profile(self, idx, source: str, bs: int, trace) -> MatrixProfile:
        view = self.view
        n, n_rows = view.n, view.n_rows
        dist = np.full(n, np.inf, np.float64)
        nbr = np.full(n, -1, np.int64)
        raw = np.zeros(n, np.int64)
        acc = {"rows": 0, "fetches": 0, "io": 0.0, "rounds": 0}
        dfn_maker = self._sweep.make_dist_fn if self._device else None
        ct = _ChunkTrace(trace) if trace is not None else None
        for c0 in range(0, n, self.chunk):
            wids = np.arange(c0, min(c0 + self.chunk, n), dtype=np.int64)
            zq = self._query_windows(wids)
            dfn = dfn_maker(zq) if dfn_maker is not None else None
            if idx is not None:
                res = self._chunk_indexed(idx, zq, wids, bs, dfn, ct)
            elif self._sweep is not None:
                res = self._chunk_stream(zq, wids, bs, dfn, ct, trace)
            else:
                res = self._chunk_linear(zq, wids, bs, dfn, ct, trace)
            dist[wids] = res.distances[:, 0]
            nbr[wids] = res.indices[:, 0]
            raw[wids] = res.raw_accesses
            acc["rows"] += res.store_accesses
            acc["fetches"] += res.store_fetches
            acc["io"] += res.io_seconds
            acc["rounds"] += res.rounds
        # the query side reads every corpus row once — one modeled
        # streaming pass, accounted explicitly (the windows were cut from
        # the host array, not fetched)
        acc["rows"] += n_rows
        acc["fetches"] += 1
        acc["io"] += view.modeled_io_seconds(n_rows, 1)
        return MatrixProfile(
            distances=dist, neighbors=nbr, exclusion=self.exclusion,
            source=source, raw_accesses=raw,
            pruned_fraction=1.0 - raw / max(n, 1),
            store_accesses=acc["rows"], store_fetches=acc["fetches"],
            io_seconds=acc["io"], rounds=acc["rounds"])

    def _chunk_linear(self, zq, wids, bs, dfn, ct, trace):
        """Host lower-bound matrix with the trivial zone masked to +inf
        before the early-stop scan (a masked column can never be
        generated, fetched, or verified)."""
        with maybe_span(trace, "order"):
            rd = np.array(self._sub.repr_distances(zq))
        for i, w in enumerate(wids):
            rd[i, self.trivial_ids(w)] = np.inf
        with maybe_span(trace, "verify"):
            return topk_verify(zq, rd, self.view, k=1, batch_size=bs,
                               verifier=self.verifier, merge=self.merge,
                               dist_fn=dfn, trace=ct)

    def _chunk_stream(self, zq, wids, bs, dfn, ct, trace):
        """Device-ordered candidate stream with the trivial zone lifted
        to +inf ON THE DEVICE before the sort — candidate order never
        touches the host."""
        with maybe_span(trace, "order") as sp:
            stream = self._sweep.candidate_stream(
                zq, mask_fn=self._mask_fn(wids))
            if trace is not None:
                from repro_torch.obs.trace import block_until_ready
                block_until_ready((stream._b, stream._i))
                sp.meta["stream"] = True
        with maybe_span(trace, "verify"):
            return topk_verify(zq, None, self.view, k=1, batch_size=bs,
                               verifier=self.verifier, merge=self.merge,
                               dist_fn=dfn, stream=stream, trace=ct)

    def _chunk_indexed(self, idx, zq, wids, bs, dfn, ct):
        """Split-tree candidates with the trivial zone handed over as
        the already-``seen`` id set: seeds and collects skip seen ids,
        and the empty (C, 1) +inf/-1 prior frontier keeps the scan
        exact — how ``SubseqEngine`` widens under suppression, minus the
        widening (k = 1 needs one pass).  ``topk_from_source`` makes its
        own order / verify spans."""
        c = zq.shape[0]
        prior_d = np.full((c, 1), np.inf, np.float64)
        prior_i = np.full((c, 1), -1, np.int64)
        seen = [self.trivial_ids(w) for w in wids]
        return idx.topk(zq, self.view, k=1, batch_size=bs,
                        verifier=self.verifier, merge=self.merge,
                        dist_fn=dfn, prior_d=prior_d, prior_i=prior_i,
                        seen=seen, trace=ct)

    # -- motifs / discords -------------------------------------------------
    def topk_motifs(self, k: int = 1, **profile_kw):
        """Top-k non-overlapping motif pairs (see :func:`topk_motifs`);
        computes (or reuses) the cached profile."""
        return topk_motifs(self.profile(**profile_kw), self.view.locate, k)

    def topk_discords(self, k: int = 1, **profile_kw):
        """Top-k non-overlapping discords (see :func:`topk_discords`)."""
        return topk_discords(self.profile(**profile_kw), self.view.locate,
                             k)

    # -- brute-force oracle ------------------------------------------------
    def scan_profile(self, chunk_bytes: float = 2.5e8) -> MatrixProfile:
        """Brute-force matrix profile: every pairwise window distance
        through THE SAME verifier as the engine routes (K1 on a card,
        so bit-identity is a property of the candidate machinery, not of
        floating-point luck), trivial zone masked to +inf, nearest
        neighbor by the (distance, window id) tie-break (``np.argmin``
        returns the first — smallest-id — minimum).  Modeled I/O is one
        streaming pass over the corpus."""
        view = self.view
        n, n_rows = view.n, view.n_rows
        W = np.concatenate(list(view._window_chunks(0, n_rows)), axis=0)
        dist = np.full(n, np.inf, np.float64)
        nbr = np.full(n, -1, np.int64)
        ids = np.arange(n, dtype=np.int64)
        blk = max(1, int(chunk_bytes / (8 * max(n, 1))))
        for c0 in range(0, n, blk):
            wids = ids[c0:c0 + blk]
            gather = np.broadcast_to(ids[None, :],
                                     (wids.shape[0], n)).copy()
            d = np.array(self.verifier(W, W[wids], gather), np.float64)
            for i, w in enumerate(wids):
                d[i, self.trivial_ids(w)] = np.inf
            j = np.argmin(d, axis=1)
            best = d[np.arange(wids.shape[0]), j]
            fin = np.isfinite(best)
            dist[wids[fin]] = best[fin]
            nbr[wids[fin]] = j[fin]
        return MatrixProfile(
            distances=dist, neighbors=nbr, exclusion=self.exclusion,
            source="scan", raw_accesses=np.full(n, n, np.int64),
            pruned_fraction=np.zeros(n),
            store_accesses=n_rows, store_fetches=1,
            io_seconds=view.modeled_io_seconds(n_rows, 1))

    # -- observability -----------------------------------------------------
    def _observe(self, trace, prof: MatrixProfile, wall_s: float,
                 rows_delta: int, hob0: int, h2d0: int) -> None:
        rth = int(rows_delta) if self._device else None
        hob = h2d = None
        if self._sweep is not None:
            hob = int(self._sweep.host_order_bytes - hob0)
            h2d = int(self._sweep.h2d_bytes - h2d0)
        if trace is not None:
            trace.meta.update(engine="selfjoin", n=prof.n,
                              exclusion=self.exclusion,
                              source=prof.source,
                              verify=self.verify_mode)
            trace.set("wall_s", wall_s)
            trace.set("pruning_power", float(prof.pruned_fraction.mean()))
            if hob is not None:
                trace.set("host_order_bytes", hob)
                trace.set("h2d_bytes", h2d)
            if rth is not None:
                trace.set("rows_to_host", rth)
        if self.metrics is not None:
            m = self.metrics
            m.counter("selfjoin.queries").inc(prof.n)
            m.counter("selfjoin.windows_verified").inc(
                int(prof.raw_accesses.sum()))
            m.counter("selfjoin.rows_fetched").inc(
                int(prof.store_accesses))
            m.counter("selfjoin.seeks").inc(int(prof.store_fetches))
            m.counter("selfjoin.modeled_io_s").inc(float(prof.io_seconds))
            m.gauge("selfjoin.pruning_power").set(
                float(prof.pruned_fraction.mean()))
            m.histogram("selfjoin.profile_latency_s").observe(wall_s)
            if hob is not None:
                m.counter("selfjoin.host_order_bytes").inc(hob)
                m.counter("selfjoin.h2d_bytes").inc(h2d)
            if rth is not None:
                m.counter("selfjoin.rows_to_host").inc(rth)
