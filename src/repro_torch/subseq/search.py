"""``SubseqEngine``: batched exact top-k subsequence matching.

Answers "find the k best-matching windows of length m anywhere in the
corpus" for a (Q, m) query batch by routing window candidates through the
whole-matching frontier machinery (``core.engine.topk_verify``):

1. queries are z-normalized and encoded with the view's encoder;
2. the (Q, n_windows) representation-distance matrix against the live
   window representation is the lower-bounding candidate order (on a
   card the sweep goes through the engine's ``pairwise=`` hook, K2 / K3
   with ``kernels.ops.make_pairwise``);
3. ``topk_verify`` visits windows in that order with the k-th-best
   lower-bound early stop, fetching candidate windows through the
   ``WindowView`` — which bills deduplicated *underlying rows* to the
   ``RawStore`` I/O cost model — and verifying true z-normalized d_ED
   (through K1 on a card, numpy on the CPU with ``verify="auto"``).

Because every representation distance lower-bounds the true z-normalized
window distance, the result is bit-identical to a brute-force windowed
scan that z-normalizes windows the same way (``znorm_windows``) and
distances them with the same verifier.

Candidate generation is linear (the (Q, n_windows) sweep) or — when the
view carries a split-tree index (``view.build_index()``) — sublinear
through ``repro_torch.index``: the tree's seed/collect walk hands
``topk_verify`` a compact candidate set instead of all N*S windows, with
bit-identical results (same verifier, same tie-break).

Non-overlap suppression: with ``exclusion > 0``, windows that overlap an
already-selected better match (same source row, |start - start'| <
exclusion samples) are suppressed.  Selection stays exact: candidates
are taken greedily in the verified (distance, window id) order, and the
frontier is widened until k non-overlapping survivors exist or the
window set is exhausted.  Widening reuses the verified frontier on both
candidate paths: every (window id, true distance) pair ever verified is
accumulated, the next round is seeded with the best of them and
excludes the rest, so no window id is ever fetched or verified twice.

Observability: ``trace=`` / ``explain=True`` record a per-query
``repro_torch.obs`` trace (spans ``order`` and ``verify``, rounds,
candidate and I/O counts) and ``metrics=`` a ``MetricsRegistry``'s
``subseq.*`` counters, gauge and latency histogram; every recording
site sits behind ``trace is None`` / ``metrics is None``, so an
unobserved call runs exactly as before and an observed one returns the
same result.

``scan_topk`` is the brute-force baseline: the full distance profile
through the K5 windowed kernel (its plain version for a CPU view).

Sharded sweep and device verification: with ``mesh=`` (a
``core.distributed.ShardMesh``) the window sweep runs over round-robin
device mirrors (``core.distributed.ShardedWindowSweep``) and the exact
linear path without suppression orders candidates on the device, so the
(Q, n_windows) bound matrix never reaches the host; ``verify="device"``
(which needs the mesh) cuts, z-normalizes and verifies the candidate
windows on the device, moving no source row to the host, bitwise equal
to ``verify="host"``.  A world mesh (``make_mesh(S, device, group=)``)
spreads the mirrors over the ranks, one card each; every rank builds the
same view and engine and makes the same calls, and the answers are the
single process's at the same S, bitwise.
"""

from __future__ import annotations

import functools
import time
from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.engine import (
    DeviceRepCache, make_verifier, merge_topk_device, merge_topk_numpy,
    topk_verify)
from repro_torch.kernels import ops
from repro_torch.obs.trace import maybe_span
from repro_torch.store.symbolic import epoch_rows
from repro_torch.subseq.windows import WindowView, znorm_windows


def _accumulate(acc: dict, res) -> None:
    """Add one widening round's store accounting and rounds to ``acc``."""
    acc["rows"] += res.store_accesses
    acc["fetches"] += res.store_fetches
    acc["io"] += res.io_seconds
    acc["rounds"] += res.rounds


class _VerifiedSet:
    """Per-query accumulator of every (window id, true distance) pair
    verified across exclusion-widening rounds — the source of the next
    round's seeded frontier, and the structure that makes 'no window id
    is ever verified twice' hold across rounds: the best ``k`` verified
    pairs are seeded, ALL verified ids are excluded from the next
    round's candidates, and an excluded-but-unseeded id is dominated by
    >= k verified better ids so it can never re-enter the top-k."""

    def __init__(self, q_n: int):
        self._maps = [dict() for _ in range(q_n)]     # id -> distance

    def add(self, qi: int, ids, dists):
        m = self._maps[qi]
        for i, d in zip(ids.tolist(), dists.tolist()):
            m[int(i)] = float(d)

    def ids(self, qi: int) -> np.ndarray:
        m = self._maps[qi]
        return np.fromiter(m.keys(), np.int64, len(m))

    def empty(self) -> bool:
        return all(not m for m in self._maps)

    def frontier(self, k: int):
        """Best min(k, verified) pairs per query in (distance, id)
        order — the ``init_d`` / ``init_i`` seed of the next round."""
        if self.empty():
            return None, None
        q_n = len(self._maps)
        out_d = np.full((q_n, k), np.inf, np.float64)
        out_i = np.full((q_n, k), -1, np.int64)
        for qi, m in enumerate(self._maps):
            if not m:
                continue
            ids = np.fromiter(m.keys(), np.int64, len(m))
            ds = np.fromiter(m.values(), np.float64, len(m))
            sel = np.lexsort((ids, ds))[:k]
            out_d[qi, :len(sel)] = ds[sel]
            out_i[qi, :len(sel)] = ids[sel]
        return out_d, out_i


@dataclass
class SubseqResult:
    """Batched top-k window matches.  Rows padded with id/row/start -1 and
    distance inf when fewer than k (non-overlapping) windows exist."""

    window_ids: np.ndarray       # (Q, k) int64 dense window ids
    rows: np.ndarray             # (Q, k) source row of each match
    starts: np.ndarray           # (Q, k) start sample of each match
    distances: np.ndarray        # (Q, k) true z-normalized d_ED
    raw_accesses: np.ndarray     # (Q,) windows verified per query
    pruned_fraction: np.ndarray  # (Q,) 1 - verified / n_windows
    store_accesses: int          # deduplicated underlying-row reads
    store_fetches: int           # fetch rounds that read a cold row
    io_seconds: float            # modeled I/O of the underlying reads
    rounds: int = 0              # verification rounds (verifier calls)


class SubseqEngine:
    """Batched multi-query top-k subsequence matcher over a WindowView.

    Parameters
    ----------
    view:         :class:`repro_torch.subseq.WindowView` (encoder +
                  corpus); the engine runs on the view's device.
    batch_size:   verification batch per query per round.
    verify:       "auto" (K1 on a CUDA device, numpy on the CPU),
                  "kernel" / "host" (always K1 on the view's device),
                  "numpy" (bit-identical to a host brute-force scan), or
                  "device" (windows verified on the mesh's device, no
                  source row moved to the host; requires ``mesh``;
                  bitwise equal to "host").
    pairwise:     representation sweep ``(rq, rx) -> (Q, N)``; defaults
                  to the encoder's plain ``pairwise_distance``.
                  ``kernels.ops.make_pairwise`` gives the K2/K3 sweep.
    metrics:      optional ``repro_torch.obs.MetricsRegistry`` (None:
                  record nothing); the metric names are the JAX
                  package's ``subseq.*``.
    mesh:         optional ``core.distributed.ShardMesh``: shards the
                  window sweep (``ShardedWindowSweep``) like whole-series
                  matching; required for verify="device".
    """

    def __init__(self, view: WindowView, *, batch_size: int = 64,
                 verify: str = "auto", pairwise: Callable | None = None,
                 mesh=None, metrics=None):
        self.view = view
        self.encoder = view.encoder
        self.device = view.device
        self.batch_size = batch_size
        self.mesh = mesh
        self.verify_mode = verify
        self.metrics = metrics
        self._device = verify == "device"
        if self._device and mesh is None:
            raise ValueError('verify="device" needs a mesh (the sharded '
                             "window sweep owns the device raw mirror)")
        self._pw = pairwise or self.encoder.pairwise_distance
        self._sweep = None
        if mesh is not None:
            from repro_torch.core.distributed import ShardedWindowSweep
            self._sweep = ShardedWindowSweep(view, mesh, pairwise=self._pw,
                                             mirror_raw=self._device)
        # the device route's host twin is the K1 verifier: the same f32
        # distance definition, so the two are bitwise equal
        self.verifier = make_verifier("kernel" if self._device else verify,
                                      self.device)
        self.merge = (functools.partial(merge_topk_device, device=self.device)
                      if self._device else merge_topk_numpy)
        self._rep_cache = DeviceRepCache(view, self.device)

    # -- representation sweep --------------------------------------------
    @property
    def rep(self):
        """Device copy of the live window representation, refreshed only
        when the view version changes (append-aware)."""
        return self._rep_cache.get()

    def normalize_queries(self, queries_raw) -> np.ndarray:
        """(Q, m) raw queries -> z-normalized f32 (the matching space)."""
        qs = np.asarray(queries_raw, np.float32)
        if qs.ndim == 1:
            qs = qs[None]
        if qs.shape[-1] != self.view.m:
            raise ValueError(f"queries have length {qs.shape[-1]}, "
                             f"window length is m={self.view.m}")
        return znorm_windows(qs)

    def repr_distances(self, queries_z) -> np.ndarray:
        """(Q, n_windows) lower-bounding representation distances for
        already-normalized queries — over the mesh's mirrors when a mesh
        was given."""
        if self._sweep is not None:
            return self._sweep.repr_distances(queries_z)
        q = torch.as_tensor(np.asarray(queries_z, np.float32))
        q_rep = self.encoder.encode(q.to(self.device))
        return self._pw(q_rep, self.rep).cpu().numpy()

    # -- matching ---------------------------------------------------------
    def topk(self, queries_raw, k: int = 1, *, exclusion: int = 0,
             batch_size: Optional[int] = None,
             use_index: object = "auto", trace=None,
             explain: bool = False, epoch=None) -> SubseqResult:
        """Top-k windows for a (Q, m) query batch (or a single (m,)
        query), exact under z-normalized d_ED.

        exclusion: minimum start-sample distance (same source row) between
        two reported matches; 0 disables suppression.

        use_index: "auto" (use ``view.index`` when built), True (require
        it), or False (force the linear window sweep).  Indexed and
        linear candidate generation verify through the same k-th-best
        early-stop scan and return bit-identical results — the index
        only changes how many windows are examined.

        trace / explain: record a per-query ``repro_torch.obs`` query
        trace (``explain=True`` creates one and attaches it as
        ``res.trace``); bit-identical results and accounting either way.

        epoch: a ``view.current_epoch()`` frontier (or plain window
        count) pinning the answer to windows visible at that frontier.
        """
        if explain and trace is None:
            from repro_torch.obs import Trace
            trace = Trace("subseq.topk")
        observing = trace is not None or self.metrics is not None
        t0 = time.perf_counter() if observing else 0.0
        marks = self._marks() if observing else None
        res = self._topk(queries_raw, k, exclusion, batch_size, use_index,
                         trace, epoch)
        if observing:
            self._observe(trace, res, k, time.perf_counter() - t0, marks)
        if trace is not None:
            res.trace = trace
        return res

    def _marks(self) -> tuple:
        """(rows read, host-order bytes, h2d bytes) before a call: the
        monotone counters its transfer deltas are taken from."""
        sw = self._sweep
        return (self.view.accesses,
                sw.host_order_bytes if sw is not None else 0,
                sw.h2d_bytes if sw is not None else 0)

    def _observe(self, trace, res: SubseqResult, k: int, wall_s: float,
                 marks: tuple) -> None:
        """Post-call trace / registry recording: reads only the finished
        result and monotone counters, so it never perturbs the result."""
        rows0, hob0, h2d0 = marks
        # the device route never fetches: any row read during a
        # device-verified call is a row moved to the host
        rth = int(self.view.accesses - rows0) if self._device else None
        hob = h2d = None
        if self._sweep is not None:
            hob = int(self._sweep.host_order_bytes - hob0)
            h2d = int(self._sweep.h2d_bytes - h2d0)
        if trace is not None:
            trace.meta.update(engine="subseq", k=int(k),
                              q_n=int(res.window_ids.shape[0]),
                              total=int(self.view.n),
                              verify=self.verify_mode)
            trace.set("wall_s", wall_s)
            trace.set("pruning_power", res.pruned_fraction.copy())
            # deduplicated "generated": the accumulated meta total counts
            # re-handed candidates once per widening round; the noted id
            # layer reports the true union size alongside it
            gu = trace.unique_counts("generated", res.window_ids.shape[0])
            if gu is not None:
                trace.set("generated_unique", gu)
            if hob is not None:
                trace.set("host_order_bytes", hob)
                trace.set("h2d_bytes", h2d)
            if rth is not None:
                trace.set("rows_to_host", rth)
        if self.metrics is not None:
            m = self.metrics
            m.counter("subseq.queries").inc(res.window_ids.shape[0])
            m.counter("subseq.windows_verified").inc(
                int(res.raw_accesses.sum()))
            m.counter("subseq.rows_fetched").inc(int(res.store_accesses))
            m.counter("subseq.seeks").inc(int(res.store_fetches))
            m.counter("subseq.modeled_io_s").inc(float(res.io_seconds))
            m.gauge("subseq.pruning_power").set(
                float(res.pruned_fraction.mean()))
            m.histogram("subseq.topk_latency_s").observe(wall_s)
            if hob is not None:
                m.counter("subseq.host_order_bytes").inc(hob)
                m.counter("subseq.h2d_bytes").inc(h2d)
            if rth is not None:
                m.counter("subseq.rows_to_host").inc(rth)

    def _topk(self, queries_raw, k: int, exclusion: int,
              batch_size: Optional[int], use_index: object,
              trace, epoch=None) -> SubseqResult:
        zq = self.normalize_queries(queries_raw)
        bs = batch_size or self.batch_size
        n_e = epoch_rows(epoch)
        idx = self.view.index if use_index in ("auto", True) else None
        if use_index is True and idx is None:
            raise ValueError("use_index=True but the view has no index; "
                             "call view.build_index() first")
        if trace is not None:
            trace.set("source", "index" if idx is not None else "linear")
            if n_e is not None:
                trace.meta["epoch_rows"] = int(n_e)
        acc = {"rows": 0, "fetches": 0, "io": 0.0, "rounds": 0}
        dfn = self._sweep.make_dist_fn(zq) if self._device else None
        if idx is not None:
            return self._topk_indexed(zq, idx, k, exclusion, bs, acc, dfn,
                                      trace, epoch=n_e)
        if exclusion <= 0 and self._sweep is not None:
            # device-ordered candidate stream: the (Q, n_windows) bound
            # matrix never reaches the host (the suppression loop below
            # masks host columns, so it keeps the matrix path)
            with maybe_span(trace, "order") as sp:
                mask_fn = None
                if n_e is not None:
                    # windows past the pinned frontier -> +inf on device
                    def mask_fn(ids, _n=n_e):
                        return ids >= _n
                stream = self._sweep.candidate_stream(zq, mask_fn=mask_fn)
                if trace is not None:
                    from repro_torch.obs.trace import block_until_ready
                    block_until_ready((stream._b, stream._i))
                    sp.meta["stream"] = True
            with maybe_span(trace, "verify"):
                res = topk_verify(zq, None, self.view, k=k, batch_size=bs,
                                  verifier=self.verifier, merge=self.merge,
                                  dist_fn=dfn, stream=stream, trace=trace)
            total = (int(stream.width) if n_e is None
                     else min(int(stream.width), n_e))
            return self._wrap(res.indices, res.distances, res, total, acc)
        with maybe_span(trace, "order"):
            rd = self.repr_distances(zq)
            if n_e is not None:
                rd = rd[:, :n_e]   # prefix-stable: as-of read is a slice
        nw = rd.shape[1]
        if exclusion <= 0:
            with maybe_span(trace, "verify"):
                res = topk_verify(zq, rd, self.view, k=k, batch_size=bs,
                                  verifier=self.verifier, merge=self.merge,
                                  dist_fn=dfn, trace=trace)
            return self._wrap(res.indices, res.distances, res, nw, acc)

        # widen the verified frontier until k non-overlapping survivors
        # exist per query (or every window has been considered): greedy
        # selection over the verified order is exact as long as the
        # frontier was not cut before the k-th survivor.  Each widening
        # round seeds the best verified pairs (init_d / init_i) and masks
        # ALL verified ids to +inf in the bound matrix, so no window id is
        # ever fetched or verified twice across rounds.
        ver = _VerifiedSet(zq.shape[0])
        k_fetch = min(nw, max(4 * k, k + 8))
        rd = np.array(rd)                  # writeable: columns get masked
        widen_round = 0
        while True:
            init_d, init_i = ver.frontier(k_fetch)
            with maybe_span(trace, "verify", round=widen_round):
                res = topk_verify(zq, rd, self.view, k=k_fetch,
                                  batch_size=bs, verifier=self.verifier,
                                  merge=self.merge, init_d=init_d,
                                  init_i=init_i, dist_fn=dfn,
                                  on_verified=ver.add, trace=trace)
            widen_round += 1
            _accumulate(acc, res)
            ids, dists, full = self._suppress(res, k, exclusion)
            if full or k_fetch >= nw:
                return self._wrap(ids, dists, res, nw, acc,
                                  accumulated=True)
            for qi in range(zq.shape[0]):
                rd[qi, ver.ids(qi)] = np.inf
            k_fetch = min(nw, 2 * k_fetch)

    def topk_approx(self, queries_raw, k: int = 1, *,
                    collect: Optional[int] = None,
                    batch_size: Optional[int] = None,
                    trace=None, explain: bool = False,
                    epoch=None) -> SubseqResult:
        """Anytime/approximate window top-k through the index's bounded
        collect (requires ``view.build_index()``): exact seed walk, at
        most ``collect`` (default ``max(4 * k, 32)``) collected
        candidates per query.  The result carries ``kth_lb`` /
        ``error_bar`` — the same certificate contract as
        ``MatchEngine.topk_approx``; an error bar of zero proves the
        answer exact despite the cap."""
        idx = self.view.index
        if idx is None:
            raise ValueError("topk_approx needs the window index; call "
                             "view.build_index() first")
        n_e = epoch_rows(epoch)
        self._check_cover(idx, n_e)
        if explain and trace is None:
            from repro_torch.obs import Trace
            trace = Trace("subseq.topk")
        observing = trace is not None or self.metrics is not None
        t0 = time.perf_counter() if observing else 0.0
        marks = self._marks() if observing else None
        zq = self.normalize_queries(queries_raw)
        if trace is not None:
            trace.set("source", "index-approx")
            trace.set("exact", False)
        dfn = self._sweep.make_dist_fn(zq) if self._device else None
        res = idx.topk(zq, self.view, k=k,
                       batch_size=batch_size or self.batch_size,
                       verifier=self.verifier, merge=self.merge,
                       dist_fn=dfn, trace=trace, epoch=n_e,
                       approx_collect=(collect if collect is not None
                                       else max(4 * k, 32)))
        total = self.view.n if n_e is None else min(self.view.n, n_e)
        out = self._wrap(res.indices, res.distances, res, total,
                         {"rows": 0, "fetches": 0, "io": 0.0, "rounds": 0})
        out.kth_lb = res.kth_lb
        out.error_bar = res.error_bar
        if observing:
            self._observe(trace, out, k, time.perf_counter() - t0, marks)
        if trace is not None:
            out.trace = trace
        return out

    def _check_cover(self, idx, epoch: Optional[int]) -> None:
        """The index must cover the live view, or reach a pinned epoch
        (windows synced past the pin are filtered by the as-of
        traversal, not a staleness error)."""
        if epoch is None:
            if idx.n != self.view.n:
                raise ValueError(f"window index covers {idx.n} of "
                                 f"{self.view.n} windows; call "
                                 f"view.sync()")
        elif idx.n < epoch:
            raise ValueError(f"window index covers {idx.n} windows, "
                             f"epoch pins {epoch}; call view.sync()")

    def _topk_indexed(self, zq, idx, k: int, exclusion: int, bs: int,
                      acc: dict, dfn=None, trace=None,
                      epoch: Optional[int] = None) -> SubseqResult:
        """Indexed candidate generation: route the tree's compact
        candidate set through the same verification scan
        (``repro_torch.index.candidates.topk_from_source``) —
        bit-identical to the linear sweep.  With suppression, widen at
        doubled k_fetch, handing ``TreeCandidates`` the accumulated
        verified frontier and seen-id set — each round only verifies
        never-seen windows (each round remains an exact top-k_fetch, so
        greedy selection stays exact).  ``epoch`` (visible window count)
        needs the index to reach only the pinned frontier."""
        self._check_cover(idx, epoch)
        nw_total = self.view.n if epoch is None else int(epoch)
        common = dict(batch_size=bs, verifier=self.verifier,
                      merge=self.merge, dist_fn=dfn, epoch=epoch,
                      trace=trace)
        if exclusion <= 0:
            res = idx.topk(zq, self.view, k=k, **common)
            return self._wrap(res.indices, res.distances, res, nw_total,
                              acc)
        ver = _VerifiedSet(zq.shape[0])
        k_fetch = min(nw_total, max(4 * k, k + 8))
        while True:
            init_d, init_i = ver.frontier(k_fetch)
            seen = ([ver.ids(qi) for qi in range(zq.shape[0])]
                    if init_d is not None else None)
            res = idx.topk(zq, self.view, k=k_fetch, on_verified=ver.add,
                           prior_d=init_d, prior_i=init_i, seen=seen,
                           **common)
            _accumulate(acc, res)
            ids, dists, full = self._suppress(res, k, exclusion)
            if full or k_fetch >= nw_total:
                return self._wrap(ids, dists, res, nw_total, acc,
                                  accumulated=True)
            k_fetch = min(nw_total, 2 * k_fetch)

    def _suppress(self, res, k: int, exclusion: int):
        """Greedy non-overlap filter over the verified frontier; returns
        (ids, dists, every_query_filled_or_exhausted)."""
        q_n, kf = res.indices.shape
        rows_all, starts_all = self.view.locate(res.indices)
        out_i = np.full((q_n, k), -1, np.int64)
        out_d = np.full((q_n, k), np.inf, np.float64)
        full = True
        for qi in range(q_n):
            taken_rows, taken_starts, m_sel = [], [], 0
            for j in range(kf):
                wid = res.indices[qi, j]
                if wid < 0:
                    break
                r, s = rows_all[qi, j], starts_all[qi, j]
                clash = any(tr == r and abs(ts - s) < exclusion
                            for tr, ts in zip(taken_rows, taken_starts))
                if clash:
                    continue
                out_i[qi, m_sel] = wid
                out_d[qi, m_sel] = res.distances[qi, j]
                taken_rows.append(r)
                taken_starts.append(s)
                m_sel += 1
                if m_sel == k:
                    break
            # a query is settled if it filled k slots or its frontier ran
            # out of real candidates (no more windows exist at all)
            if m_sel < k and res.indices[qi, -1] >= 0:
                full = False
        return out_i, out_d, full

    def _wrap(self, ids, dists, res, nw, acc, *,
              accumulated: bool = False) -> SubseqResult:
        rows, starts = self.view.locate(ids)
        return SubseqResult(
            window_ids=ids, rows=rows, starts=starts, distances=dists,
            raw_accesses=res.raw_accesses,
            pruned_fraction=1.0 - res.raw_accesses / nw,
            store_accesses=acc["rows"] if accumulated else
            res.store_accesses,
            store_fetches=acc["fetches"] if accumulated else
            res.store_fetches,
            io_seconds=acc["io"] if accumulated else res.io_seconds,
            rounds=acc["rounds"] if accumulated else res.rounds)

    # -- brute-force baseline ---------------------------------------------
    def scan_topk(self, queries_raw, k: int = 1,
                  chunk_bytes: float = 2.5e8) -> SubseqResult:
        """Brute-force windowed scan through the K5 kernel
        (``kernels.ops.windowed_euclid``; its plain version for a CPU
        view): computes the full distance profile and takes top-k.  The
        modeled I/O is one streaming pass over the whole corpus — the
        baseline ``topk`` is judged against.

        The corpus is processed in row chunks sized so the (Q, rows, S)
        profile stays under ``chunk_bytes``; per-chunk top-k survivors
        are merged at the end."""
        zq = self.normalize_queries(queries_raw)
        q_n, m = zq.shape
        nw = self.view.windows_per_row
        n_rows = self.view.n_rows
        k = min(k, nw * n_rows)
        blk = max(1, int(chunk_bytes / (4 * max(q_n, 1) * nw * m)))
        data = self.view.source.data
        q = torch.as_tensor(zq).to(self.device)
        cand_i, cand_d = [], []
        for r0 in range(0, n_rows, blk):
            x = torch.as_tensor(np.ascontiguousarray(
                data[r0:r0 + blk], np.float32)).to(self.device)
            d2 = ops.windowed_euclid(x, q, stride=self.view.stride)
            d = np.sqrt(np.maximum(d2.cpu().numpy().reshape(q_n, -1), 0.0))
            kk = min(k, d.shape[1])
            part = np.argpartition(d, kk - 1, axis=1)[:, :kk]
            cand_i.append(part + r0 * nw)
            cand_d.append(np.take_along_axis(d, part, axis=1))
        all_i = np.concatenate(cand_i, axis=1)
        all_d = np.concatenate(cand_d, axis=1)
        sel = np.lexsort((all_i, all_d), axis=1)[:, :k]
        order = np.take_along_axis(all_i, sel, axis=1).astype(np.int64)
        dists = np.take_along_axis(all_d, sel, axis=1).astype(np.float64)
        rows, starts = self.view.locate(order)
        return SubseqResult(
            window_ids=order, rows=rows, starts=starts, distances=dists,
            raw_accesses=np.full(q_n, nw * n_rows, np.int64),
            pruned_fraction=np.zeros(q_n),
            store_accesses=n_rows, store_fetches=1,
            io_seconds=self.view.modeled_io_seconds(n_rows, 1))
