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

Non-overlap suppression: with ``exclusion > 0``, windows that overlap an
already-selected better match (same source row, |start - start'| <
exclusion samples) are suppressed.  Selection stays exact: candidates
are taken greedily in the verified (distance, window id) order, and the
frontier is widened until k non-overlapping survivors exist or the
window set is exhausted.  Widening reuses the verified frontier: every
(window id, true distance) pair ever verified is accumulated, the next
round is seeded with the best of them and excludes the rest, so no
window id is ever fetched or verified twice.

``scan_topk`` is the brute-force baseline: the full distance profile
through the K5 windowed kernel (its plain version for a CPU view).

Not ported yet, each raising ``NotImplementedError``: the window index
(``use_index=True``, ``topk_approx``; ROADMAP queue 1 item 6), the
sharded sweep and device-resident verification (``mesh=``,
``verify="device"``; item 8), and tracing and metrics (``trace=``,
``explain=``, ``metrics=``; item 4).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.engine import (
    DeviceRepCache, make_verifier, merge_topk_numpy, topk_verify)
from repro_torch.kernels import ops
from repro_torch.store.symbolic import epoch_rows
from repro_torch.subseq.windows import WindowView, znorm_windows


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
                  "kernel" / "host" (always K1 on the view's device), or
                  "numpy" (bit-identical to a host brute-force scan).
    pairwise:     representation sweep ``(rq, rx) -> (Q, N)``; defaults
                  to the encoder's plain ``pairwise_distance``.
                  ``kernels.ops.make_pairwise`` gives the K2/K3 sweep.
    mesh, metrics: not ported yet; must be None.
    """

    def __init__(self, view: WindowView, *, batch_size: int = 64,
                 verify: str = "auto", pairwise: Callable | None = None, mesh=None,
                 metrics=None):
        if mesh is not None or verify == "device":
            raise NotImplementedError(
                'the sharded window sweep (mesh=, verify="device") is not '
                "ported yet: ROADMAP queue 1 item 8")
        if metrics is not None:
            raise NotImplementedError(
                "metrics= is not ported yet: ROADMAP queue 1 item 4")
        self.view = view
        self.encoder = view.encoder
        self.device = view.device
        self.batch_size = batch_size
        self.verify_mode = verify
        self.verifier = make_verifier(verify, self.device)
        self.merge = merge_topk_numpy
        self._pw = pairwise or self.encoder.pairwise_distance
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
        already-normalized queries."""
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

        use_index: "auto" or False take the linear window sweep (no
        window index is ported yet); True raises.

        epoch: a ``view.current_epoch()`` frontier (or plain window
        count) pinning the answer to windows visible at that frontier.

        trace / explain: accepted only as None / False until tracing is
        ported.
        """
        if trace is not None or explain:
            raise NotImplementedError(
                "tracing is not ported yet: ROADMAP queue 1 item 4")
        if use_index is True:
            raise NotImplementedError(
                "the window index is not ported yet: ROADMAP queue 1 "
                "item 6")
        zq = self.normalize_queries(queries_raw)
        bs = batch_size or self.batch_size
        n_e = epoch_rows(epoch)
        rd = self.repr_distances(zq)
        if n_e is not None:
            rd = rd[:, :n_e]       # prefix-stable: as-of read is a slice
        nw = rd.shape[1]
        acc = {"rows": 0, "fetches": 0, "io": 0.0, "rounds": 0}
        if exclusion <= 0:
            res = topk_verify(zq, rd, self.view, k=k, batch_size=bs,
                              verifier=self.verifier, merge=self.merge)
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
        while True:
            init_d, init_i = ver.frontier(k_fetch)
            res = topk_verify(zq, rd, self.view, k=k_fetch, batch_size=bs,
                              verifier=self.verifier, merge=self.merge,
                              init_d=init_d, init_i=init_i,
                              on_verified=ver.add)
            acc["rows"] += res.store_accesses
            acc["fetches"] += res.store_fetches
            acc["io"] += res.io_seconds
            acc["rounds"] += res.rounds
            ids, dists, full = self._suppress(res, k, exclusion)
            if full or k_fetch >= nw:
                return self._wrap(ids, dists, res, nw, acc,
                                  accumulated=True)
            for qi in range(zq.shape[0]):
                rd[qi, ver.ids(qi)] = np.inf
            k_fetch = min(nw, 2 * k_fetch)

    def topk_approx(self, queries_raw, k: int = 1, **kwargs):
        raise NotImplementedError(
            "topk_approx needs the window index, which is not ported yet: "
            "ROADMAP queue 1 item 6")

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
