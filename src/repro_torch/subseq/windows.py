"""``WindowView``: the symbolic representation of all sliding windows.

A ``WindowView`` sits on top of a long-series corpus — a bare (N, T)
array, a ``RawStore``, or a ``SymbolicStore`` — and maintains the live
symbolic representation of every z-normalized window of length ``m =
encoder.T`` at a configurable ``stride``, without ever materializing the
N * S window matrix:

* **Representation only.**  Window reps live in a
  ``SymbolicStore(encoder, store_raw=False)`` — the store's incremental
  chunked-encode path (on the view's device: the K4 PAA kernel on a
  card), bit-identical to one-shot encoding for any chunking.  A
  window's raw values are always re-derivable from the source row.
* **Append-aware.**  ``append(rows)`` pushes rows into the source and
  encodes only the new rows' windows; ``sync()`` picks up rows appended
  to a shared source out-of-band.
* **Indexable.**  ``build_index()`` attaches a
  :class:`repro_torch.index.SeriesIndex` whose tree items are the
  windows themselves (ids = window ids), built from every window's
  features routed in one pass; ``sync`` maintains it incrementally and
  ``SubseqEngine`` takes sublinear candidates from it — bit-identical
  results to the linear window sweep.
* **Verification protocol over window ids.**  ``fetch(window_ids)``
  returns the z-normalized windows themselves, but bills the I/O cost
  model for the *deduplicated underlying rows* the windows live in,
  through a bounded FIFO row buffer (``cache_rows``) that models the
  matcher's buffer pool.  This is what lets ``core.engine.topk_verify``
  run unchanged over windows.

Window ids are dense row-major: ``wid = row * S + j`` covers
``source.data[row, j*stride : j*stride + m]`` where ``S`` is the
per-row window count; ``locate`` translates back.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from repro_torch.core.matching import MEDIA, RawStore
from repro_torch.core.normalize import znormalize
from repro_torch.kernels.windowed_euclid import n_windows
from repro_torch.store.symbolic import CorpusEpoch, SymbolicStore


def znorm_windows(w) -> np.ndarray:
    """Z-normalize a (..., m) window batch — the single definition the
    encode, ``fetch`` and every brute force share, numpy in and numpy
    out.  It runs on the CPU, where ``znormalize`` gives a window the
    same bits whatever batch it sits in (``tests/test_torch_subseq.py``
    holds that); a CUDA reduction may choose its order by shape."""
    x = torch.tensor(np.asarray(w), dtype=torch.float32)
    return znormalize(x).numpy()


class WindowView:
    """Sliding-window symbolic view of a long-series corpus.

    Parameters
    ----------
    encoder:      SAX / SSAX / TSAX / STSAX instance whose ``T`` is the
                  window length m.
    source:       (N, T) array (wrapped in a ``RawStore`` with ``media``),
                  or an existing ``RawStore`` / ``SymbolicStore`` whose
                  raw rows are the corpus.  May be None and appended into.
    stride:       window hop in samples (>= 1).
    media:        cost-model preset used when ``source`` is a bare array.
    encode_chunk: windows per incremental encode call (bounds the
                  transient window materialization).
    cache_rows:   row-buffer capacity (FIFO); rows served from the buffer
                  are not billed again.  0 disables buffering.
    device:       where the windows are encoded (the representation stays
                  host numpy).  The default is the CUDA card, and
                  construction raises when there is none; pass
                  ``device="cpu"`` to run on the CPU.
    """

    def __init__(self, encoder, source=None, *, stride: int = 1,
                 media: str = "ssd", encode_chunk: int = 4096,
                 cache_rows: int = 1024, device="cuda"):
        self.encoder = encoder
        self.m = int(encoder.T)
        if stride < 1:
            raise ValueError(f"stride must be >= 1, got {stride}")
        self.stride = int(stride)
        self.encode_chunk = int(encode_chunk)
        self.cache_rows = int(cache_rows)
        self._cache: dict = {}          # row id -> raw row (FIFO order)
        self._media = media
        self._rows_done = 0
        self._nw: Optional[int] = None     # windows per row, fixed by T
        self._rep = SymbolicStore(encoder, media=media, store_raw=False,
                                  device=device)
        self.device = self._rep.device
        self.index = None                  # optional SeriesIndex (windows)
        if source is None:
            self.source = None
        elif hasattr(source, "fetch") and hasattr(source, "data"):
            self.source = source
            self.sync()
        else:
            rows = np.asarray(source, np.float32)
            if rows.ndim == 1:
                rows = rows[None]
            self.source = RawStore(np.empty((0, rows.shape[-1]),
                                            np.float32),
                                   *_media_rates(media))
            self.append(rows)

    # -- geometry ---------------------------------------------------------
    @property
    def T(self) -> int:
        """Source series length (available once the first row exists)."""
        if self.source is None:
            raise ValueError("empty WindowView: append rows first")
        return int(self.source.data.shape[-1])

    @property
    def windows_per_row(self) -> int:
        if self._nw is None:
            self._nw = n_windows(self.T, self.m, self.stride)
        return self._nw

    @property
    def n_rows(self) -> int:
        return 0 if self.source is None else int(self.source.data.shape[0])

    @property
    def n(self) -> int:
        """Total windows currently encoded."""
        return self._rep.n

    def __len__(self) -> int:
        return self.n

    @property
    def version(self) -> int:
        return self._rep.version

    def current_epoch(self) -> CorpusEpoch:
        """Pinnable frontier for subsequence queries (the unit is WINDOW
        ids, not source rows).  Mid-``sync`` a chunk's representation
        append publishes before its index insert, so when an index
        exists the frontier is clamped to the index's item count — a
        pinned epoch is then covered by BOTH structures and the indexed
        and linear paths answer it identically."""
        ep = self._rep.current_epoch()
        if self.index is not None and self.index.n < ep.n_rows:
            ep = CorpusEpoch(epoch=ep.epoch, n_rows=int(self.index.n),
                             index_n=int(self.index.n))
        return ep

    def locate(self, window_ids):
        """Window ids -> (source row, start sample); -1 ids pass through."""
        wid = np.asarray(window_ids, np.int64)
        nw = self.windows_per_row
        rows = np.where(wid >= 0, wid // nw, -1)
        starts = np.where(wid >= 0, (wid % nw) * self.stride, -1)
        return rows, starts

    # -- ingest -----------------------------------------------------------
    def append(self, rows) -> np.ndarray:
        """Push long rows into the source and encode only their windows;
        returns the new rows' window ids."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None]
        if self.source is None:
            self.source = RawStore(np.empty((0, rows.shape[-1]),
                                            np.float32),
                                   *_media_rates(self._media))
        if rows.shape[-1] != self.source.data.shape[-1]:
            raise ValueError(
                f"rows have length {rows.shape[-1]}, corpus has "
                f"T={self.source.data.shape[-1]}")
        if hasattr(self.source, "append"):       # SymbolicStore source
            self.source.append(rows)
        else:
            self.source.data = np.concatenate([self.source.data, rows])
        start = self.n
        self.sync()
        return np.arange(start, self.n, dtype=np.int64)

    def sync(self) -> int:
        """Encode windows of any source rows not yet windowed (rows
        appended through a shared source land here); returns the number
        of windows added.  A window index built by ``build_index`` is
        maintained incrementally: each chunk's windows are routed into
        the split tree in window-id order — the tree is the one a bulk
        build over all windows gives, so no rebuild is ever needed."""
        added = 0
        n_rows = self.source.data.shape[0]
        for z in self._window_chunks(self._rows_done, n_rows):
            self._rep.append(z)
            if self.index is not None:
                self.index.insert_rows(z)
            added += z.shape[0]
        self._rows_done = n_rows
        return added

    def _window_chunks(self, row_lo: int, row_hi: int):
        """Yield the z-normalized windows of source rows [row_lo, row_hi)
        in window-id order, ``encode_chunk`` windows at a time — the ONE
        extraction path both incremental ``sync`` and the bulk
        ``build_index`` consume, so the two cannot drift apart."""
        nw = self.windows_per_row
        for r in range(row_lo, row_hi):
            wv = np.lib.stride_tricks.sliding_window_view(
                self.source.data[r], self.m)[::self.stride]  # (nw, m) view
            for c0 in range(0, nw, self.encode_chunk):
                yield znorm_windows(wv[c0:c0 + self.encode_chunk])

    # -- index ------------------------------------------------------------
    def build_index(self, *, leaf_fill: int = 64, max_bits: int = 8):
        """Build (and remember) a ``repro_torch.index.SeriesIndex`` over
        every window currently encoded, on the view's device — tree item
        ids ARE window ids (both are dense row-major insertion order).
        Every window's features come through ``_window_chunks`` (K4 on a
        card, one chunk at a time) and are routed into the tree in one
        pass (``SeriesIndex.insert_chunks``).  Windows of rows appended
        afterwards are inserted incrementally by ``sync``;
        ``SubseqEngine`` then generates candidates from the tree instead
        of sweeping all N*S windows linearly."""
        from repro_torch.index import SeriesIndex
        idx = SeriesIndex(self.encoder, leaf_fill=leaf_fill,
                          max_bits=max_bits, device=self.device)
        idx.insert_chunks(self._window_chunks(0, self._rows_done))
        assert idx.n == self.n, (idx.n, self.n)
        self.index = idx
        return idx

    # -- representation ---------------------------------------------------
    def rep_view(self):
        """Live window representation (encoder structure, zero-copy)."""
        return self._rep.rep_view()

    @property
    def rep_store(self) -> SymbolicStore:
        """The representation-only ``SymbolicStore`` backing this view."""
        return self._rep

    # -- RawStore verification protocol over WINDOW ids -------------------
    def fetch(self, window_ids) -> np.ndarray:
        """Z-normalized windows for ``window_ids`` (any order, duplicates
        allowed).  Bills the source cost model for the deduplicated
        underlying rows that are not already in the row buffer (one
        modeled seek for a round that reads any cold row)."""
        wid = np.asarray(window_ids, np.int64)
        if wid.size == 0:
            return np.empty((0, self.m), np.float32)
        rows, starts = self.locate(wid)
        uniq, inv = np.unique(rows, return_inverse=True)
        rowmap = {r: self._cache[r] for r in uniq.tolist()
                  if r in self._cache}
        missing = [r for r in uniq.tolist() if r not in rowmap]
        if missing:
            raw = self.source.fetch(np.asarray(missing, np.int64))
            rowmap.update(zip(missing, raw))
            if self.cache_rows > 0:
                self._cache.update(zip(missing, raw))
                while len(self._cache) > self.cache_rows:
                    self._cache.pop(next(iter(self._cache)))
        slab = np.stack([rowmap[r] for r in uniq.tolist()])[inv]  # (K, T)
        gather = starts[:, None] + np.arange(self.m)[None, :]
        return znorm_windows(np.take_along_axis(slab, gather, axis=1))

    @property
    def accesses(self) -> int:
        return self.source.accesses

    @property
    def fetches(self) -> int:
        return self.source.fetches

    def modeled_io_seconds(self, n_accesses: Optional[int] = None,
                           n_fetches: Optional[int] = None) -> float:
        return self.source.modeled_io_seconds(n_accesses, n_fetches)

    def reset_counters(self):
        """Zero the I/O accounting only, KEEPING the row buffer warm."""
        self.source.reset_counters()

    def reset(self):
        """Reset I/O accounting AND drop the row buffer (a cold-cache
        measurement)."""
        self._cache.clear()
        self.source.reset()


def _media_rates(media: str):
    if media not in MEDIA:
        raise ValueError(f"unknown media {media!r}; options {set(MEDIA)}")
    return MEDIA[media]
