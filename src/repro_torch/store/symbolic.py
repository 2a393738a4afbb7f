"""Append-only symbolic store: raw rows + the live symbolic representation.

``SymbolicStore`` owns both sides of the paper's matching setup — the raw
(N, T) series that live on cold storage and the symbolic representation
(SAX / sSAX / tSAX / stSAX words) the engine sweeps — and keeps them
consistent under streaming ingestion:

* ``append(rows)`` encodes ONLY the new rows (one pass through the
  encoder on the store's device — through the K4 PAA kernel on a card)
  and writes raw + representation into preallocated capacity-doubled
  host arrays.  Nothing previously ingested is ever touched.  Encoders
  are row-wise maps, so chunked encoding is bit-identical to one-shot
  encoding for any chunking.
* ``rep_view()`` returns the representation trimmed to the live rows as
  zero-copy numpy views; ``rep_view(epoch=)`` is a prefix of it.
* The store speaks the ``RawStore`` verification protocol (``data`` /
  ``fetch`` / ``accesses`` / ``fetches`` / ``modeled_io_seconds`` /
  ``reset``) with the same cost models, delegated to a ``RawStore``.
* ``store_raw=False`` keeps the representation only: the mode
  ``subseq.WindowView`` uses so sliding windows never materialize as
  rows.
* ``save(dir)`` / ``SymbolicStore.open(dir)`` persist raw rows,
  representation, encoder parameters (breakpoints checked on open) and
  the split-tree index in the JAX package's snapshot format
  (:mod:`repro_torch.store.snapshot`), readable by either package.
* ``build_index()`` attaches a :class:`repro_torch.index.SeriesIndex`
  that ``append`` maintains incrementally — engine queries take
  sublinear candidates from it with bit-identical results.
"""

from __future__ import annotations

from collections import deque
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.core.matching import MEDIA, RawStore

_MIN_CAPACITY = 1024

#: bounded observability window of recently published epochs — the
#: frontier itself is fully determined by ``n_rows``
_LEDGER_LEN = 1024


def rep_leaves(rep):
    """Normalize an encoder representation (array or tuple) to a tuple."""
    return rep if isinstance(rep, tuple) else (rep,)


@dataclass(frozen=True)
class CorpusEpoch:
    """One immutable published corpus frontier.

    Every ``SymbolicStore.append`` publishes a new epoch as its LAST
    step, with a single attribute assignment: readers racing an append
    see either the old or the new epoch, never a torn one.  The store is
    append-only, so ``n_rows`` alone pins what a reader needs: rows
    ``[0, n_rows)`` are complete and immutable, and ``rep_view(epoch=)``
    is a prefix slice.

    ``epoch`` is the store version at publication (monotone counter);
    ``index_n`` records how many items the attached index covered when
    the epoch was published (equal to ``n_rows`` while an incremental
    index is maintained; 0 without one)."""

    epoch: int
    n_rows: int
    index_n: int = 0


def epoch_rows(epoch) -> Optional[int]:
    """Resolve an epoch argument (``CorpusEpoch`` | int | None) to the
    visible row count, or None for "live" — the one coercion every
    layer that accepts ``epoch=`` shares."""
    if epoch is None:
        return None
    return int(getattr(epoch, "n_rows", epoch))


class SymbolicStore:
    """Append-only raw + symbolic store for one encoder.

    Parameters
    ----------
    encoder:  SAX / SSAX / TSAX / STSAX instance (anything with ``T``,
              ``encode`` and ``pairwise_distance``).
    media:    "hdd" | "ssd" | "hbm" cost-model preset, or pass explicit
              ``seek_s`` / ``read_bps``.
    store_raw: when False the store keeps ONLY the representation —
              appended rows are encoded but their raw values are
              discarded (``fetch`` raises).
    device:   where ``append`` encodes.  The default is the CUDA card,
              and construction raises when there is none; pass
              ``device="cpu"`` to encode on the CPU.  The leaves are
              host numpy either way.
    """

    def __init__(self, encoder, *, media: str = "ssd",
                 seek_s: Optional[float] = None,
                 read_bps: Optional[float] = None,
                 store_raw: bool = True, device="cuda"):
        self.device = resolve_device(device)
        self.encoder = encoder
        self.store_raw = bool(store_raw)
        if seek_s is None or read_bps is None:
            if media not in MEDIA:
                raise ValueError(
                    f"unknown media {media!r}; options {set(MEDIA)}")
            self.seek_s = MEDIA[media][0] if seek_s is None else float(seek_s)
            self.read_bps = (MEDIA[media][1] if read_bps is None
                             else float(read_bps))
            self.media = media
        else:
            # explicit cost model: label it by the matching preset so the
            # media name never contradicts the numbers
            self.seek_s, self.read_bps = float(seek_s), float(read_bps)
            self.media = next(
                (name for name, v in MEDIA.items()
                 if v == (self.seek_s, self.read_bps)), "custom")
        self.T = int(encoder.T)
        self._n = 0
        self._cap = 0
        self._raw: Optional[np.ndarray] = None
        self._rep: Optional[list] = None   # list of (cap, ...) leaf arrays
        self._rep_is_tuple = True
        self.version = 0                   # bumped on every append
        self.index = None                  # optional SeriesIndex over rows
        # the published corpus frontier, swapped atomically as the LAST
        # step of every mutation
        self._epoch = CorpusEpoch(epoch=0, n_rows=0)
        self.epoch_ledger = deque([self._epoch], maxlen=_LEDGER_LEN)
        # the verification protocol (fetch accounting + I/O model) is the
        # one RawStore implements — delegated, not duplicated; its .data
        # is re-pointed at the live prefix after every append
        self._io = RawStore(np.empty((0, self.T), np.float32),
                            seek_s=self.seek_s, read_bps=self.read_bps)

    # -- construction -----------------------------------------------------
    @classmethod
    def from_rows(cls, encoder, rows, *, media: str = "ssd",
                  **kwargs) -> "SymbolicStore":
        """One-shot construction: a store holding ``rows`` already encoded."""
        store = cls(encoder, media=media, **kwargs)
        store.append(rows)
        return store

    def _encode(self, rows: np.ndarray) -> tuple:
        x = torch.as_tensor(np.asarray(rows, np.float32)).to(self.device)
        return tuple(leaf.cpu().numpy()
                     for leaf in rep_leaves(self.encoder.encode(x)))

    def _grow(self, need: int):
        if need <= self._cap and self._rep is not None:
            return
        new_cap = max(need, 2 * self._cap, _MIN_CAPACITY)
        if self._rep is None:
            # one zero row teaches the leaf shapes and dtypes
            probe = self.encoder.encode(
                torch.zeros((1, self.T), dtype=torch.float32,
                            device=self.device))
            self._rep_is_tuple = isinstance(probe, tuple)
            self._rep = [np.empty((new_cap,) + tuple(l.shape[1:]),
                                  l.cpu().numpy().dtype)
                         for l in rep_leaves(probe)]
            if self.store_raw:
                self._raw = np.empty((new_cap, self.T), np.float32)
        else:
            new_rep = []
            for old in self._rep:
                arr = np.empty((new_cap,) + old.shape[1:], old.dtype)
                arr[:self._n] = old[:self._n]
                new_rep.append(arr)
            self._rep = new_rep
            if self.store_raw:
                new_raw = np.empty((new_cap, self.T), np.float32)
                new_raw[:self._n] = self._raw[:self._n]
                self._raw = new_raw
        self._cap = new_cap

    # -- ingest -----------------------------------------------------------
    def append(self, rows, rep=None) -> np.ndarray:
        """Ingest new series; returns their dataset row ids.

        rows: (M, T) or (T,).  ``rep``: optionally the precomputed
        representation of exactly these rows — structure must match
        ``encoder.encode`` output.  Only the new rows are encoded;
        existing rows and their representation are never touched.  A
        ``self.index`` built by ``build_index`` is maintained
        incrementally through the same code path as its bulk build (an
        index that cannot insert — a legacy ``SSaxIndex`` built from
        precomputed features — is dropped instead)."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None]
        if rows.shape[-1] != self.T:
            raise ValueError(f"rows have length {rows.shape[-1]}, "
                             f"encoder expects T={self.T}")
        m = rows.shape[0]
        if m == 0:
            return np.empty(0, np.int64)
        leaves = (tuple(np.asarray(l.cpu() if isinstance(l, torch.Tensor)
                                   else l) for l in rep_leaves(rep))
                  if rep is not None else self._encode(rows))
        self._grow(self._n + m)
        if len(leaves) != len(self._rep):
            raise ValueError("rep structure does not match the encoder")
        for dst, src in zip(self._rep, leaves):
            if src.shape[0] != m or src.shape[1:] != dst.shape[1:]:
                raise ValueError(
                    f"rep leaf shape {src.shape} incompatible with "
                    f"store leaf {dst.shape[1:]} for {m} rows")
        if self.store_raw:
            self._raw[self._n:self._n + m] = rows
        for dst, src in zip(self._rep, leaves):
            dst[self._n:self._n + m] = src
        ids = np.arange(self._n, self._n + m, dtype=np.int64)
        self._n += m
        if self.store_raw:
            self._io.data = self._raw[:self._n]
        self.version += 1
        if self.index is not None:
            if getattr(self.index, "encoder", None) is None:
                # a feature-only index cannot derive features from raw
                # rows: drop it rather than serve stale coverage
                self.index = None
            else:
                self.index.insert_rows(rows)   # same path as bulk build
        self._publish_epoch()
        return ids

    def _publish_epoch(self) -> CorpusEpoch:
        """Publish the current frontier as a new epoch — the last step of
        every mutation, so the new epoch is never observable early."""
        ep = CorpusEpoch(
            epoch=self.version, n_rows=self._n,
            index_n=int(self.index.n) if self.index is not None else 0)
        self.epoch_ledger.append(ep)
        self._epoch = ep                     # atomic publish
        return ep

    def current_epoch(self) -> CorpusEpoch:
        """The latest published frontier.  A query pinned to this epoch
        answers bit-identically to a frozen copy of the store truncated
        to ``epoch.n_rows``, regardless of later appends."""
        return self._epoch

    # -- views ------------------------------------------------------------
    @property
    def n(self) -> int:
        return self._n

    def __len__(self) -> int:
        return self._n

    @property
    def data(self) -> np.ndarray:
        """(N, T) raw rows — zero-copy view of the live prefix."""
        return self._io.data

    def rep_view(self, epoch=None):
        """Representation in the encoder's structure (zero-copy).

        ``epoch`` (a ``CorpusEpoch`` or a plain row count) bounds the
        view to the rows visible at that frontier: a prefix slice."""
        if self._rep is None:
            self._grow(0)
        n = self._n
        n_e = epoch_rows(epoch)
        if n_e is not None:
            n = min(n, n_e)
        leaves = tuple(l[:n] for l in self._rep)
        return leaves if self._rep_is_tuple else leaves[0]

    # -- RawStore verification protocol (delegated) ------------------------
    @property
    def accesses(self) -> int:
        return self._io.accesses

    @property
    def fetches(self) -> int:
        return self._io.fetches

    def fetch(self, idx) -> np.ndarray:
        if not self.store_raw:
            raise TypeError("store was built with store_raw=False: raw "
                            "rows were discarded after encoding and "
                            "cannot be fetched")
        return self._io.fetch(idx)

    def modeled_io_seconds(self, n_accesses: Optional[int] = None,
                           n_fetches: Optional[int] = None) -> float:
        return self._io.modeled_io_seconds(n_accesses, n_fetches)

    def reset_counters(self):
        """Zero the I/O accounting between measured phases."""
        self._io.reset_counters()

    def reset(self):
        self._io.reset()

    # -- index ------------------------------------------------------------
    def build_index(self, *, leaf_fill: int = 64, max_bits: int = 8,
                    mesh=None, n_shards: Optional[int] = None):
        """Build (and remember) a ``repro_torch.index.SeriesIndex`` over
        the current rows, features on the store's device.  Later
        ``append`` calls maintain it incrementally (no rebuild); the
        engine consumes it via ``MatchEngine.topk(..., source="index")``.
        ``mesh`` (a ``core.distributed.ShardMesh``) computes the
        features shard by shard on its device and ``n_shards`` (default:
        the mesh's shard count) routes the bulk build through
        ``SplitTree.insert_grouped``; both are bit-identical to the
        single build."""
        if not self.store_raw:
            raise TypeError("store was built with store_raw=False: index "
                            "features are derived from raw rows (index "
                            "the view that owns the raw source instead)")
        from repro_torch.index import SeriesIndex
        self.index = SeriesIndex.from_store(self, leaf_fill=leaf_fill,
                                            max_bits=max_bits,
                                            mesh=mesh, n_shards=n_shards)
        self._publish_epoch()        # the index split-state token changed
        return self.index

    # -- persistence -------------------------------------------------------
    def save(self, directory: str, *, keep: int = 3,
             n_hosts: int = 1) -> str:
        """Write an atomic snapshot (see ``repro_torch.store.snapshot``);
        returns its final path.  ``n_hosts`` splits the row-indexed
        arrays into per-host ``shard_hNNN.npz`` files."""
        if not self.store_raw:
            raise TypeError("store was built with store_raw=False: the "
                            "snapshot format requires raw rows (re-derive "
                            "the representation from the source instead)")
        from repro_torch.store.snapshot import save_store
        return save_store(directory, self, keep=keep, n_hosts=n_hosts)

    @classmethod
    def open(cls, directory: str, *, snap: Optional[int] = None,
             device="cuda") -> "SymbolicStore":
        """Reopen the latest (or a specific) snapshot from disk — one the
        JAX package wrote too — as a store that encodes on ``device``
        (the card unless ``device="cpu"``)."""
        from repro_torch.store.snapshot import open_store
        return open_store(directory, snap=snap, device=device)
