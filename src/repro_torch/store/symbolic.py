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

Snapshots (``save`` / ``open``) and the split-tree index
(``build_index``) are not ported yet and raise ``NotImplementedError``.
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

    ``epoch`` is the store version at publication (monotone counter)."""

    epoch: int
    n_rows: int


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
    media:    "hdd" | "ssd" | "hbm" cost-model preset.
    store_raw: when False the store keeps ONLY the representation —
              appended rows are encoded but their raw values are
              discarded (``fetch`` raises).
    device:   where ``append`` encodes.  The default is the CUDA card,
              and construction raises when there is none; pass
              ``device="cpu"`` to encode on the CPU.  The leaves are
              host numpy either way.
    """

    def __init__(self, encoder, *, media: str = "ssd",
                 store_raw: bool = True, device="cuda"):
        if media not in MEDIA:
            raise ValueError(f"unknown media {media!r}; options {set(MEDIA)}")
        self.device = resolve_device(device)
        self.encoder = encoder
        self.store_raw = bool(store_raw)
        self.media = media
        self.T = int(encoder.T)
        self._n = 0
        self._cap = 0
        self._raw: Optional[np.ndarray] = None
        self._rep: Optional[list] = None   # list of (cap, ...) leaf arrays
        self._rep_is_tuple = True
        self.version = 0                   # bumped on every append
        self.index = None                  # no index is ported yet
        # the published corpus frontier, swapped atomically as the LAST
        # step of every mutation
        self._epoch = CorpusEpoch(epoch=0, n_rows=0)
        self.epoch_ledger = deque([self._epoch], maxlen=_LEDGER_LEN)
        # the verification protocol (fetch accounting + I/O model) is the
        # one RawStore implements — delegated, not duplicated; its .data
        # is re-pointed at the live prefix after every append
        self._io = RawStore(np.empty((0, self.T), np.float32),
                            *MEDIA[media])

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
        existing rows and their representation are never touched."""
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
        self._publish_epoch()
        return ids

    def _publish_epoch(self) -> CorpusEpoch:
        """Publish the current frontier as a new epoch — the last step of
        every mutation, so the new epoch is never observable early."""
        ep = CorpusEpoch(epoch=self.version, n_rows=self._n)
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

    # -- not ported yet ----------------------------------------------------
    def build_index(self, **kwargs):
        raise NotImplementedError(
            "SymbolicStore.build_index is not ported yet: the split-tree "
            "index is ROADMAP queue 1 item 6")

    def save(self, directory: str, **kwargs) -> str:
        raise NotImplementedError(
            "SymbolicStore.save is not ported yet: snapshots are ROADMAP "
            "queue 1 item 5")

    @classmethod
    def open(cls, directory: str, **kwargs) -> "SymbolicStore":
        raise NotImplementedError(
            "SymbolicStore.open is not ported yet: snapshots are ROADMAP "
            "queue 1 item 5")
