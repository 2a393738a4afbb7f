"""``SeriesIndex``: the store-facing incremental index.

One object ties the pieces together for a concrete corpus: the encoder's
feature adapter, the split tree, and the engine protocol.  It indexes
raw rows (``SymbolicStore`` / whole matching) — anything whose items
the adapter's ``features`` accepts row-wise (the window index of
subsequence matching is not wired to it yet).

Contracts:

* ``insert_rows`` is incremental and chunking-invariant: the tree after
  any sequence of inserts equals a bulk build over the same rows
  (:mod:`repro_torch.index.insert`), so ``SymbolicStore.append``
  maintains it in place.
* ``topk`` routes through ``core.engine.topk_verify`` via
  :class:`repro_torch.index.candidates.TreeCandidates` — bit-identical to the
  linear sweep, sublinear candidates examined.
* ``to_snapshot`` / ``from_snapshot`` round-trip the tree INCLUDING its
  split history, so a reopened incrementally-built index answers
  queries identically and keeps accepting inserts.

Features are computed on ``device`` (the encoder's feature map, through
the K4 PAA kernel on a card) in chunks of ``_INSERT_CHUNK`` rows; the
tree itself is host numpy.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from repro_torch.core.engine import resolve_device
from repro_torch.index.candidates import TreeCandidates, topk_from_source
from repro_torch.index.features import FeatureAdapter, adapter_for
from repro_torch.index.tree import SplitTree

_INSERT_CHUNK = 8192


class SeriesIndex:
    """Incremental split-tree index for one encoder's corpus; features
    are computed on ``device`` (the card unless ``device="cpu"``)."""

    def __init__(self, encoder, *, leaf_fill: int = 64, max_bits: int = 8,
                 adapter: Optional[FeatureAdapter] = None, device="cuda"):
        self.encoder = encoder
        self.device = resolve_device(device)
        self.adapter = adapter if adapter is not None \
            else adapter_for(encoder, self.device)
        self.tree = SplitTree(self.adapter, leaf_fill=leaf_fill,
                              max_bits=max_bits)

    # -- construction ----------------------------------------------------
    @classmethod
    def from_store(cls, store, *, leaf_fill: int = 64, max_bits: int = 8,
                   mesh=None, n_shards: int = None) -> "SeriesIndex":
        """Index every row of a ``SymbolicStore`` (or any object with
        raw ``.data``) on the store's device — the bulk build is just
        ``insert_rows`` over the existing rows, the same code path
        appends keep using.

        ``n_shards`` partitions the tree routing by root subtree
        (``SplitTree.insert_grouped``), bit-identical to the single
        build — leaf membership, boxes and split history included.
        ``mesh`` (sharded feature extraction) raises until
        ``core/distributed.py`` is ported."""
        idx = cls(store.encoder, leaf_fill=leaf_fill, max_bits=max_bits,
                  device=getattr(store, "device", "cuda"))
        if mesh is None and (n_shards is None or n_shards <= 1):
            idx.insert_rows(store.data)
        else:
            idx.bulk_load(store.data, mesh=mesh, n_shards=n_shards)
        return idx

    def bulk_load(self, rows, *, mesh=None, n_shards: int = None
                  ) -> np.ndarray:
        """Grouped bulk build: tree routing partitioned into
        ``n_shards`` root subtrees.  Chunked like ``insert_rows``
        (row-wise maps make chunking bit-identical); returns the new ids
        in insertion order.  ``mesh`` raises (ROADMAP queue 1 item 8)."""
        if mesh is not None:
            raise NotImplementedError(
                "a mesh-sharded index build needs core/distributed.py, "
                "which is not ported yet (ROADMAP queue 1 item 8)")
        if n_shards is None:
            n_shards = 1
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None]
        if rows.shape[0] == 0:
            return np.empty(0, np.int64)
        out = []
        for c0 in range(0, rows.shape[0], _INSERT_CHUNK):
            chunk = rows[c0:c0 + _INSERT_CHUNK]
            feats = self.adapter.features(chunk)
            out.append(self.tree.insert_grouped(feats, max(n_shards, 1)))
        return np.concatenate(out)

    def insert_rows(self, rows) -> np.ndarray:
        """Compute features of new rows (chunked — features are row-wise
        maps, so chunking is bit-identical) and route them into the
        tree; returns their item ids (insertion order)."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None]
        if rows.shape[0] == 0:
            return np.empty(0, np.int64)
        out = []
        for c0 in range(0, rows.shape[0], _INSERT_CHUNK):
            chunk = rows[c0:c0 + _INSERT_CHUNK]
            out.append(self.tree.insert(self.adapter.features(chunk)))
        return np.concatenate(out)

    # -- views -----------------------------------------------------------
    @property
    def n(self) -> int:
        return self.tree.n

    def __len__(self) -> int:
        return self.tree.n

    @property
    def n_nodes(self) -> int:
        return self.tree.n_nodes

    @property
    def leaf_fill(self) -> int:
        return self.tree.leaf_fill

    @property
    def max_bits(self) -> int:
        return self.tree.max_bits

    # -- engine integration ----------------------------------------------
    def query_features(self, queries_raw) -> np.ndarray:
        qs = np.asarray(queries_raw, np.float32)
        if qs.ndim == 1:
            qs = qs[None]
        return self.adapter.features(qs)

    def source(self, *, prior_d=None, prior_i=None, seen=None,
               device_order: bool = False,
               approx_collect: Optional[int] = None,
               epoch=None) -> TreeCandidates:
        """This index as a ``CandidateSource`` for the match engine.
        ``prior_d`` / ``prior_i`` / ``seen`` enable frontier reuse across
        exclusion-widening rounds (see ``TreeCandidates``): already
        verified ids are seeded, never verified twice.  ``device_order``
        raises until the device-ordered stream is ported.  ``approx_collect``
        switches to the APPROXIMATE anytime mode: exact seed walk, then
        at most that many collected survivors per query, with the
        dropped bounds carried as the result's error certificate.
        ``epoch`` (``CorpusEpoch`` or row count) restricts
        generation to items indexed before that frontier — the as-of
        read behind snapshot-consistent serving under ingest."""
        return TreeCandidates(self.tree, self.query_features,
                              prior_d=prior_d, prior_i=prior_i, seen=seen,
                              device_order=device_order,
                              approx_collect=approx_collect, epoch=epoch)

    def topk(self, queries_raw, store, *, k: int = 1, batch_size: int = 64,
             verifier=None, merge=None, dist_fn=None, on_verified=None,
             prior_d=None, prior_i=None, seen=None,
             approx_collect: Optional[int] = None, epoch=None, trace=None):
        """Exact top-k over ``store`` through the indexed traversal —
        bit-identical to the linear-sweep engine (same verification
        path, same tie-break).  ``dist_fn`` routes verification through
        a device-resident distance hook; ``prior_d``/``prior_i``/``seen``
        reuse an earlier round's verified frontier; ``trace`` records a
        ``repro_torch.obs`` query trace (seed/collect/scan phases).
        ``approx_collect`` routes through the bounded-collect
        approximate mode — the result then carries ``kth_lb`` /
        ``error_bar`` (see ``TreeCandidates``).  ``epoch`` pins the
        answer to the items visible at that frontier (bit-identical to
        an index truncated there, regardless of concurrent inserts)."""
        from repro_torch.store.symbolic import epoch_rows
        src = self.source(prior_d=prior_d, prior_i=prior_i, seen=seen,
                          approx_collect=approx_collect, epoch=epoch)
        n_e = epoch_rows(epoch)
        total = self.n if n_e is None else min(self.n, n_e)
        return topk_from_source(queries_raw, src, store, k=k,
                                batch_size=batch_size, verifier=verifier,
                                merge=merge, total=total,
                                dist_fn=dist_fn, on_verified=on_verified,
                                trace=trace)

    # -- snapshot serialization ------------------------------------------
    def to_snapshot(self):
        meta, arrays = self.tree.to_snapshot()
        meta["kind"] = "series"
        return meta, arrays

    @classmethod
    def from_snapshot(cls, encoder, meta: dict, arrays: dict,
                      device="cuda") -> "SeriesIndex":
        self = cls.__new__(cls)
        self.encoder = encoder
        self.device = resolve_device(device)
        self.adapter = adapter_for(encoder, self.device)
        self.tree = SplitTree.from_snapshot(self.adapter, meta, arrays)
        return self
