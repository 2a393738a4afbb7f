"""``SSaxIndex`` — the original sSAX-only index API, now a thin wrapper
over the generic subsystem (:mod:`repro_torch.index.tree` +
:mod:`repro_torch.index.candidates`).

Kept for compatibility: the (sigma, resbar) constructor, ``query`` /
``topk`` / snapshot round-trip all behave as before,
but construction, incremental insert, and candidate generation are the
shared code paths every encoder uses — there is no sSAX-special split
logic left to drift.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core.matching import MatchResult, RawStore
from repro_torch.index.candidates import TreeCandidates, topk_from_source
from repro_torch.index.features import SSAXFeatures
from repro_torch.index.tree import SplitTree


class SSaxIndex:
    """iSAX-style index over sSAX (sigma, resbar) features.

    features: (sigma (N, L), resbar (N, W)) real-valued sPAA features
    (kept host-side; symbols are derived per cardinality).  ``device``
    is where ``insert_rows`` computes the features of new raw rows.
    """

    def __init__(self, sigma: np.ndarray, resbar: np.ndarray, *, T: int,
                 sd_seas: float, sd_res: float, max_bits: int = 8,
                 leaf_capacity: int = 64, encoder=None, device="cuda"):
        sigma = np.asarray(sigma, np.float32)
        resbar = np.asarray(resbar, np.float32)
        self.T = int(T)
        self.sd_seas = float(sd_seas)
        self.sd_res = float(sd_res)
        self.L = sigma.shape[1]
        self.W = resbar.shape[1]
        self.D = self.L + self.W
        self.encoder = encoder
        self.adapter = SSAXFeatures(self.T, self.L, self.W,
                                    sd_seas=self.sd_seas,
                                    sd_res=self.sd_res, encoder=encoder,
                                    device=device)
        self.tree = SplitTree(self.adapter, leaf_fill=leaf_capacity,
                              max_bits=max_bits)
        if sigma.shape[0]:
            self.tree.insert(np.concatenate([sigma, resbar], axis=1))

    # -- views ------------------------------------------------------------
    @property
    def root(self):
        return self.tree.root

    @property
    def n_nodes(self) -> int:
        return self.tree.n_nodes

    @property
    def feats(self) -> np.ndarray:
        return self.tree.feats

    @property
    def sigma(self) -> np.ndarray:
        return self.tree.feats[:, :self.L]

    @property
    def resbar(self) -> np.ndarray:
        return self.tree.feats[:, self.L:]

    @property
    def n(self) -> int:
        return self.tree.n

    @property
    def leaf_capacity(self) -> int:
        return self.tree.leaf_fill

    @property
    def max_bits(self) -> int:
        return self.tree.max_bits

    # -- incremental maintenance ------------------------------------------
    def insert_rows(self, rows) -> np.ndarray:
        """Route new RAW rows into the tree (requires the encoder the
        index was built from, passed as ``encoder=``)."""
        if self.encoder is None:
            raise TypeError("this SSaxIndex was built from precomputed "
                            "features without an encoder; pass encoder= "
                            "to insert raw rows incrementally")
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None]
        return self.tree.insert(self.adapter.features(rows))

    # -- search -----------------------------------------------------------
    def topk(self, sigma_q: np.ndarray, resbar_q: np.ndarray, store,
             queries_raw: np.ndarray, *, k: int = 1, batch_size: int = 64,
             verifier=None, merge=None):
        """Batched multi-query exact top-k through the indexed traversal
        (seed-verify, bound-collect, k-th-best pruned verification) —
        see :mod:`repro_torch.index.candidates`.  Returns an
        ``engine.TopKResult`` with combined access accounting."""
        sigma_q = np.asarray(sigma_q, np.float32)
        resbar_q = np.asarray(resbar_q, np.float32)
        if sigma_q.ndim == 1:
            sigma_q, resbar_q = sigma_q[None], resbar_q[None]
        feats_q = np.concatenate([sigma_q, resbar_q], axis=1)
        source = TreeCandidates(self.tree, lambda _qs: feats_q)
        return topk_from_source(queries_raw, source, store, k=k,
                                batch_size=batch_size, verifier=verifier,
                                merge=merge, total=self.tree.n)

    def query(self, q_sigma: np.ndarray, q_resbar: np.ndarray,
              store: RawStore, q_raw: np.ndarray) -> MatchResult:
        """Exact 1-NN — thin wrapper over the batched ``topk`` path, so
        indexed search shares the engine's verification machinery."""
        res = self.topk(q_sigma, q_resbar, store, q_raw, k=1)
        return MatchResult(index=int(res.indices[0, 0]),
                           distance=float(res.distances[0, 0]),
                           raw_accesses=int(res.raw_accesses[0]),
                           pruned_fraction=float(res.pruned_fraction[0]))

    # -- snapshot serialization -------------------------------------------
    def to_snapshot(self):
        """(meta, arrays) via the shared tree flattening — rebuildable
        without re-splitting by ``from_snapshot``."""
        meta, arrays = self.tree.to_snapshot()
        meta.update({"kind": "ssax", "T": int(self.T), "L": int(self.L),
                     "W": int(self.W), "sd_seas": float(self.sd_seas),
                     "sd_res": float(self.sd_res),
                     "leaf_capacity": int(self.leaf_capacity)})
        return meta, arrays

    @classmethod
    def from_snapshot(cls, meta: dict, arrays: dict,
                      encoder=None, device="cuda") -> "SSaxIndex":
        """Rebuild an index from ``to_snapshot`` output (no re-split)."""
        self = cls.__new__(cls)
        self.T = int(meta["T"])
        self.sd_seas = float(meta["sd_seas"])
        self.sd_res = float(meta["sd_res"])
        self.L = int(meta["L"])
        self.W = int(meta["W"])
        self.D = self.L + self.W
        self.encoder = encoder
        self.adapter = SSAXFeatures(self.T, self.L, self.W,
                                    sd_seas=self.sd_seas,
                                    sd_res=self.sd_res, encoder=encoder,
                                    device=device)
        self.tree = SplitTree.from_snapshot(self.adapter, meta, arrays)
        return self
