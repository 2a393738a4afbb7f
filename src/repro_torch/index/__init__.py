"""Season-aware index subsystem: an incremental iSAX-style split tree
over any encoder's symbolic feature space.

* :mod:`repro_torch.index.features` — per-encoder feature adapters
  mapping raw series to a real-valued feature vector whose weighted
  distance lower-bounds d_ED (SAX: PAA means; sSAX: season mask +
  residual means; tSAX: scaled trend slope + residual means; stSAX: all
  three), computed on the store's device (K4 on a card).
* :mod:`repro_torch.index.tree` / :mod:`repro_torch.index.insert` — the
  adaptive split tree (host numpy).  The split dimension is a function
  of the node's bit state alone, season dimensions first, so an
  incremental build equals a bulk build for any chunking, and
  ``SymbolicStore.append`` maintains the index in place.
* :mod:`repro_torch.index.candidates` — the ``CandidateSource`` protocol
  that feeds ``core.engine.topk_verify``: ``LinearSweep`` and
  ``TreeCandidates`` (best-first seed walk, verified upper bound U, then
  a pruned collect), both through the same k-th-best early-stop
  verification, so indexed top-k is bit-identical to the linear sweep.
* :class:`repro_torch.index.series.SeriesIndex` — the store-facing
  object: built from a ``SymbolicStore``, maintained by ``insert_rows``,
  snapshot-round-trippable, usable as a candidate source by
  ``MatchEngine``.
"""

from repro_torch.index.features import (  # noqa: F401
    FeatureAdapter, adapter_for, gauss_breaks, ndtri_np)
from repro_torch.index.tree import SplitTree, TreeNode  # noqa: F401
from repro_torch.index.candidates import (  # noqa: F401
    CandidateSet, LinearSweep, TreeCandidates, topk_from_source)
from repro_torch.index.series import SeriesIndex  # noqa: F401
