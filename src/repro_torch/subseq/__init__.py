"""Subsequence matching: sliding-window symbolic search over long series.

The paper's exact scan (§4.1) needs only a candidate set on which the
encoder's lower bound holds, so it applies unchanged to the set of
**z-normalized sliding windows** of long series:

* :class:`~repro_torch.subseq.windows.WindowView` enumerates the length-m,
  stride-s windows of an (N, T) corpus and keeps their live symbolic
  representation in a representation-only ``SymbolicStore``; it speaks
  the ``RawStore`` verification protocol over window ids.
* :class:`~repro_torch.subseq.search.SubseqEngine` runs the pruned scan
  over window candidates through ``core.engine.topk_verify``, so its
  top-k windows are exactly the brute-force windowed scan's; optional
  non-overlap suppression discards trivial matches.
* ``kernels.windowed_euclid`` (K5) is the brute-force side: the full
  z-normalized distance profile, used by ``SubseqEngine.scan_topk``.
"""

from repro_torch.subseq.windows import WindowView, znorm_windows  # noqa: F401
from repro_torch.subseq.search import SubseqEngine, SubseqResult  # noqa: F401
