"""Matrix-profile self-join (exact motifs and discords).

``SelfJoinEngine`` computes, for every window of an (N, T) corpus, its
nearest NON-TRIVIAL neighbor — exactly — by treating each corpus window
as a query against the corpus's own window set and routing candidates
through the same lower-bound-ordered verification as
``repro_torch.subseq`` (``core.engine.topk_verify``), with the
trivial-match zone (same source row, starts closer than ``exclusion``
samples) excluded up front.  The profile then yields ``topk_motifs``
(closest non-overlapping window pairs) and ``topk_discords`` (windows
whose nearest neighbor is farthest) — bit-identical to the brute-force
profile (``SelfJoinEngine.scan_profile``) on every candidate route.

The FFT sliding dot product (``repro_torch.kernels.fft_dot``, behind
``kernels.ops.windowed_euclid(..., method="fft")`` and
``kernels.ops.sliding_dot``) holds a documented tolerance; exact
verification stays on K1.
"""

from repro_torch.profile.selfjoin import (MatrixProfile, SelfJoinEngine,
                                          topk_discords, topk_motifs)

__all__ = ["MatrixProfile", "SelfJoinEngine", "topk_discords",
           "topk_motifs"]
