"""Hand-written CUDA kernels (Hopper, ``sm_90a``) for the matching
engine's hot spots, each beside its plain PyTorch version in ``ref.py``.

  * euclid     (K1) -- batched Euclidean verification of candidates
  * ssax_dist  (K2) -- sSAX 4-symbol cell distance sweep (Eq. 20)
  * sax_dist   (K3) -- SAX MINDIST^2 sweep
  * paa        (K4) -- segment-mean front end (PAA, Eq. 5)
  * windowed_euclid (K5) -- z-normalized distance profile, the
                       subsequence path's brute-force scan

A wrapper runs the plain version for CPU tensors and the kernel for CUDA
tensors, never falling back from one to the other.  ``ops.py`` holds the
dispatchers and the query-table builders.  ``KERNELS`` maps each kernel's
name to its launch counter.
"""

from repro_torch.kernels import (
    euclid, paa, sax_dist, ssax_dist, windowed_euclid)

KERNELS = {m.KERNEL.name: m.KERNEL for m in (euclid, ssax_dist, sax_dist,
                                               paa, windowed_euclid)}


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def launch_counts() -> dict:
    return {name: k.launches for name, k in KERNELS.items()}
