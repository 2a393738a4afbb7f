"""Kernels layer, K1 (``kernels/csrc/euclid.cu``): the bound of every
verified (query, row) pair's work over K1's device time, in percent."""

from bench.records import counter, kernels
from bench.roofline import k1_work, share_pct

K1 = r"(?<!windowed_)euclid_kernel"


def read(rec):
    s, n = kernels(rec, K1)
    pairs = counter(rec, "match.candidates_verified")
    if not n or not pairs:
        return None
    return share_pct(k1_work(pairs, int(rec["config"]["encoder"]["T"])), s)
