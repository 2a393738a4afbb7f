"""Sharded sweep and candidate order (``core/distributed.py``:
``ShardedRepSweep``, ``DeviceOrderedStream``): device milliseconds of the
device-wide radix sort that orders each dispatch's (Q, N) bounds, per
dispatch.  The engine loop's per-round merges sort (Qa, k + batch) rows
with another kernel (``radixSortKVInPlace``) and are not counted."""

from bench.records import counter, kernels, ratio

SORT = r"\bDeviceRadixSort|\bDeviceSegmentedRadixSort"


def read(rec):
    s, n = kernels(rec, SORT)
    if not n:
        return None
    return ratio(s * 1e3, counter(rec, "serve.batches"))
