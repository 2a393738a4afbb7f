"""Kernels layer, K2 (``kernels/csrc/ssax_dist.cu``): the bound of the
sweeps' work (the symbols once per engine call, every query of the
calls over every row) over K2's device time, in percent."""

from bench.records import counter, kernels
from bench.roofline import k2_work, share_pct

K2 = r"\bssax_dist\w*_kernel"


def read(rec):
    s, n = kernels(rec, K2)
    if not n:
        return None
    enc = rec["config"]["encoder"]
    work = k2_work(rec["engine_calls"], int(counter(rec, "match.queries")),
                   rec["n_rows"], enc["L"], enc["W"], enc["A_seas"],
                   enc["A_res"])
    return share_pct(work, s)
