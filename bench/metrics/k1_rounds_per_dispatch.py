"""Engine layer (``core/engine.py::topk_verify``): verification rounds
(one gathered K1 launch each) per service dispatch, from the
program's ``match.rounds`` counter. Read over the card's traced
window: None where it held no device work or no K1 launch. None too
where the program records no such span."""

from bench.records import counter, kernels, ratio

K1 = r"(?<!windowed_)euclid_kernel"


def read(rec):
    if (rec["trace"]["busy_s"] <= 0 or not kernels(rec, K1)[1]
            or "match.rounds" not in rec["counters"]):
        return None
    return ratio(counter(rec, "match.rounds"), counter(rec, "serve.batches"))
