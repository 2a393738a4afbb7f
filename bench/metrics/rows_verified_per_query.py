"""Engine layer (``core/engine.py::topk_verify``): raw rows verified per
query of an engine call (power-of-two padding rows included, as the
engine counts them)."""

from bench.records import counter, ratio


def read(rec):
    return ratio(counter(rec, "match.candidates_verified"),
                 counter(rec, "match.queries"))
