"""Engine layer (``core/engine.py``): the share of the traced window in
which the dispatcher ran engine code on the host rather than waiting
on the card, in percent: the ``match.topk`` spans' seconds less the
sweep's and the rounds' blocking copies (``wait``). None where the
window held no device work. None too where the program records no
such span."""

from bench.records import counter, ratio


def read(rec):
    if rec["trace"]["busy_s"] <= 0 or "match.topk_s" not in rec["counters"]:
        return None
    host = (counter(rec, "match.topk_s") - counter(rec, "match.sweep.wait_s")
            - counter(rec, "match.round.wait_s"))
    return ratio(100.0 * host, rec["window_s"])
