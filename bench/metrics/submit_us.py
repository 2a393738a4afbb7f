"""Service layer (``service/session.py``): the program's own cost of one
``MatchSession.submit`` call on the caller's thread, from the call to
the request's admission, in us, from the ``serve.submit`` spans (closed
by the dispatch that takes the request). Read over the card's traced
window: None where it held no device work. None too where the program
records no such span."""

from bench.records import counter, ratio


def read(rec):
    if (rec["trace"]["busy_s"] <= 0
            or "serve.submit_calls" not in rec["counters"]):
        return None
    return ratio(1e6 * counter(rec, "serve.submit_s"),
                 counter(rec, "serve.submit_calls"))
