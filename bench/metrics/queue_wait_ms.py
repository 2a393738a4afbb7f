"""Service layer (``service/queue.py``): a request's wait from admission
to the dispatch that takes it, in ms, on average over the requests
dispatched in the traced window (``serve.queue`` spans). None where
the window held no device work. None too where the program records no
such span."""

from bench.records import counter, ratio


def read(rec):
    if (rec["trace"]["busy_s"] <= 0
            or "serve.queue_wait_s" not in rec["counters"]):
        return None
    return ratio(1e3 * counter(rec, "serve.queue_wait_s"),
                 counter(rec, "serve.batched_requests"))
