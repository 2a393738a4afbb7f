"""Service layer (``service/queue.py``, ``service/session.py``): requests
coalesced into one engine dispatch, on average."""

from bench.records import counter, ratio


def read(rec):
    return ratio(counter(rec, "serve.batched_requests"),
                 counter(rec, "serve.batches"))
