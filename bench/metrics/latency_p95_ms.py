"""Client side: the 95th percentile of the latencies of every request
back in the traced window, from the call to ``submit`` to the answer.
The closed loop keeps the service saturated, so each request waits for
one dispatch or, where the coalescing window split its batch, for two:
the tail sits between the two and swings with the share of split
requests.  It is read here, beside ``qps``, and not bounded."""

import numpy as np


def read(rec):
    lat = rec.get("latency_s")
    if not lat:
        return None
    return float(np.percentile(np.asarray(lat, np.float64), 95)) * 1e3
