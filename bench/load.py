"""The one load generator: every traffic mix is parameters for it.

A closed loop: ``clients`` callers, each with one request in flight; a
caller sends its next query as soon as its answer is back.  One driver
thread plays every caller: it waits for the oldest request in flight
(the service answers in arrival order), takes every answer that is back
and sends each caller's next query at once.

Queries come from the pool in order, wrapping around.  Every request is
timed on the client's side, from the call to ``submit`` to the moment
the driver sees its answer; a request that has not come back when the
window closes is waited for (up to ``SETTLE_S``) and checked, but not
counted in the window's metrics.

``resend_bursts`` says how fast the driver answered the service: for
each batch of answers, how long it took from the first resend that the
batch set off to the last.  A service that coalesces requests within a
window sees a closed loop's batch whole only where that is shorter than
the window.
"""

from __future__ import annotations

import time
from collections import deque
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

SETTLE_S = 60.0         # how long a request still out at the close is waited for
BATCH_GAP_S = 0.010     # answers further apart than this are of two batches


@dataclass
class Sent:
    """One request as the client saw it."""
    query: int                      # row of the query pool
    t_sent: float                   # submit called
    t_submitted: float = 0.0        # submit returned
    req: object = None
    t_back: Optional[float] = None  # when the client saw the answer
    resend: Optional["Sent"] = None  # the caller's next request


@dataclass
class Window:
    t_start: float
    t_end: float
    sent: List[Sent] = field(default_factory=list)

    def done_in_window(self) -> List[Sent]:
        return [s for s in self.sent
                if s.t_back is not None and s.t_back <= self.t_end
                and s.req.ok]


def closed_loop(submit: Callable, n_pool: int, *, clients: int, k: int,
                seconds: float) -> Window:
    t0 = time.perf_counter()
    win = Window(t0, t0 + seconds)
    nxt = 0
    out = deque()

    def send() -> Sent:
        nonlocal nxt
        s = Sent(nxt % n_pool, time.perf_counter())
        nxt += 1
        s.req = submit(s.query, k)
        s.t_submitted = time.perf_counter()
        win.sent.append(s)
        out.append(s)
        return s

    for _ in range(clients):
        send()
    while out:
        left = win.t_end + SETTLE_S - time.perf_counter()
        if left <= 0 or not out[0].req.wait(left):
            break
        now = time.perf_counter()
        back = []
        while out and out[0].req.done.is_set():
            s = out.popleft()
            s.t_back = now
            back.append(s)
        if now < win.t_end:
            for s in back:
                s.resend = send()
    deadline = win.t_end + SETTLE_S
    for s in win.sent:
        if s.t_back is None:
            left = deadline - time.perf_counter()
            if left > 0 and s.req.wait(left):
                s.t_back = time.perf_counter()
    return win


def resend_bursts(win: Window) -> np.ndarray:
    """One row per batch of answers that set off resends: (resends,
    seconds from the first resend's submit to the last's return, seconds
    spent inside ``submit``).  Answers seen within ``BATCH_GAP_S`` of the
    one before are one batch."""
    back = sorted((s for s in win.sent if s.resend is not None),
                  key=lambda s: s.t_back)
    rows, batch = [], []
    for s in back + [None]:
        if batch and (s is None or s.t_back - batch[-1].t_back
                      > BATCH_GAP_S):
            r = [b.resend for b in batch]
            rows.append((len(r),
                         max(x.t_submitted for x in r)
                         - min(x.t_sent for x in r),
                         sum(x.t_submitted - x.t_sent for x in r)))
            batch = []
        if s is not None:
            batch.append(s)
    return np.asarray(rows, np.float64).reshape(-1, 3)


def run(traffic: dict, submit: Callable, n_pool: int, *,
        seconds: float) -> Window:
    """One window of the mix ``traffic`` against ``submit(query_row, k)``."""
    if traffic["loop"] != "closed":
        raise ValueError(f"unknown loop kind {traffic['loop']!r}")
    return closed_loop(submit, n_pool, clients=int(traffic["clients"]),
                       k=int(traffic["k"]), seconds=seconds)
