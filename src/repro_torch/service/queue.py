"""Async request queue with coalescing dispatch and graceful shedding.

The front half of the always-on matching service: callers ``submit``
single-query requests from any thread; a dispatcher thread coalesces
whatever is waiting (up to ``max_batch``, after at most ``window_s`` of
batching delay anchored at the first queued request) into ONE engine
dispatch — the kernels and ``core.engine.topk_verify`` are already
multi-query, so a coalesced (Q, T) batch costs one encode, one
candidate ordering and one sharded verification round-trip instead of
Q of each.

Admission control follows the reference's serving engine
(``ServeEngine.admit`` in the JAX package) in shape and in the
``serve.*`` metric names: a request that cannot be served is REJECTED
WITH A REASON (``req.error`` set, ``req.done`` event set,
``serve.rejected`` incremented) — never silently dropped.  Every shed
is additionally counted under ``serve.shed.<reason>``, so the shed
accounting always sums to the rejected count.

Shed reasons:

* ``queue_full``        — backlog at ``max_queue`` (admission time).
* ``deadline_expired``  — the per-request deadline passed while queued
  (dispatch time) or was non-positive at submit.
* ``bad_query``         — malformed request (wrong length, bad k, an
  unservable tier override); admission time, via the session's
  validator.
* ``shutdown``          — the service stopped before dispatch and was
  closed without draining.
* ``engine_error``      — the dispatch callback raised; every request
  of the failed batch is shed with the exception text.

The queue itself never looks inside a result: the ``dispatch(batch)``
callback (``repro_torch.service.session.MatchSession``) owns planning,
engine calls and response fill-in.  Deadline-expiry shedding at
dispatch time also lives in the session (it holds the clock) through
:meth:`CoalescingQueue.shed`.

Epoch pinning: when the queue is built with ``epoch_fn`` (the store's
``current_epoch``), every request is stamped with the corpus epoch
current AT ADMISSION (``req.epoch``) — the downstream dispatch answers
as of that frontier, so an answer is consistent with the corpus the
caller saw when it submitted, regardless of concurrent ingest.

Replicated dispatch: with ``n_replicas > 1`` the coalescer no longer
dispatches inline; it routes each coalesced batch to one of N replica
inboxes (placement by the injected ``place(live, depths)`` — the
planner's EWMA arbiter — falling back to least-depth) and a worker
thread per replica drains its inbox through ``dispatch(batch,
replica)``.  A replica dispatch failure REQUEUES the batch's
unresolved requests on another live replica (``serve.requeued``)
instead of shedding, as does :meth:`kill` (``serve.replica_killed``);
only a batch that has failed on every live replica is shed with
``engine_error``.  With ``n_replicas == 1`` the dispatch path is
byte-identical to the unreplicated queue.
"""

from __future__ import annotations

import itertools
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import recording, span

SHED_QUEUE_FULL = "queue_full"
SHED_DEADLINE = "deadline_expired"
SHED_BAD_QUERY = "bad_query"
SHED_SHUTDOWN = "shutdown"
SHED_ENGINE_ERROR = "engine_error"

_RID = itertools.count()


@dataclass
class MatchRequest:
    """One single-query matching request and its response slot.

    Callers fill the top block at ``submit`` time; the service fills
    the rest and fires ``done``.  ``error`` follows the
    reference's ``ServeEngine.admit`` contract: None means served;
    a string is the reject/shed explanation (``shed_reason`` carries
    the machine-readable reason code)."""

    query: np.ndarray                   # (T,) raw query
    k: int = 1
    deadline_s: Optional[float] = None  # latency budget from submit
    tier: Optional[str] = None          # explicit tier override
    explain: bool = False               # attach a repro_torch.obs trace
    kind: str = "topk"                  # "topk" | "motifs" | "discords"
    #   corpus self-join kinds carry no query of their own (the corpus
    #   is both sides); the session routes them to the SelfJoinEngine
    #   tier and fills ``result`` with the (window, ...) tuple list

    rid: int = field(default_factory=lambda: next(_RID))
    t_submit: float = 0.0
    t_call_ns: int = 0                  # ``submit`` called and the request
    t_submit_ns: int = 0                # admitted, on the spans' clock
    #   (stamped only when the service records spans)
    dispatch: Optional[int] = None      # the dispatch that first took it
    #   (marked only when the service records spans)
    t_deadline: Optional[float] = None
    t_done: float = 0.0
    epoch: Optional[object] = None      # corpus frontier pinned at
    #   admission (``repro_torch.store.CorpusEpoch``); the answer is exact as
    #   of this frontier regardless of concurrent ingest
    replica: Optional[int] = None       # replica that served it
    requeues: int = 0                   # replica-failover reroutes

    indices: Optional[np.ndarray] = None    # (k,) best ids
    distances: Optional[np.ndarray] = None  # (k,) true d_ED
    rows: Optional[np.ndarray] = None       # subsequence mode only
    starts: Optional[np.ndarray] = None
    kth_lb: Optional[float] = None          # approx tier certificate
    error_bar: Optional[float] = None
    tier_served: Optional[str] = None
    plan: Optional[object] = None           # planner.PlanDecision
    trace: Optional[object] = None
    result: Optional[object] = None         # self-join kinds: the
    #   topk_motifs / topk_discords tuple list of ``repro_torch.profile``

    error: Optional[str] = None
    shed_reason: Optional[str] = None
    done: threading.Event = field(default_factory=threading.Event)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until served or shed; True when the request finished."""
        return self.done.wait(timeout)

    @property
    def ok(self) -> bool:
        return self.done.is_set() and self.error is None

    @property
    def latency_s(self) -> float:
        return self.t_done - self.t_submit


class CoalescingQueue:
    """Thread-safe coalescing request queue (see module docstring).

    Parameters
    ----------
    dispatch:   ``dispatch(batch: list[MatchRequest]) -> None`` — runs
                on the dispatcher thread, must fill every request and
                set its ``done`` event (or shed it via :meth:`shed`).
    validate:   optional ``validate(req) -> Optional[str]`` admission
                hook; a returned message rejects with ``bad_query``.
    window_s:   coalescing window — after the first request of a batch
                arrives, wait at most this long for more before
                dispatching (0: dispatch whatever is queued
                immediately; coalescing then only captures requests
                that raced in together).
    max_batch:  dispatch at most this many requests per engine call
                (1: serial dispatch, the bench baseline).
    max_queue:  admission backlog bound; beyond it submits shed with
                ``queue_full``.
    metrics:    optional ``repro_torch.obs.MetricsRegistry`` (``serve.*``).
    clock:      injectable monotonic clock (tests).
    n_replicas: engine replicas behind ``dispatch``.  1 (default):
                inline dispatch on the coalescer thread,
                ``dispatch(batch)``.  > 1: per-replica inboxes + worker
                threads, ``dispatch(batch, replica)``; failures requeue
                on surviving replicas (see module docstring).
    place:      optional ``place(live, depths) -> replica`` arbiter
                (the planner's EWMA placement); default least-depth.
    epoch_fn:   optional zero-arg frontier supplier (the store's
                ``current_epoch``); stamped onto ``req.epoch`` at
                admission.
    recorder:   optional ``repro_torch.obs.Recorder``: the dispatcher's
                spans (``serve.coalesce``, ``serve.dispatch``, each
                request's ``serve.submit`` and ``serve.queue``), and the
                thread's recorder for every dispatch.
    """

    def __init__(self, dispatch: Callable, *,
                 validate: Optional[Callable] = None,
                 window_s: float = 0.002, max_batch: int = 64,
                 max_queue: int = 256, metrics=None,
                 clock: Callable[[], float] = time.monotonic,
                 n_replicas: int = 1,
                 place: Optional[Callable] = None,
                 epoch_fn: Optional[Callable] = None,
                 recorder=None):
        if max_batch < 1:
            raise ValueError("max_batch must be >= 1")
        if n_replicas < 1:
            raise ValueError("n_replicas must be >= 1")
        self._dispatch = dispatch
        self._validate = validate
        self.window_s = float(window_s)
        self.max_batch = int(max_batch)
        self.max_queue = int(max_queue)
        self.metrics = metrics
        self._clock = clock
        self._q: List[MatchRequest] = []
        self._cond = threading.Condition()
        self._stop = False
        self._thread: Optional[threading.Thread] = None
        self.n_replicas = int(n_replicas)
        self._place = place
        self._epoch_fn = epoch_fn
        self.recorder = recorder
        self._dids = itertools.count()
        # replicated-dispatch state (used only when n_replicas > 1):
        # per-replica batch inboxes + busy flags under one condition,
        # the dead set, and one worker thread per replica
        self._rcond = threading.Condition()
        self._inbox = {r: [] for r in range(self.n_replicas)}
        self._busy = {r: False for r in range(self.n_replicas)}
        self._dead: set = set()
        self._workers: List[threading.Thread] = []
        self._wstop = False

    # -- admission ---------------------------------------------------------
    def shed(self, req: MatchRequest, reason: str, msg: str) -> None:
        """Reject/shed one request with a reason — the never-silent-drop
        primitive.  The reference's ``ServeEngine.admit`` shape (error
        string, done flag, ``serve.rejected``) and adds the per-reason
        ``serve.shed.<reason>`` counter the accounting gate sums."""
        req.error = msg
        req.shed_reason = reason
        req.t_done = self._clock()
        if self.metrics is not None:
            self.metrics.counter("serve.rejected").inc()
            self.metrics.counter(f"serve.shed.{reason}").inc()
        req.done.set()

    def submit(self, req: MatchRequest) -> bool:
        """Admit a request (thread-safe).  Returns False when the
        request was rejected — ``req.error`` / ``req.shed_reason`` say
        why; the request is always resolved, never silently dropped."""
        now = self._clock()
        if self._stop:
            self.shed(req, SHED_SHUTDOWN, "service is shut down")
            return False
        if self._validate is not None:
            msg = self._validate(req)
            if msg is not None:
                self.shed(req, SHED_BAD_QUERY, msg)
                return False
        if req.deadline_s is not None and req.deadline_s <= 0:
            self.shed(req, SHED_DEADLINE,
                      f"deadline budget {req.deadline_s}s is not positive")
            return False
        with self._cond:
            if len(self._q) >= self.max_queue:
                self.shed(req, SHED_QUEUE_FULL,
                          f"queue at capacity ({self.max_queue})")
                return False
            req.t_submit = now
            if req.deadline_s is not None:
                req.t_deadline = now + req.deadline_s
            if req.epoch is None and self._epoch_fn is not None:
                # pin the corpus frontier AT ADMISSION: the answer is
                # exact as of what the caller could observe now, not as
                # of whenever dispatch happens to run
                req.epoch = self._epoch_fn()
            if self.recorder is not None:
                req.t_submit_ns = obs_trace.clock_ns()
            self._q.append(req)
            self._cond.notify_all()
        if self.metrics is not None:
            self.metrics.counter("serve.requests").inc()
        return True

    def depth(self) -> int:
        with self._cond:
            return len(self._q)

    # -- dispatcher --------------------------------------------------------
    def start(self) -> "CoalescingQueue":
        if self._thread is not None:
            return self
        self._stop = False
        if self.n_replicas > 1 and not self._workers:
            self._wstop = False
            for r in range(self.n_replicas):
                t = threading.Thread(target=self._worker, args=(r,),
                                     name=f"match-replica-{r}",
                                     daemon=True)
                t.start()
                self._workers.append(t)
        self._thread = threading.Thread(target=self._loop,
                                        name="match-dispatch", daemon=True)
        self._thread.start()
        return self

    def close(self, *, drain: bool = True) -> None:
        """Stop the dispatcher.  ``drain=True`` serves everything still
        queued (one final coalesced dispatch per ``max_batch``, routed
        through the replicas when replicated); ``drain=False`` sheds
        the backlog (and any replica-inbox pending) with
        ``shutdown``."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        while True:
            with self._cond:
                batch = self._q[:self.max_batch]
                del self._q[:self.max_batch]
            if not batch:
                break
            if drain:
                if self.n_replicas > 1:
                    self._route_batch(batch)
                else:
                    self._run_batch(batch)
            else:
                for r in batch:
                    self.shed(r, SHED_SHUTDOWN,
                              "service shut down before dispatch")
        if self.n_replicas > 1:
            with self._rcond:
                if not drain:
                    for inbox in self._inbox.values():
                        for batch, _ in inbox:
                            for r in batch:
                                self.shed(r, SHED_SHUTDOWN,
                                          "service shut down before "
                                          "dispatch")
                        inbox.clear()
                else:       # wait for the workers to drain their inboxes
                    while any(self._inbox[r] or self._busy[r]
                              for r in self._inbox
                              if r not in self._dead):
                        self._rcond.wait()
                self._wstop = True
                self._rcond.notify_all()
            for t in self._workers:
                t.join()
            self._workers = []

    def _loop(self) -> None:
        with recording(self.recorder):
            while True:
                with self._cond:
                    while not self._q and not self._stop:
                        self._cond.wait()
                    if self._stop:
                        return           # close() drains or sheds the rest
                    # coalescing window, anchored at the first queued
                    # request this batch: wait (briefly) for more traffic
                    with span("serve.coalesce"):
                        t_close = self._clock() + self.window_s
                        while (len(self._q) < self.max_batch
                               and not self._stop):
                            left = t_close - self._clock()
                            if left <= 0:
                                break
                            self._cond.wait(timeout=left)
                        batch = self._q[:self.max_batch]
                        del self._q[:self.max_batch]
                if batch:
                    if self.n_replicas > 1:
                        self._route_batch(batch)
                    else:
                        self._run_batch(batch)

    def _took(self, batch: List[MatchRequest], sp) -> None:
        """Number the dispatch ``sp`` (its open ``serve.dispatch`` span)
        and close, for each request it is the first to take, the
        request's ``serve.submit`` (``submit`` called to admission) and
        ``serve.queue`` (admission to this dispatch) spans."""
        did = sp.ident = next(self._dids)
        rec, t_took = self.recorder, sp.start_ns
        log = rec.log is not None
        n = call_ns = queue_ns = 0
        for r in batch:
            if r.dispatch is None and r.t_submit_ns:
                r.dispatch = did
                queue_ns += t_took - r.t_submit_ns
                if r.t_call_ns:
                    n += 1
                    call_ns += r.t_submit_ns - r.t_call_ns
                if log:
                    if r.t_call_ns:
                        rec.record("serve.submit", r.t_call_ns,
                                   r.t_submit_ns, ident=r.rid)
                    rec.record("serve.queue", r.t_submit_ns, t_took,
                               ident=r.rid, meta={"dispatch": did})
        rec.add("serve.submit", call_ns, count="serve.submit_calls", n=n)
        rec.add("serve.queue_wait", queue_ns)

    def _run_batch(self, batch: List[MatchRequest]) -> None:
        """Unreplicated dispatch (n_replicas == 1): inline on the
        coalescer thread — byte-identical to the pre-replica queue."""
        if self.metrics is not None:
            self.metrics.counter("serve.batches").inc()
            self.metrics.counter("serve.batched_requests").inc(len(batch))
        with recording(self.recorder), span("serve.dispatch") as sp:
            if sp is not None:
                self._took(batch, sp)
            try:
                self._dispatch(batch)
            except Exception as e:  # noqa: BLE001 — resolve, never hang
                for r in batch:
                    if not r.done.is_set():
                        self.shed(r, SHED_ENGINE_ERROR,
                                  f"{type(e).__name__}: {e}")
            for r in batch:      # belt-and-braces: a dispatch must never
                if not r.done.is_set():  # leave a caller blocked forever
                    self.shed(r, SHED_ENGINE_ERROR,
                              "dispatch returned without resolving "
                              "request")

    # -- replicated dispatch ----------------------------------------------
    def _route_batch(self, batch: List[MatchRequest],
                     attempts: int = 0, exclude: Optional[int] = None
                     ) -> None:
        """Place one coalesced batch on a live replica's inbox.
        ``attempts`` counts replicas that already failed this batch;
        ``exclude`` avoids re-placing on the replica that just failed
        (it stays eligible for FUTURE batches — one poisoned batch must
        not mark every replica it visits dead)."""
        with self._rcond:
            live = [r for r in range(self.n_replicas)
                    if r not in self._dead and r != exclude]
            if not live:
                live = [r for r in range(self.n_replicas)
                        if r not in self._dead]
            if not live:
                for r in batch:
                    if not r.done.is_set():
                        self.shed(r, SHED_ENGINE_ERROR,
                                  "no live replicas")
                return
            depths = {r: len(self._inbox[r]) + int(self._busy[r])
                      for r in live}
            if self._place is not None:
                rid = int(self._place(live, depths))
                if rid not in depths:
                    rid = min(live, key=lambda r: (depths[r], r))
            else:
                rid = min(live, key=lambda r: (depths[r], r))
            self._inbox[rid].append((batch, attempts))
            self._rcond.notify_all()

    def _worker(self, rid: int) -> None:
        while True:
            with self._rcond:
                while not self._inbox[rid] and not self._wstop \
                        and rid not in self._dead:
                    self._rcond.wait()
                if self._wstop or rid in self._dead:
                    return       # kill() / close() reroute or shed pending
                batch, attempts = self._inbox[rid].pop(0)
                self._busy[rid] = True
            try:
                self._run_replica_batch(batch, rid, attempts)
            finally:
                with self._rcond:
                    self._busy[rid] = False
                    self._rcond.notify_all()

    def _run_replica_batch(self, batch: List[MatchRequest], rid: int,
                           attempts: int) -> None:
        if self.metrics is not None:
            self.metrics.counter("serve.batches").inc()
            self.metrics.counter("serve.batched_requests").inc(len(batch))
        with recording(self.recorder), span("serve.dispatch") as sp:
            if sp is not None:
                self._took(batch, sp)
            self._replica_dispatch(batch, rid, attempts)

    def _replica_dispatch(self, batch: List[MatchRequest], rid: int,
                          attempts: int) -> None:
        try:
            self._dispatch(batch, rid)
        except Exception as e:  # noqa: BLE001 — requeue, then shed
            pending = [r for r in batch if not r.done.is_set()]
            if pending and attempts + 1 < self.n_replicas and any(
                    r != rid and r not in self._dead
                    for r in range(self.n_replicas)):
                # replica failure: the batch survives — requeue the
                # unresolved requests on another live replica
                for r in pending:
                    r.requeues += 1
                if self.metrics is not None:
                    self.metrics.counter("serve.requeued").inc(
                        len(pending))
                self._route_batch(pending, attempts + 1, exclude=rid)
                return
            for r in pending:
                self.shed(r, SHED_ENGINE_ERROR,
                          f"{type(e).__name__}: {e}")
        for r in batch:          # belt-and-braces: a dispatch must never
            if not r.done.is_set():      # leave a caller blocked forever
                self.shed(r, SHED_ENGINE_ERROR,
                          "dispatch returned without resolving request")

    def kill(self, rid: int) -> int:
        """Simulate/handle replica death: mark ``rid`` dead (no future
        placements; its worker exits) and REQUEUE its pending inbox
        batches on the surviving replicas — death sheds nothing.
        Returns the number of requests rerouted."""
        if not 0 <= rid < self.n_replicas:
            raise ValueError(f"no replica {rid}")
        with self._rcond:
            self._dead.add(rid)
            pending = list(self._inbox[rid])
            self._inbox[rid].clear()
            self._rcond.notify_all()
        if self.metrics is not None:
            self.metrics.counter("serve.replica_killed").inc()
        moved = 0
        for batch, attempts in pending:
            alive = [r for r in batch if not r.done.is_set()]
            if not alive:
                continue
            for r in alive:
                r.requeues += 1
            moved += len(alive)
            self._route_batch(alive, attempts)
        if moved and self.metrics is not None:
            self.metrics.counter("serve.requeued").inc(moved)
        return moved

    def live_replicas(self) -> List[int]:
        with self._rcond:
            return [r for r in range(self.n_replicas)
                    if r not in self._dead]
