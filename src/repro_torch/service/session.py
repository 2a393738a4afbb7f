"""Session façade: store + index + sharded verify + obs in one object.

``MatchSession`` wires an existing engine (``core.engine.MatchEngine``
— typically built device-resident via
``core.distributed.make_engine_service`` — or
``subseq.search.SubseqEngine``) behind the coalescing queue
(``service.queue``) and the telemetry-driven planner
(``service.planner``), producing the one servable object the launcher
(``launch/serve_match.py``) talks to:

* ``submit`` / ``serve`` — async single-query requests; waiting
  requests coalesce into one (Q, T) engine dispatch per batch.
* exact tiers stay EXACT: a planner-routed "index" or "linear" answer
  is bit-identical to calling ``engine.topk`` directly with that
  source, and a coalesced batch answers every request identically to
  dispatching it alone (batching neutrality) — both property-tested.
* deadline-threatened requests downgrade to the anytime "approx" tier
  and carry back ``kth_lb`` / ``error_bar`` (the certificate from
  ``index.candidates``), never a silent miss.
* every dispatch feeds the planner (``planner.observe``) and the obs
  registry (``serve.*`` metrics + optional per-request EXPLAIN trace).

Store I/O accounting is session-scoped: construction calls
``store.reset_counters()`` so a session's ``io`` numbers never bleed
in from whatever ran before it (and resetting never perturbs results
— covered by the metrics-concurrency tests).

Epoch-pinned serving: when the engine's store publishes corpus epochs
(``current_epoch`` — ``repro_torch.store.SymbolicStore`` and
``subseq.WindowView`` both do), every request is pinned to the epoch
current at ADMISSION and the dispatch answers as of that frontier
(``engine.topk(..., epoch=req.epoch)``) — bit-identical to a store
frozen at the pin, no matter how much is ingested between admission
and dispatch.  ``req.epoch`` reports the pin back to the caller.

Replicated dispatch: ``replicas=[engine2, ...]`` adds engines sharing
the primary's store behind the queue's per-replica workers; the
planner's per-replica EWMAs arbitrate placement and a replica failure
requeues (never sheds) — see ``service.queue``.  ``state_dir=``
persists the planner's learned estimates across restarts
(``save_state`` / seeded on construction).

Over a ``torch.distributed`` world of ranks the session runs on rank 0
and takes the fronts of ``service.world.WorldChannel`` for its engines:
every engine call is broadcast as an op that the other ranks replay in
the same order (see that module).  A raw engine over a world mesh is
refused (:func:`refuse_world`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import List, Optional, Sequence

import numpy as np

from repro_torch.obs import trace as obs_trace
from repro_torch.obs.trace import Recorder, Trace, span
from repro_torch.service.planner import TIERS, QueryPlanner
from repro_torch.service.queue import (SHED_DEADLINE, CoalescingQueue,
                                 MatchRequest)
from repro_torch.service.world import EngineFront, engine_mesh

#: File name of the persisted planner state inside ``state_dir``.
PLANNER_STATE = "planner.json"


def refuse_world(engine) -> None:
    """Raise for a raw engine over a mesh of more than one rank: the
    service calls its engines from several threads (the coalescing
    queue's dispatcher, the replica workers, a writer, the caller's
    oracle), and collectives issued from several threads do not line up
    across ranks.  Over a world the session takes the leader's fronts of
    ``service.world.WorldChannel`` instead, which put every engine call
    in one order that the other ranks replay."""
    if isinstance(engine, EngineFront):
        return
    mesh = engine_mesh(engine)
    if getattr(mesh, "world", 1) > 1:
        raise ValueError(
            f"the matching service does not call a raw engine over a world "
            f"mesh ({mesh.world} ranks): its threads would issue "
            f"collectives that do not line up across ranks; serve the "
            f"engine's front instead (repro_torch.service.world."
            f"WorldChannel(engines, group).fronts on rank 0, follow() on "
            f"the others)")


class MatchSession:
    """One always-on matching service over one engine (see module doc).

    Parameters
    ----------
    engine:      ``MatchEngine`` or ``SubseqEngine`` (auto-detected by
                 the presence of ``engine.view``).
    metrics:     ``repro_torch.obs.MetricsRegistry`` for ``serve.*`` metrics;
                 defaults to the engine's registry when it has one.
    planner:     inject a preconfigured ``QueryPlanner`` (tests); by
                 default one is built from the engine's store/index and
                 seeded from the registry's existing latency history.
    window_s / max_batch / max_queue: coalescing queue knobs.
    approx_collect: bounded-collect size for the approx tier (default
                 ``max(4k, 32)`` per request, the engine's own default).
    safety:      planner deadline-downgrade margin.
    replicas:    additional engines over the SAME store (same object —
                 validated) served behind per-replica dispatch workers;
                 the primary stays replica 0 and the oracle for
                 ``topk``/exactness tests.
    state_dir:   directory for persisted planner state; when it holds
                 a ``planner.json`` from a previous ``save_state`` the
                 planner starts from those learned estimates.
    span_log:    keep the last ``span_log`` program spans, of every thread,
                 (``repro_torch.obs.trace``: submit, queue wait,
                 coalescing, dispatch, the engine's sweep, rounds and
                 waits) in one bounded ``Trace``, read by :meth:`spans`
                 and exported by ``span_log.to_chrome()``; 0 (default)
                 keeps none.  The spans' seconds go to the registry's
                 ``<name>_s`` counters whenever ``metrics`` is set.
    """

    def __init__(self, engine, *, selfjoin=None, metrics=None,
                 planner=None,
                 window_s: float = 0.002, max_batch: int = 64,
                 max_queue: int = 256,
                 approx_collect: Optional[int] = None,
                 safety: float = 2.0,
                 replicas: Optional[Sequence] = None,
                 state_dir: Optional[str] = None,
                 span_log: int = 0):
        self.engine = engine
        self.engines = [engine] + list(replicas or [])
        for eng in self.engines + [selfjoin]:
            refuse_world(eng)
        self._subseq = hasattr(engine, "view")
        for i, eng in enumerate(self.engines[1:], start=1):
            shared = (getattr(eng, "view", None) is engine.view
                      if self._subseq
                      else getattr(eng, "store", None) is engine.store)
            if not shared:
                raise ValueError(
                    f"replica {i} does not share the primary engine's "
                    "store — replicas answer over ONE corpus")
        # optional repro_torch.profile.SelfJoinEngine: enables the corpus-
        # level "selfjoin" tier (kind="motifs"/"discords" requests)
        self._selfjoin = selfjoin
        if selfjoin is not None and self._subseq \
                and selfjoin.view is not engine.view:
            raise ValueError("selfjoin engine must share the session "
                             "engine's WindowView")
        self.metrics = metrics if metrics is not None \
            else getattr(engine, "metrics", None)
        self._approx_collect = approx_collect
        if self._subseq:
            view = engine.view
            self.query_len = int(view.m)
            self._store = view
            has_index = getattr(view, "index", None) is not None
            # the subsequence anytime tier routes through the window
            # index; without one there is no approx tier to downgrade to
            has_approx = has_index
            total = int(view.n)
        else:
            store = engine.store
            self.query_len = int(engine.encoder.T)
            self._store = store
            has_index = getattr(store, "index", None) is not None
            has_approx = True
            total = int(getattr(store, "n", None)
                        or store.data.shape[0])
        self.planner = planner if planner is not None else QueryPlanner(
            total=total, has_index=has_index, has_approx=has_approx,
            has_selfjoin=selfjoin is not None,
            store=self._store, safety=safety,
            approx_collect=approx_collect or 32)
        if planner is None:
            self.planner.seed_from_metrics(self.metrics)
        self.state_dir = state_dir
        if state_dir is not None:
            self._load_state(state_dir)
        # session-scoped I/O accounting (never perturbs results)
        if hasattr(self._store, "reset_counters"):
            self._store.reset_counters()
        self._plan_lock = threading.Lock()
        # epoch pinning: stamped at admission when the store publishes
        # a frontier (SymbolicStore / WindowView); legacy stores serve
        # unpinned, exactly as before
        epoch_fn = getattr(self._store, "current_epoch", None)
        if span_log < 0:
            raise ValueError(f"span_log must be >= 0, got {span_log}")
        self.span_log = (Trace("serve.spans", maxlen=int(span_log))
                         if span_log else None)
        self.recorder = (Recorder(self.metrics, self.span_log)
                         if self.metrics is not None
                         or self.span_log is not None else None)
        n_rep = len(self.engines)
        self.queue = CoalescingQueue(
            self._dispatch, validate=self._validate, window_s=window_s,
            max_batch=max_batch, max_queue=max_queue,
            metrics=self.metrics, n_replicas=n_rep,
            place=self._place if n_rep > 1 else None,
            epoch_fn=epoch_fn, recorder=self.recorder)

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> "MatchSession":
        self.queue.start()
        return self

    def close(self, *, drain: bool = True) -> None:
        self.queue.close(drain=drain)
        if self.state_dir is not None:
            self.save_state()

    def kill_replica(self, replica: int) -> int:
        """Take one replica out of service (failure injection / drain):
        pending batches on it are REQUEUED on the survivors, never
        shed.  Returns the number of rerouted requests."""
        return self.queue.kill(replica)

    # -- planner persistence -----------------------------------------------
    def save_state(self, directory: Optional[str] = None) -> str:
        """Persist the planner's learned estimates (tier EWMAs + per-
        replica placement EWMAs) as ``planner.json`` under
        ``directory`` (default: the session's ``state_dir``).  A later
        session built with ``state_dir=`` starts from them instead of
        the modeled priors.  Atomic: written to a temp file, then
        renamed."""
        d = directory or self.state_dir
        if d is None:
            raise ValueError("no directory given and the session has "
                             "no state_dir")
        os.makedirs(d, exist_ok=True)
        with self._plan_lock:
            state = {"planner": self.planner.snapshot(),
                     "replicas": self.planner.replicas_snapshot()}
        path = os.path.join(d, PLANNER_STATE)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(state, f, indent=1)
        os.replace(tmp, path)
        return path

    def _load_state(self, directory: str) -> None:
        path = os.path.join(directory, PLANNER_STATE)
        if not os.path.exists(path):
            return
        try:
            with open(path) as f:
                state = json.load(f)
        except (OSError, ValueError):
            return                      # unreadable state: start fresh
        self.planner.seed_from_snapshot(state.get("planner") or {},
                                        state.get("replicas") or {})

    def __enter__(self) -> "MatchSession":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.close(drain=not any(exc))

    # -- client surface ----------------------------------------------------
    def submit(self, query, *, k: int = 1,
               deadline_s: Optional[float] = None,
               tier: Optional[str] = None,
               explain: bool = False) -> MatchRequest:
        """Enqueue one single-query request; returns immediately.  The
        request resolves (served or shed-with-reason) via ``req.wait()``
        — it is never silently dropped."""
        # the ``serve.submit`` span: from here to admission, closed by
        # the dispatch that takes the request (this thread takes no lock
        # of the registry's)
        t_call = obs_trace.clock_ns() if self.recorder is not None else 0
        req = MatchRequest(query=np.asarray(query, np.float32), k=int(k),
                           deadline_s=deadline_s, tier=tier,
                           explain=explain, t_call_ns=t_call)
        self.queue.submit(req)
        return req

    def spans(self) -> list:
        """The span log's spans, oldest first (empty without a log)."""
        return [] if self.span_log is None else list(self.span_log.spans)

    def submit_selfjoin(self, kind: str = "motifs", *, k: int = 1,
                        deadline_s: Optional[float] = None,
                        explain: bool = False) -> MatchRequest:
        """Enqueue one corpus-level self-join request
        (``kind="motifs"`` or ``"discords"``); requires the session to
        have been built with a ``selfjoin=`` engine.  The resolved
        request carries the ``repro_torch.profile.topk_motifs`` /
        ``topk_discords`` tuple list in ``req.result`` — exact (bit-
        identical to the brute-force profile oracle), served from the
        engine's cached matrix profile after the first dispatch."""
        req = MatchRequest(query=np.empty(0, np.float32), k=int(k),
                           deadline_s=deadline_s, tier="selfjoin",
                           explain=explain, kind=kind)
        self.queue.submit(req)
        return req

    def serve(self, queries, *, k: int = 1,
              deadline_s: Optional[float] = None,
              tier: Optional[str] = None,
              timeout: Optional[float] = 60.0) -> List[MatchRequest]:
        """Convenience closed-loop batch: submit every query, wait for
        all of them, return the resolved requests in submit order."""
        reqs = [self.submit(q, k=k, deadline_s=deadline_s, tier=tier)
                for q in np.atleast_2d(np.asarray(queries, np.float32))]
        for r in reqs:
            r.wait(timeout)
        return reqs

    def topk(self, queries, k: int = 1, **kw):
        """Direct synchronous engine passthrough (the oracle the
        service's exactness property tests compare against)."""
        return self.engine.topk(queries, k=k, **kw)

    def calibrate(self, sample=None, *, k: int = 1) -> dict:
        """Prime the planner's rolling estimates by running each
        servable tier once, directly, over ``sample`` (default: one
        median query of zeros — enough for a latency observation).
        Returns the planner snapshot."""
        if sample is None:
            sample = np.zeros((1, self.query_len), np.float32)
        qs = np.atleast_2d(np.asarray(sample, np.float32))
        for tier in TIERS:
            if not self.planner.servable(tier):
                continue
            t0 = time.perf_counter()
            res = self._run_tier(qs, k, tier, None)
            with self._plan_lock:
                self.planner.observe(tier, qs.shape[0],
                                     time.perf_counter() - t0, res)
        return self.planner.snapshot()

    # -- admission ---------------------------------------------------------
    def _validate(self, req: MatchRequest) -> Optional[str]:
        if req.kind != "topk":
            if req.kind not in ("motifs", "discords"):
                return (f"unknown request kind {req.kind!r} "
                        "(kinds: topk, motifs, discords)")
            if self._selfjoin is None:
                return "self-join tier is not configured on this session"
            if req.k < 1:
                return f"k must be >= 1, got {req.k}"
            return None
        q = np.asarray(req.query)
        if q.ndim != 1 or q.shape[0] != self.query_len:
            return (f"query shape {q.shape} does not match service "
                    f"query length ({self.query_len},)")
        if not np.all(np.isfinite(q)):
            return "query contains non-finite values"
        if req.k < 1:
            return f"k must be >= 1, got {req.k}"
        if req.tier is not None:
            if req.tier not in TIERS:
                return f"unknown tier {req.tier!r} (tiers: {TIERS})"
            if not self.planner.servable(req.tier):
                return f"tier {req.tier!r} is not servable here"
        return None

    # -- placement ---------------------------------------------------------
    def _place(self, live, depths) -> int:
        """Queue placement hook (replicated sessions): the planner's
        EWMA arbiter under the plan lock."""
        with self._plan_lock:
            return self.planner.place(live, depths)

    # -- dispatch ----------------------------------------------------------
    def _dispatch(self, batch: List[MatchRequest],
                  replica: int = 0) -> None:
        """One coalesced engine round: shed the already-expired, route
        the rest, run one engine call per (tier, k, epoch) group,
        scatter the per-request slices back.  Runs on the dispatcher
        thread (or a replica worker when replicated — ``replica`` says
        which engine serves this batch).

        Requests carrying different pinned epochs never share an
        engine call: the group key includes the epoch's visible row
        count, so each call answers exactly as of its own frontier."""
        now = time.monotonic()
        groups: dict = {}
        selfjoin: List[MatchRequest] = []
        for req in batch:
            if req.t_deadline is not None and now >= req.t_deadline:
                self.queue.shed(req, SHED_DEADLINE,
                                "deadline expired while queued")
                continue
            left = (req.t_deadline - now
                    if req.t_deadline is not None else None)
            if req.kind != "topk":
                # corpus-level requests are forced onto the selfjoin
                # tier (the planner carries its estimate but never
                # routes per-query traffic there)
                with self._plan_lock:
                    req.plan = self.planner.route(k=req.k,
                                                  deadline_left=left,
                                                  tier="selfjoin")
                selfjoin.append(req)
                continue
            with self._plan_lock:
                plan = self.planner.route(k=req.k, deadline_left=left,
                                          tier=req.tier)
            req.plan = plan
            if plan.downgraded and self.metrics is not None:
                self.metrics.counter("serve.downgraded").inc()
            ep_key = (None if req.epoch is None
                      else int(getattr(req.epoch, "n_rows", req.epoch)))
            groups.setdefault((plan.tier, req.k, ep_key),
                              []).append(req)
        for (tier, k, _), reqs in groups.items():
            self._run_group(tier, k, reqs, replica=replica)
        if selfjoin:
            self._run_selfjoin(selfjoin, replica=replica)

    @staticmethod
    def _bucket(qs: np.ndarray) -> np.ndarray:
        """Pad a coalesced batch up to the next power-of-two row count
        (repeating the last query).  It keeps the reference's padded
        shapes: a coalesced request's sweep runs at one of
        log2(max_batch) + 1 batch sizes, so its bits do not depend on
        how many neighbours it had (the tSAX / stSAX sweeps are plain
        broadcast reductions whose order a device library may pick by
        shape).  Pad rows are real duplicate queries, answered
        independently and sliced off (the batching-neutrality tests)."""
        q_n = qs.shape[0]
        pow2 = 1 << (q_n - 1).bit_length()
        if pow2 == q_n:
            return qs
        return np.concatenate(
            [qs, np.repeat(qs[-1:], pow2 - q_n, axis=0)])

    def _run_group(self, tier: str, k: int,
                   reqs: Sequence[MatchRequest], *,
                   replica: int = 0) -> None:
        # re-check deadlines PER DISPATCH, immediately before the
        # engine call: earlier groups of the same coalesced batch take
        # real wall time, so a deadline alive at routing can be dead by
        # now — serving it anyway would bill an expired request as met
        now = time.monotonic()
        live = []
        for req in reqs:
            if req.t_deadline is not None and now >= req.t_deadline:
                self.queue.shed(req, SHED_DEADLINE,
                                "deadline expired before dispatch")
            else:
                live.append(req)
        reqs = live
        if not reqs:
            return
        epoch = reqs[0].epoch           # group key pins one frontier
        qs = self._bucket(np.stack([r.query for r in reqs])
                          .astype(np.float32))
        trace = None
        if any(r.explain for r in reqs):
            trace = Trace("serve.dispatch")
        with span("serve.group", timed=True) as group:
            res = self._run_tier(qs, k, tier, trace, epoch=epoch,
                                 replica=replica)
        wall = group.seconds
        with self._plan_lock:
            self.planner.observe(tier, qs.shape[0], wall, res)
            if len(self.engines) > 1:
                self.planner.observe_replica(replica, wall)
        ids = getattr(res, "window_ids", None)
        if ids is None:
            ids = res.indices
        kth_lb = getattr(res, "kth_lb", None)
        error_bar = getattr(res, "error_bar", None)
        for i, req in enumerate(reqs):
            req.indices = np.asarray(ids[i]).copy()
            req.distances = np.asarray(res.distances[i]).copy()
            if self._subseq:
                req.rows = np.asarray(res.rows[i]).copy()
                req.starts = np.asarray(res.starts[i]).copy()
            if kth_lb is not None:
                req.kth_lb = float(np.atleast_1d(kth_lb)[i])
            if error_bar is not None:
                req.error_bar = float(np.atleast_1d(error_bar)[i])
            req.tier_served = tier
            req.replica = replica
            req.trace = trace
            req.t_done = time.monotonic()
            if self.metrics is not None:
                self.metrics.histogram(
                    "serve.request_latency_s").observe(req.latency_s)
                self.metrics.counter(f"serve.tier.{tier}").inc()
            req.done.set()

    def _run_selfjoin(self, reqs: Sequence[MatchRequest],
                      replica: int = 0) -> None:
        """One self-join dispatch: compute (or reuse) the engine's
        cached matrix profile, then answer every request from it —
        motifs and discords are pure functions of the profile
        (``repro_torch.profile``), so every coalesced request sees the same
        exact profile.

        Self-join requests are the one kind NOT answered at the
        admission epoch: the profile is a whole-corpus artifact and its
        cache keys on the live corpus, so the answer is as of the
        DISPATCH-time frontier — ``req.epoch`` is re-pinned here to
        report the frontier actually answered."""
        from repro_torch.profile import topk_discords, topk_motifs
        eng = self._selfjoin
        ep_fn = getattr(self._store, "current_epoch", None)
        trace = None
        if any(r.explain for r in reqs):
            trace = Trace("serve.selfjoin")
        dispatch_epoch = ep_fn() if ep_fn is not None else None
        with span("serve.group", timed=True) as group:
            prof = eng.profile(trace=trace)
        wall = group.seconds
        with self._plan_lock:
            self.planner.observe("selfjoin", len(reqs), wall, prof)
        for req in reqs:
            if req.kind == "motifs":
                req.result = topk_motifs(prof, eng.view.locate, req.k)
            else:
                req.result = topk_discords(prof, eng.view.locate, req.k)
            req.tier_served = "selfjoin"
            req.replica = replica
            req.epoch = dispatch_epoch
            req.trace = trace
            req.t_done = time.monotonic()
            if self.metrics is not None:
                self.metrics.histogram(
                    "serve.request_latency_s").observe(req.latency_s)
                self.metrics.counter("serve.tier.selfjoin").inc()
            req.done.set()

    def _run_tier(self, qs: np.ndarray, k: int, tier: str, trace, *,
                  epoch=None, replica: int = 0):
        """One engine call for one (tier, k, epoch) group on one
        replica.  Exact tiers call ``engine.topk`` with exactly the
        source (and epoch) a direct caller would pass — the
        bit-identity contract depends on adding nothing else."""
        collect = (self._approx_collect
                   if self._approx_collect is not None else None)
        eng = self.engines[replica]
        if self._subseq:
            if tier == "approx":
                return eng.topk_approx(qs, k=k, collect=collect,
                                       trace=trace, epoch=epoch)
            return eng.topk(qs, k=k,
                            use_index=(tier == "index"),
                            trace=trace, epoch=epoch)
        if tier == "approx":
            return eng.topk_approx(qs, k=k, collect=collect,
                                   trace=trace, epoch=epoch)
        return eng.topk(qs, k=k,
                        source="index" if tier == "index"
                        else None, trace=trace, epoch=epoch)

    # -- reporting ---------------------------------------------------------
    def snapshot(self) -> dict:
        """Service-level JSON view: planner estimates + queue depth."""
        return {"planner": self.planner.snapshot(),
                "replica_wall_s": self.planner.replicas_snapshot(),
                "n_replicas": len(self.engines),
                "live_replicas": self.queue.live_replicas(),
                "queue_depth": self.queue.depth(),
                "window_s": self.queue.window_s,
                "max_batch": self.queue.max_batch}
