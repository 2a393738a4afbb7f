"""Per-query tracing: the ``Trace`` / ``Span`` API.

A ``Trace`` is created per engine call (``MatchEngine.topk(trace=...)``
/ ``explain=True``) and carries three layers of telemetry:

* **Spans** — wall-clocked phases.  ``with trace.span("verify"):``
  records a ``Span`` whose name is the '/'-joined path of the open span
  stack (``"order/seed"`` for the tree seed verification nested inside
  candidate generation).  When the traced region ends in device work,
  pass ``fence=tensors`` so the span synchronizes the tensors' CUDA
  devices before closing — kernel timings are then honest rather than
  launch timings.  Fencing only runs when a trace is active, and only *after*
  the traced computation, so it can never change results or store
  accounting (observability neutrality).
* **Rounds** — one dict per verification round
  (``core.engine.topk_verify`` / ``verify_candidates``): phase
  (seed/scan), active query count, candidates examined, the per-query
  k-th-best bound after the merge (the pruning threshold's evolution),
  and per-round wall clock.
* **Meta** — accumulated scalars and per-query arrays
  (``trace.add``): candidates generated / examined / verified, rows
  fetched, modeled seeks, modeled I/O seconds, device<->host byte
  counters.  ``add`` sums numerics and numpy arrays elementwise, so
  multi-round paths (exclusion widening, seed + scan) accumulate
  instead of overwriting.  Because ``add`` sums, a candidate handed to
  two widening rounds counts once per round — a per-round total, not a
  dedup count.  The engines therefore also record the id sets behind
  ``generated`` (``note_ids`` / ``note_counts``) and finalize a
  deduplicated ``generated_unique`` per-query array into meta next to
  the accumulated total (equal on single-round paths, strictly smaller
  under exclusion widening).

Zero-overhead-when-off contract: every instrumentation site in the
matching stack is guarded by ``trace is None`` (or uses
:func:`maybe_span`, which returns a shared null context) — with no
trace the hot loops execute exactly the pre-observability instruction
stream.

``to_dict()`` is plain JSON (numpy converted), in the JAX package's
trace schema, plus each span's two clock stamps.

Program spans
-------------
Beside the per-call trace, the served path records **program spans**
through a :class:`Recorder` (a ``MetricsRegistry`` and/or a bounded
``Trace`` used as a span log).  One call site, ``with span(name):``,
does three things:

* with a registry attached, the closed span adds its seconds to the
  counter ``<name>_s`` (a bare name such as ``"wait"`` is qualified by
  its parent: ``match.round.wait_s``), and to ``count`` the span's ``n``
  (1 unless the block sets it);
* with a log attached, it appends a :class:`Span` with its parent's id,
  the id of its dispatch or request (``ident``, inherited from the
  parent) and its thread; ``Trace.to_chrome`` exports the log;
* with neither, it is the shared null context: no ``Span``, no clock.

``span`` reads the recorder of the calling thread, which
:func:`recording` sets for a block (the service's dispatcher sets its
session's), so deep sites (a stream's copy, the K1 closure) take no
extra parameter.  ``timed=True`` times the block even with no recorder,
for a caller that reads ``.seconds`` itself (the planner's per-dispatch
wall, the EXPLAIN round wall).  A request's spans, stamped on its
caller's thread and closed by the dispatch that takes it, go to the log
through :meth:`Recorder.record` and, summed over the dispatch's
requests, to the counters through :meth:`Recorder.add`.

Every stamp is ``clock_ns()``, ``time.perf_counter_ns``: monotonic, so a
wall-clock step moves no duration.  A ``Trace`` takes, when it is made,
the offset from that clock to ``time.time_ns`` (``clock_offset_ns``), the
clock ``torch.profiler`` stamps its host events with, and writes its
stamps on the profiler's clock (``to_dict``, ``to_chrome``), so a logged
span and a profiler event of the same process compare directly.
"""

from __future__ import annotations

import itertools
import os
import threading
import time
from collections import deque
from contextlib import contextmanager, nullcontext
from typing import List, Optional

import numpy as np
import torch


def _jsonable(v):
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, np.generic):
        return v.item()
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    return v


#: The clock of every span (monotonic ns); ``Trace.clock_offset_ns`` maps
#: it onto the profiler's.
clock_ns = time.perf_counter_ns

_SID = itertools.count(1)               # ids of logged spans (0: none)


class Span:
    """One timed phase on :data:`clock_ns`.  ``name`` is the full
    '/'-joined path in a per-call trace, the span's own name in a span
    log.  A logged span also carries its id (``sid``), its parent's id
    (``parent``, 0: none), the id of its dispatch or request
    (``ident``) and its thread (``tid``; None for a request-scoped span,
    which no one thread runs)."""

    __slots__ = ("name", "start_ns", "end_ns", "meta", "sid", "parent",
                 "ident", "tid")

    def __init__(self, name: str, start_ns: int, meta: Optional[dict] = None,
                 *, sid: int = 0, parent: int = 0, ident=None, tid=None):
        self.name = name
        self.start_ns = start_ns
        self.end_ns: Optional[int] = None
        self.meta = meta or {}
        self.sid = sid
        self.parent = parent
        self.ident = ident
        self.tid = tid

    @property
    def seconds(self) -> float:
        return (0.0 if self.end_ns is None
                else (self.end_ns - self.start_ns) * 1e-9)

    def to_dict(self, offset_ns: int = 0) -> dict:
        """Plain JSON; the stamps shifted by ``offset_ns`` (a trace's
        ``clock_offset_ns``: onto the profiler's clock)."""
        d = {"name": self.name, "seconds": self.seconds,
             "start_ns": self.start_ns + offset_ns,
             "end_ns": (None if self.end_ns is None
                        else self.end_ns + offset_ns)}
        if self.sid:
            d.update(id=self.sid, parent=self.parent, ident=self.ident,
                     tid=self.tid)
        if self.meta:
            d["meta"] = _jsonable(self.meta)
        return d


class Trace:
    """Per-call query trace (see module docstring for the layers)."""

    __slots__ = ("name", "meta", "spans", "rounds", "clock_offset_ns",
                 "_stack", "_ids", "_id_counts")

    def __init__(self, name: str = "query", *, maxlen: Optional[int] = None,
                 **meta):
        self.name = name
        self.meta = dict(meta)
        # a span log keeps its last ``maxlen`` spans (appends are atomic,
        # so every thread of a service may log into one)
        self.spans = deque(maxlen=maxlen) if maxlen else []
        self.rounds: List[dict] = []
        # :data:`clock_ns` + this = ``time.time_ns``, the profiler's clock
        self.clock_offset_ns = time.time_ns() - clock_ns()
        self._stack: List[str] = []
        # deduplicated-id layer behind the accumulated meta counts:
        # key -> {query index -> [id arrays handed so far]} plus a
        # count-only fallback for sources that cannot expose ids (a
        # device-ordered stream never re-hands an id, so counting it
        # once is already deduplicated)
        self._ids: dict = {}
        self._id_counts: dict = {}

    # -- spans ------------------------------------------------------------
    @contextmanager
    def span(self, name: str, *, fence=None, **meta):
        """Wall-clock a phase.  ``fence``: device array(s) (or a pytree)
        to ``block_until_ready`` before the span closes."""
        path = "/".join(self._stack + [name])
        sp = Span(path, clock_ns(), meta or None)
        self.spans.append(sp)
        self._stack.append(name)
        try:
            yield sp
        finally:
            self._stack.pop()
            if fence is not None:
                block_until_ready(fence)
            sp.end_ns = clock_ns()

    def span_names(self) -> List[str]:
        return [s.name for s in self.spans]

    def has_span(self, name: str) -> bool:
        """True if any span's path equals ``name`` or ends in it (so
        ``"seed"`` matches the nested ``"order/seed"``)."""
        return any(s.name == name or s.name.endswith("/" + name)
                   for s in self.spans)

    def span_seconds(self, name: str) -> float:
        return sum(s.seconds for s in self.spans
                   if s.name == name or s.name.endswith("/" + name))

    # -- meta -------------------------------------------------------------
    def set(self, key: str, value) -> None:
        self.meta[key] = value

    def get(self, key: str, default=None):
        return self.meta.get(key, default)

    def add(self, key: str, value) -> None:
        """Accumulate: numerics sum, numpy arrays sum elementwise (a
        copy is stored, never a live engine buffer)."""
        cur = self.meta.get(key)
        if isinstance(value, np.ndarray):
            value = value.copy()
        if cur is None:
            self.meta[key] = value
        else:
            self.meta[key] = cur + value

    # -- deduplicated id tracking ------------------------------------------
    def note_ids(self, key: str, qi: int, ids) -> None:
        """Record the candidate ids behind one ``add(key, ...)`` round for
        query ``qi``; :meth:`unique_counts` later reports the union size
        (the dedup count the accumulated meta total over-counts under
        exclusion widening)."""
        arr = np.asarray(ids, np.int64)
        if arr.size:
            self._ids.setdefault(key, {}).setdefault(int(qi),
                                                     []).append(arr.copy())

    def note_counts(self, key: str, counts) -> None:
        """Count-only fallback of :meth:`note_ids` for sources whose ids
        stay on device (a candidate stream) — valid as a dedup count
        because such a source never re-hands an id."""
        counts = np.atleast_1d(np.asarray(counts, np.int64))
        cur = self._id_counts.get(key)
        self._id_counts[key] = counts.copy() if cur is None \
            else cur + counts

    def unique_counts(self, key: str, q_n: int):
        """(q_n,) deduplicated per-query count for ``key``: |union of
        noted id arrays| plus the count-only stream contribution.
        None when nothing was noted under ``key``."""
        per_q = self._ids.get(key)
        counted = self._id_counts.get(key)
        if per_q is None and counted is None:
            return None
        out = np.zeros(q_n, np.int64)
        if counted is not None:
            out[:len(counted)] += counted
        if per_q is not None:
            for qi, chunks in per_q.items():
                if qi < q_n:
                    out[qi] += np.unique(np.concatenate(chunks)).size
        return out

    # -- rounds -----------------------------------------------------------
    def record_round(self, **fields) -> None:
        self.rounds.append(fields)

    # -- export -----------------------------------------------------------
    def to_dict(self) -> dict:
        return {"name": self.name,
                "meta": _jsonable(self.meta),
                "spans": [s.to_dict(self.clock_offset_ns)
                          for s in self.spans],
                "rounds": _jsonable(self.rounds)}

    def to_chrome(self) -> dict:
        """The logged spans as Chrome trace events, ``ts`` / ``dur`` in
        us on the profiler's clock (``clock_offset_ns``), so they load beside
        a ``torch.profiler`` trace of the same process.  A thread's span
        is a complete event (``"ph": "X"``) on its thread's track; a
        request-scoped span is an async pair (``"b"`` / ``"e"``) keyed by
        its request id, since one caller's requests overlap.  ``args``
        hold the span's id, its parent's and its ``ident``."""
        pid = os.getpid()
        off = self.clock_offset_ns
        events = []
        for s in list(self.spans):
            args = {"id": s.sid, "parent": s.parent, "ident": s.ident,
                    **_jsonable(s.meta)}
            if s.tid is None:
                head = {"name": s.name, "cat": "request", "id": s.ident,
                        "pid": pid, "tid": 0}
                events += [{**head, "ph": "b", "ts": (s.start_ns + off) / 1e3,
                            "args": args},
                           {**head, "ph": "e", "ts": (s.end_ns + off) / 1e3}]
            else:
                events.append({"name": s.name, "ph": "X",
                               "ts": (s.start_ns + off) / 1e3,
                               "dur": (s.end_ns - s.start_ns) / 1e3,
                               "pid": pid, "tid": s.tid, "args": args})
        for tid, name in dict(self.meta.get("threads", {})).items():
            events.append({"name": "thread_name", "ph": "M", "pid": pid,
                           "tid": tid, "args": {"name": name}})
        return {"traceEvents": events, "displayTimeUnit": "ms"}


_NULL = nullcontext()


def maybe_span(trace: Optional[Trace], name: str, **kw):
    """``trace.span(name)`` or a no-op context — the one-liner guard the
    engine call sites use so the untraced path allocates nothing."""
    return _NULL if trace is None else trace.span(name, **kw)


# -- program spans ----------------------------------------------------------

class _State:
    """One thread's current recorder, its open program spans, and the
    counter sums of the spans closed under its outermost open one."""

    __slots__ = ("rec", "stack", "sums")

    def __init__(self):
        self.rec = None
        self.stack = []
        self.sums = {}      # (registry, parent, name) -> ns, or count


class _Thread(threading.local):
    def __init__(self):
        self.state = _State()


_THREAD = _Thread()


class Recorder:
    """Where program spans go (module docstring, "Program spans"):
    ``metrics``, a ``MetricsRegistry`` for the ``<name>_s`` counters;
    ``log``, a ``Trace`` (``maxlen``-bounded) that keeps the spans."""

    __slots__ = ("metrics", "log")

    def __init__(self, metrics=None, log: Optional[Trace] = None):
        self.metrics = metrics
        self.log = log

    def add(self, key: str, ns: int, *, count: Optional[str] = None,
            n: int = 1) -> None:
        """Close spans stamped elsewhere into the counters: ``ns`` (their
        summed ns) to ``<key>_s`` and ``n`` to ``count``, with the calling
        thread's other spans."""
        m = self.metrics
        if m is None:
            return
        st = _THREAD.state
        sums = st.sums
        k = (m, None, key)
        sums[k] = sums.get(k, 0) + ns
        if count is not None:
            k = (m, count, None)
            sums[k] = sums.get(k, 0) + n
        if not st.stack:
            _flush(sums)

    def record(self, name: str, start_ns: int, end_ns: int, *, ident=None,
               meta: Optional[dict] = None) -> None:
        """Log a span stamped elsewhere (a request's, from its caller's
        thread to its dispatch) on no thread; its seconds go to the
        counters through :meth:`add`."""
        if self.log is not None:
            sp = Span(name, start_ns, meta, sid=next(_SID), ident=ident)
            sp.end_ns = end_ns
            self.log.spans.append(sp)

    def _log(self, o: "_Open") -> None:
        tid = threading.get_ident()
        threads = self.log.meta.setdefault("threads", {})
        if tid not in threads:
            threads[tid] = threading.current_thread().name
        sp = Span(o.name, o.start_ns, sid=o.sid,
                  parent=o.parent.sid if o.parent is not None else 0,
                  ident=o.ident, tid=tid)
        sp.end_ns = o.end_ns
        self.log.spans.append(sp)


class _Open:
    """An open program span (the context ``span`` returns).  Without a
    recorder it only times its block (``timed=True``)."""

    __slots__ = ("rec", "name", "count", "n", "ident", "parent", "sid",
                 "start_ns", "end_ns", "st")

    def __init__(self, rec: Optional[Recorder], name: str,
                 count: Optional[str], st: Optional[_State]):
        self.rec = rec
        self.name = name
        self.count = count
        self.n = 1
        self.ident = None
        self.st = st

    def __enter__(self) -> "_Open":
        rec = self.rec
        if rec is not None:
            stack = self.st.stack
            p = stack[-1] if stack else None
            self.parent = p
            if p is not None:
                self.ident = p.ident
            self.sid = next(_SID) if rec.log is not None else 0
            stack.append(self)
        self.start_ns = clock_ns()
        return self

    def __exit__(self, et, ev, tb) -> bool:
        self.end_ns = end = clock_ns()
        rec = self.rec
        if rec is None:
            return False
        st = self.st
        stack = st.stack
        stack.pop()
        m = rec.metrics
        if m is not None:
            # a thread sums its nested spans' ns and adds them to the
            # registry (one lock each) when its outermost span closes
            sums = st.sums
            p = self.parent
            name = self.name
            key = (m, None if p is None or "." in name else p.name, name)
            sums[key] = sums.get(key, 0) + end - self.start_ns
            if self.count is not None:
                key = (m, self.count, None)
                sums[key] = sums.get(key, 0) + self.n
            if not stack:
                _flush(sums)
        if rec.log is not None:
            rec._log(self)
        return False

    @property
    def seconds(self) -> float:
        return (self.end_ns - self.start_ns) * 1e-9


def _flush(sums: dict) -> None:
    """Add a thread's span sums to their registries: ns as seconds to
    ``<name>_s`` (``<parent>.<name>_s`` for a bare name), counts as they
    are."""
    for (reg, parent, name), v in sums.items():
        if name is None:                # a count (``parent`` its name)
            reg.counter(parent).inc(v)
        else:
            reg.counter(f"{parent}.{name}_s" if parent else name + "_s"
                        ).inc(v * 1e-9)
    sums.clear()


class _Recording:
    __slots__ = ("rec", "prev")

    def __init__(self, rec: Recorder):
        self.rec = rec

    def __enter__(self):
        st = _THREAD.state
        self.prev = st.rec
        st.rec = self.rec

    def __exit__(self, *exc) -> bool:
        _THREAD.state.rec = self.prev
        return False


def recording(rec: Optional[Recorder]):
    """Make ``rec`` the calling thread's recorder for a ``with`` block
    (None: the shared null context, the thread's recorder unchanged)."""
    return _NULL if rec is None else _Recording(rec)


def span(name: str, *, count: Optional[str] = None, timed: bool = False):
    """A program span on the calling thread's recorder (module
    docstring).  With no recorder: the shared null context, or with
    ``timed=True`` a bare timer whose ``.seconds`` the caller reads."""
    st = _THREAD.state
    rec = st.rec
    if rec is not None:
        return _Open(rec, name, count, st)
    return _Open(None, name, None, None) if timed else _NULL


def _cuda_devices(x, out: set) -> None:
    """Collect the CUDA devices of every tensor in ``x`` (a tensor, or a
    tuple / list / dict of them).  Host values — numpy arrays, scalars,
    None — are passed over by their type."""
    if isinstance(x, torch.Tensor):
        if x.device.type == "cuda":
            out.add(x.device)
    elif isinstance(x, (tuple, list)):
        for v in x:
            _cuda_devices(v, out)
    elif isinstance(x, dict):
        for v in x.values():
            _cuda_devices(v, out)


def block_until_ready(x) -> None:
    """Fence helper: ``torch.cuda.synchronize`` each CUDA device that a
    tensor in ``x`` lives on.  Host values (numpy arrays, None, tuples
    of those, CPU tensors) need no fence and are passed over by type;
    nothing is caught, so a CUDA fault raises here."""
    devices: set = set()
    _cuda_devices(x, devices)
    for dev in sorted(devices, key=str):
        torch.cuda.synchronize(dev)
