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
trace schema.
"""

from __future__ import annotations

import time
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


class Span:
    """One wall-clocked phase; ``name`` is the full '/'-joined path."""

    __slots__ = ("name", "t0", "t1", "meta")

    def __init__(self, name: str, t0: float, meta: Optional[dict] = None):
        self.name = name
        self.t0 = t0
        self.t1: Optional[float] = None
        self.meta = meta or {}

    @property
    def seconds(self) -> float:
        return 0.0 if self.t1 is None else self.t1 - self.t0

    def to_dict(self) -> dict:
        return {"name": self.name, "seconds": self.seconds,
                **({"meta": _jsonable(self.meta)} if self.meta else {})}


class Trace:
    """Per-call query trace (see module docstring for the layers)."""

    __slots__ = ("name", "meta", "spans", "rounds", "_stack",
                 "_ids", "_id_counts")

    def __init__(self, name: str = "query", **meta):
        self.name = name
        self.meta = dict(meta)
        self.spans: List[Span] = []
        self.rounds: List[dict] = []
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
        sp = Span(path, time.perf_counter(), meta or None)
        self.spans.append(sp)
        self._stack.append(name)
        try:
            yield sp
        finally:
            self._stack.pop()
            if fence is not None:
                block_until_ready(fence)
            sp.t1 = time.perf_counter()

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
                "spans": [s.to_dict() for s in self.spans],
                "rounds": _jsonable(self.rounds)}


_NULL = nullcontext()


def maybe_span(trace: Optional[Trace], name: str, **kw):
    """``trace.span(name)`` or a no-op context — the one-liner guard the
    engine call sites use so the untraced path allocates nothing."""
    return _NULL if trace is None else trace.span(name, **kw)


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
