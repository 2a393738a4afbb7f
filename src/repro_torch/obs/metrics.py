"""Process-wide metrics: counters, gauges, and fixed-bucket histograms.

The registry is the aggregation side of the observability subsystem
(``repro_torch.obs``): engines and benchmarks increment named metrics, and a
``snapshot()`` is a plain-JSON dict embeddable in
``results/BENCH_<suite>.json`` payloads.  Metric names are the JAX
package's, so one report reader serves both packages.

Histograms use FIXED log-spaced bucket bounds (``LATENCY_BUCKETS``:
quarter-decade steps from 1 µs to ~178 s) rather than per-instance
adaptive bounds, so two snapshots taken on different hosts / suites /
processes merge deterministically by adding bucket counts
(:func:`merge_snapshots`) — no re-binning, no bound negotiation.

Everything here is plain Python (no torch, no numpy required at import
time): recording a metric is a dict lookup + float add, cheap enough to
leave on in benchmarks, and absent entirely from the matching hot loops
unless a caller opted in (engines take ``metrics=None`` by default).

Thread safety: the matching service (the matching service) records from
submitter threads concurrently with its dispatcher thread, so every
read-modify-write (``inc`` / ``observe`` / ``merge`` / registry
get-or-create) holds one shared module lock — a float add under a lock
is still cheap, and exact totals under concurrency are what the
merged-snapshot determinism contract promises.
"""

from __future__ import annotations

from bisect import bisect_left
from threading import Lock
from typing import Dict, Optional, Tuple

# One lock for all metric mutation: contention is negligible (recording
# is nanoseconds) and a shared lock avoids a per-metric slot.
_REC_LOCK = Lock()

# Quarter-decade log-spaced latency bounds, 1e-6 s .. ~1.78e2 s.  The
# tuple is a module-level constant on purpose: every histogram in every
# process uses the SAME bounds, which is what makes snapshot merges a
# pure bucket-count addition.
LATENCY_BUCKETS: Tuple[float, ...] = tuple(
    10.0 ** (i / 4.0 - 6.0) for i in range(34))


class Counter:
    """Monotonic accumulator (float so byte / second totals fit)."""

    kind = "counter"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def inc(self, v: float = 1.0) -> None:
        with _REC_LOCK:
            self.value += float(v)


class Gauge:
    """Last-written value (e.g. a per-run pruning power)."""

    kind = "gauge"
    __slots__ = ("value",)

    def __init__(self):
        self.value = 0.0

    def set(self, v: float) -> None:
        with _REC_LOCK:
            self.value = float(v)


class Histogram:
    """Fixed-bound histogram; bucket ``i`` counts observations ``v <=
    bounds[i]`` (first such bound), the final slot is overflow."""

    kind = "histogram"
    __slots__ = ("bounds", "counts", "sum", "count")

    def __init__(self, bounds: Tuple[float, ...] = LATENCY_BUCKETS):
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        with _REC_LOCK:
            self.counts[bisect_left(self.bounds, v)] += 1
            self.sum += v
            self.count += 1

    def merge(self, other: "Histogram") -> None:
        if self.bounds != other.bounds:
            raise ValueError("histogram bounds differ; merges are only "
                             "deterministic over identical fixed buckets")
        with _REC_LOCK:
            for i, c in enumerate(other.counts):
                self.counts[i] += c
            self.sum += other.sum
            self.count += other.count

    def quantile(self, q: float) -> float:
        """Upper bucket bound at quantile ``q`` (conservative estimate;
        NaN when empty, +inf when the quantile lands in overflow)."""
        if self.count == 0:
            return float("nan")
        target = q * self.count
        seen = 0
        for i, c in enumerate(self.counts):
            seen += c
            if seen >= target and c:
                return (self.bounds[i] if i < len(self.bounds)
                        else float("inf"))
        return float("inf")

    def to_dict(self) -> dict:
        with _REC_LOCK:                  # consistent (counts, sum, count)
            return {"bounds": list(self.bounds),
                    "counts": list(self.counts),
                    "sum": self.sum, "count": self.count}

    @classmethod
    def from_dict(cls, d: dict) -> "Histogram":
        h = cls(tuple(d["bounds"]))
        h.counts = [int(c) for c in d["counts"]]
        h.sum = float(d["sum"])
        h.count = int(d["count"])
        return h


class MetricsRegistry:
    """Named metric store with get-or-create accessors.

    A name is bound to one metric kind for the registry's lifetime;
    asking for the same name as a different kind is a programming error
    and raises immediately rather than silently shadowing.
    """

    def __init__(self):
        self._metrics: Dict[str, object] = {}

    def _get(self, name: str, cls, *args):
        m = self._metrics.get(name)
        if m is None:
            with _REC_LOCK:
                m = self._metrics.setdefault(name, cls(*args))
        if not isinstance(m, cls):
            raise TypeError(f"metric {name!r} is a {m.kind}, not a "
                            f"{cls.kind}")
        return m

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str,
                  bounds: Tuple[float, ...] = LATENCY_BUCKETS) -> Histogram:
        return self._get(name, Histogram, bounds)

    def reset(self) -> None:
        """Drop every metric — the boundary between two measured
        suites (each snapshot then covers exactly one, no bleed)."""
        self._metrics.clear()

    def snapshot(self) -> dict:
        """Plain-JSON view: ``{"counters": {name: value}, "gauges":
        {...}, "histograms": {name: {bounds, counts, sum, count}}}``."""
        out = {"counters": {}, "gauges": {}, "histograms": {}}
        # list() snapshots the key set atomically; per-metric reads are
        # consistent (Histogram.to_dict holds the recording lock)
        for name, m in sorted(list(self._metrics.items())):
            if isinstance(m, Counter):
                out["counters"][name] = m.value
            elif isinstance(m, Gauge):
                out["gauges"][name] = m.value
            else:
                out["histograms"][name] = m.to_dict()
        return out


def merge_snapshots(a: Optional[dict], b: Optional[dict]) -> dict:
    """Deterministic snapshot merge: counters add, gauges last-wins,
    histograms add bucket counts (fixed shared bounds make this exact
    regardless of which process observed what)."""
    out = {"counters": {}, "gauges": {}, "histograms": {}}
    for snap in (a, b):
        if not snap:
            continue
        for n, v in snap.get("counters", {}).items():
            out["counters"][n] = out["counters"].get(n, 0.0) + v
        for n, v in snap.get("gauges", {}).items():
            out["gauges"][n] = v
        for n, d in snap.get("histograms", {}).items():
            if n in out["histograms"]:
                h = Histogram.from_dict(out["histograms"][n])
                h.merge(Histogram.from_dict(d))
                out["histograms"][n] = h.to_dict()
            else:
                out["histograms"][n] = {k: (list(v) if isinstance(v, list)
                                            else v) for k, v in d.items()}
    return out


#: Process-wide default registry — what ``launch/match.py --explain``
#: reports from.
REGISTRY = MetricsRegistry()
