"""Observability: per-query traces, process metrics, EXPLAIN.

* :mod:`repro_torch.obs.trace` — ``Trace`` / ``Span``: per-engine-call
  query traces (phase wall-clocks fenced with ``torch.cuda.synchronize``,
  verification-round telemetry, candidate / I/O counters).  Engines take
  ``trace=None`` and record nothing unless one is passed.  Program spans
  on the served path (``Recorder``, ``recording``): ``<name>_s``
  counters and a bounded span log on the profiler's clock.
* :mod:`repro_torch.obs.metrics` — ``MetricsRegistry`` (+ the
  process-wide ``REGISTRY``): named counters / gauges / fixed-log-bucket
  histograms with deterministic snapshot merges and plain-JSON export.
* :mod:`repro_torch.obs.explain` — ``render_trace`` (the ``--explain``
  per-query plan report) and ``check_trace`` (span / device-invariant
  validation).
"""

from repro_torch.obs.explain import REQUIRED_SPANS, check_trace, render_trace
from repro_torch.obs.metrics import (LATENCY_BUCKETS, REGISTRY, Counter,
                                     Gauge, Histogram, MetricsRegistry,
                                     merge_snapshots)
from repro_torch.obs.trace import (Recorder, Span, Trace, block_until_ready,
                                   maybe_span, recording)

__all__ = [
    "Counter", "Gauge", "Histogram", "LATENCY_BUCKETS", "MetricsRegistry",
    "REGISTRY", "REQUIRED_SPANS", "Recorder", "Span", "Trace",
    "block_until_ready", "check_trace", "maybe_span", "merge_snapshots",
    "recording", "render_trace",
]
