"""What the per-layer readers read: the traced run's record.

``record["counters"]``: the program's ``serve.*`` and ``match.*``
counters over the traced window (end minus start);
``record["engine_calls"]``: the engine calls in that window;
``record["trace"]``: ``tracing.parse`` of the profiler's trace
(``kernels`` by name with device seconds ``s`` and launches ``n``,
``busy_s``, ``idle_gaps``); ``record["window_s"]``: the traced window's
seconds; ``record["config"]``: the configuration; ``record["n_rows"]``:
rows served; ``record["latency_s"]``: client-side latency of every
request back in the window.
"""

from __future__ import annotations

import re


def counter(rec: dict, name: str) -> float:
    return float(rec["counters"].get(name, 0.0))


def kernels(rec: dict, pattern: str) -> tuple:
    """(device seconds, launches) of the kernels whose name matches."""
    rx = re.compile(pattern)
    s, n = 0.0, 0
    for name, v in rec["trace"]["kernels"].items():
        if rx.search(name):
            s += v["s"]
            n += v["n"]
    return s, n


def ratio(num: float, den: float):
    return num / den if den else None
