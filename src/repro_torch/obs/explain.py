"""EXPLAIN rendering + trace validation.

``render_trace`` turns an engine query trace (``repro_torch.obs.Trace``) into
the human-readable per-query plan report behind
``launch/match.py --explain`` and ``MatchEngine.topk(explain=True)``:
phase wall-clocks, candidates generated / examined / verified per
query, pruning power, modeled I/O, transfer byte counters, and the
round-by-round k-th-best bound evolution.

``check_trace`` is the machine side of the same report — the CI gate
(``launch/match.py --explain --dryrun``) fails the build when a trace
is missing required spans or, on the device-verify path, reports
nonzero ``host_order_bytes`` / rows moved to the host (the device
path's invariants, asserted as metrics).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from repro_torch.obs.trace import Trace

#: Spans every exact engine trace must contain: candidate generation
#: ("order") and the pruned verification scan ("verify").
REQUIRED_SPANS = ("order", "verify")


def _arr(trace: Trace, key: str, q_n: int) -> np.ndarray:
    v = trace.get(key)
    if v is None:
        return np.zeros(q_n)
    return np.atleast_1d(np.asarray(v))


def _fmt_s(s: float) -> str:
    if s >= 1.0:
        return f"{s:.2f}s"
    if s >= 1e-3:
        return f"{s * 1e3:.1f}ms"
    return f"{s * 1e6:.0f}us"


def render_trace(trace: Trace) -> str:
    """Readable per-query plan report for one engine call."""
    m = trace.meta
    q_n = int(m.get("q_n", 1))
    total = int(m.get("total", 0))
    lines = []
    head = [f"k={m.get('k')}", f"queries={q_n}",
            f"source={m.get('source', 'linear')}",
            f"verify={m.get('verify', '?')}"]
    if total:
        head.append(f"corpus={total}")
    if not m.get("exact", True):
        head.append("approximate")
    lines.append(f"== {trace.name} ({', '.join(head)}) ==")

    # phase wall-clocks from the span tree (top-level spans only; nested
    # child time — e.g. order/seed — is included in its parent)
    tops = [s for s in trace.spans if "/" not in s.name]
    if tops:
        phases = " | ".join(f"{s.name} {_fmt_s(s.seconds)}" for s in tops)
        lines.append(f"phases: {phases}"
                     + (f"  (total {_fmt_s(m['wall_s'])})"
                        if "wall_s" in m else ""))
        nested = [s for s in trace.spans if "/" in s.name]
        for s in nested:
            lines.append(f"  .. {s.name} {_fmt_s(s.seconds)}")

    gen = _arr(trace, "generated", q_n)
    exa = _arr(trace, "examined", q_n)
    ver = _arr(trace, "verified", q_n)
    pp = trace.get("pruning_power")
    gu = trace.get("generated_unique")
    uniq = ""
    if gu is not None and not np.array_equal(np.atleast_1d(gu), gen):
        # widening rounds re-hand candidates: the accumulated total
        # over-counts, the union size is the honest per-query number
        uniq = f" ({np.atleast_1d(gu).mean():.0f} unique)"
    lines.append("candidates/query: generated "
                 f"{gen.mean():.0f}{uniq}, examined {exa.mean():.0f}, "
                 f"verified {ver.mean():.0f}"
                 + (f"; pruning power {np.mean(pp):.2%}"
                    if pp is not None else ""))
    bar = trace.get("error_bar")
    if bar is not None:
        bar = np.atleast_1d(np.asarray(bar, np.float64))
        fin = bar[np.isfinite(bar)]
        lines.append("approx certificate: error bar mean "
                     f"{fin.mean() if fin.size else float('inf'):.4f}, "
                     f"max {fin.max() if fin.size else float('inf'):.4f}"
                     f" ({int((bar == 0).sum())}/{bar.size} provably "
                     "exact)")

    rows = m.get("rows_fetched")
    if rows is not None:
        lines.append(f"io: {int(rows)} rows in {int(m.get('seeks', 0))} "
                     f"seeks, modeled {_fmt_s(float(m.get('modeled_io_s', 0.0)))}")
    if "host_order_bytes" in m or "rows_to_host" in m:
        parts = []
        for key in ("host_order_bytes", "h2d_bytes", "rows_to_host"):
            if key in m:
                parts.append(f"{key}={int(m[key])}")
        lines.append("transfers: " + " ".join(parts))

    # per-query plan table
    if q_n > 1 or total:
        lines.append("  q  generated  examined  pruning")
        for qi in range(q_n):
            p = (float(np.atleast_1d(pp)[qi]) if pp is not None
                 else (1.0 - exa[qi] / total if total else 0.0))
            lines.append(f"  {qi:>2}  {int(gen[qi]):>9}  {int(exa[qi]):>8}"
                         f"  {p:>7.2%}")

    # round-by-round k-th-best evolution (the pruning threshold)
    if trace.rounds:
        lines.append("  round  phase  active  examined  kth-best"
                     "(min..max)  wall")
        for i, r in enumerate(trace.rounds):
            kth = np.asarray(r.get("kth", []), np.float64)
            fin = kth[np.isfinite(kth)]
            if fin.size:
                kbs = f"{fin.min():>8.4f}..{fin.max():<8.4f}"
            else:
                kbs = f"{'inf':>8}..{'inf':<8}"
            lines.append(f"  {i:>5}  {r.get('phase', '?'):>5}  "
                         f"{r.get('active', 0):>6}  "
                         f"{r.get('examined', 0):>8}  {kbs}  "
                         f"{_fmt_s(float(r.get('wall_s', 0.0)))}")
    return "\n".join(lines)


def check_trace(trace: Optional[Trace], *,
                required: Sequence[str] = REQUIRED_SPANS,
                device: bool = False) -> List[str]:
    """Validate a trace; returns a list of problems (empty == pass).

    ``device=True`` additionally enforces the device-path invariants as
    metrics: zero candidate-order bytes assembled on the host and zero
    raw rows moved device->host.
    """
    if trace is None:
        return ["no trace recorded"]
    problems = [f"missing required span {name!r}" for name in required
                if not trace.has_span(name)]
    if not trace.rounds:
        problems.append("no verification rounds recorded")
    if device:
        hob = trace.get("host_order_bytes")
        if hob is None:
            problems.append("device path recorded no host_order_bytes "
                            "metric")
        elif int(hob) != 0:
            problems.append(f"host_order_bytes={int(hob)} on the device "
                            "path (candidate order left the device)")
        rth = trace.get("rows_to_host")
        if rth is None:
            problems.append("device path recorded no rows_to_host metric")
        elif int(rth) != 0:
            problems.append(f"rows_to_host={int(rth)} on the device path "
                            "(raw rows moved device->host)")
    return problems
