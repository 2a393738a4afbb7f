"""The traced run's record: ``torch.profiler`` over the measured window.

The profiler's events are read from memory once the window has closed
(nothing is written to disk).  From them come the device's busy seconds
(the union of kernel, copy and fill intervals), each kernel's device
seconds and launches by name, and the idle gaps between device work,
each labelled by the innermost host event (a CUDA runtime call) that
covers its middle.  On the card only CUDA activity is recorded, which
keeps the profiler's own host work off the engine loop.
"""

from __future__ import annotations

import heapq
import re
import time
from collections import defaultdict

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def profiled(fn, device):
    """Run ``fn()`` under ``torch.profiler``; returns (fn's result, the
    parsed events, fn's seconds to the device's last work)."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    on_card = torch.device(device).type == "cuda"
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        out = fn()
        if on_card:
            torch.cuda.synchronize(device)
        seconds = time.perf_counter() - t0
    events = [(category(e), e.name(), e.start_ns() * 1e-3,
               e.duration_ns() * 1e-3)
              for e in prof.profiler.kineto_results.events()]
    rec = parse(events)
    rec["events"] = len(events)
    return out, rec, seconds


def category(event) -> str:
    """A profiler event's kind from its device and name: on the card a
    kernel, a copy or a fill; anything else is the host's."""
    if str(event.device_type()).endswith("CUDA"):
        name = event.name()
        if name.startswith("Memcpy"):
            return "gpu_memcpy"
        if name.startswith("Memset"):
            return "gpu_memset"
        return "kernel"
    return "host"


def _union(intervals):
    """Merged [start, end) intervals, sorted."""
    merged = []
    for a, b in sorted(intervals):
        if merged and a <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], b)
        else:
            merged.append([a, b])
    return merged


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = name.strip()
    if name.endswith(")"):
        depth = 0
        for i in range(len(name) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(name[i], 0)
            if depth == 0:
                name = name[:i]
                break
    return re.sub(r"^void ", "", name)[:160]


def parse(events) -> dict:
    """``events``: (category, name, start us, duration us), the category
    one of ``DEVICE_CATS`` or any other for a host event.  Kernel seconds
    and launches by name, busy seconds and the idle gaps by host label."""
    dev, host = [], []
    for cat, name, a, d in events:
        if cat in DEVICE_CATS:
            dev.append((a, a + d, cat, name))
        else:
            host.append((a, a + d, name))
    kernels = defaultdict(lambda: [0.0, 0])
    for a, b, cat, name in dev:
        key = short_name(name) if cat == "kernel" else cat
        kernels[key][0] += (b - a) * 1e-6
        kernels[key][1] += 1
    busy = _union([(a, b) for a, b, _, _ in dev])
    busy_s = sum(b - a for a, b in busy) * 1e-6
    gaps = defaultdict(float)
    host.sort()
    active, j = [], 0           # heap of (duration, end, name) begun
    for (_, a), (b, _) in zip(busy, busy[1:]):
        mid = 0.5 * (a + b)
        while j < len(host) and host[j][0] <= mid:
            ha, hb, name = host[j]
            heapq.heappush(active, (hb - ha, hb, name))
            j += 1
        while active and active[0][1] < mid:    # ended: no later gap
            heapq.heappop(active)
        label = active[0][2] if active else "host: no traced event"
        gaps[label] += (b - a) * 1e-6
    return {
        "kernels": {k: {"s": v[0], "n": v[1]} for k, v in kernels.items()},
        "busy_s": busy_s,
        "idle_gaps": dict(gaps),
    }


def breakdown(trace: dict, top: int = 10) -> dict:
    """The device operations that took most time and the longest idle
    gaps by what the host was doing, ``top`` of each."""
    ops = sorted(((k, v["s"]) for k, v in trace["kernels"].items()),
                 key=lambda kv: -kv[1])[:top]
    gaps = sorted(trace["idle_gaps"].items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, s] for k, s in ops],
            "idle_gaps": [[k, s] for k, s in gaps]}
