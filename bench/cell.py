"""One run of one cell: set-up, the measured window, the check.

``run`` returns the result line as a dict; ``bench/run.py`` is the
command that prints it.  Tests call ``run`` on the CPU at a small size
(``device="cpu"``, ``sizes=``), with ``wrap=`` to break the path under
test.
"""

from __future__ import annotations

import gc
import math
import subprocess
import sys
import time

import numpy as np

from bench import load, manifest, tracing
from bench.isolation import forbidden_loaded


def say(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def with_sizes(config: dict, traffic: dict, sizes: dict | None):
    """Configuration and mix with test-size overrides merged in."""
    if not sizes:
        return config, traffic
    config = {**config, "corpus": {**config["corpus"],
                                   **sizes.get("corpus", {})}}
    traffic = {**traffic, **{k: v for k, v in sizes.items()
                             if k != "corpus"}}
    return config, traffic


def _device_kind(device) -> dict:
    import torch
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def power_limit() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0] if out.stdout else ""
    except (OSError, subprocess.SubprocessError, IndexError):
        return ""


def run(workload: str, seed: int, seconds: float, trace: bool, *,
        device="cuda", t_process: float | None = None, bench=None,
        sizes: dict | None = None, wrap=None) -> dict:
    import torch
    from repro_torch.obs import MetricsRegistry

    t_process = time.perf_counter() if t_process is None else t_process
    before = set(forbidden_loaded())
    bench = bench or manifest.load()
    cell = manifest.cell(bench, workload)
    config, traffic = with_sizes(manifest.config(bench, cell["config"]),
                                 manifest.traffic(cell["traffic"]), sizes)
    device = torch.device(device)
    corpus = manifest.module("corpora", config["corpus"]["generator"])
    system_mod = manifest.module("systems", config["system"])
    ref = manifest.module("references", config["reference"])
    spec = config["corpus"]
    on_card = device.type == "cuda"
    if on_card:
        torch.cuda.set_device(device)
        torch.zeros(1, device=device)       # the context, then the peak
        torch.cuda.reset_peak_memory_stats(device)

    # -- set-up: the corpus through the program's ingest -----------------
    metrics = MetricsRegistry()
    system = system_mod.build(config, traffic, device, metrics)
    t0 = time.perf_counter()
    sums, make_s = [], 0.0
    for i in range(corpus.n_chunks(spec)):
        t1 = time.perf_counter()
        chunk = corpus.corpus_chunk(spec, seed, i, device)
        sums.append(float(chunk.double().sum()))
        make_s += time.perf_counter() - t1
        system.ingest(chunk)
        del chunk
    n_rows = system.n_rows
    say(f"corpus: {n_rows} rows made in {make_s:.3f} s and ingested, "
        f"{time.perf_counter() - t0:.3f} s in all; set-up so far "
        f"{time.perf_counter() - t_process:.3f} s")
    pool_n = int(traffic["pool"])
    # one warm dispatch at the bucketed batch the window fills
    warm_n = int(traffic.get("session", {}).get("max_batch", 64))
    queries = corpus.query_pool(spec, pool_n + warm_n, seed,
                                device).cpu().numpy()
    if wrap is not None:
        wrap(system)
    system.start()

    def submit(row, k):
        return system.submit(queries[row], k)

    t0 = time.perf_counter()
    warm = load.closed_loop(lambda row, k: submit(pool_n + row, k), warm_n,
                            clients=warm_n, k=int(traffic["k"]), seconds=0.0)
    failed = [s.req.error for s in warm.sent if not s.req.ok]
    if failed:
        say(f"warm-up: {len(failed)} request(s) failed: {failed[0]}")
    if on_card:
        torch.cuda.synchronize(device)
    say(f"warm-up: {time.perf_counter() - t0:.3f} s")
    setup_s = time.perf_counter() - t_process
    refuse_forbidden("set-up", before)

    # -- the measured window -------------------------------------------------
    snap0 = metrics.snapshot()
    if trace:
        win, tr, traced_s = tracing.profiled(lambda: load.run(
            traffic, submit, pool_n, seconds=seconds), device)
    else:
        win = load.run(traffic, submit, pool_n, seconds=seconds)
    snap1 = metrics.snapshot()
    peak = int(torch.cuda.max_memory_allocated(device)) if on_card else 0
    done = win.done_in_window()
    lat = np.asarray([s.t_back - s.t_sent for s in done], np.float64)
    answers = [(s.query, s.req.indices, s.req.distances)
               for s in win.sent if s.t_back is not None and s.req.ok]
    attempted = len(win.sent)
    say(f"window: {attempted} sent, {len(done)} back in the window, "
        f"{len(answers)} served in all; latency p95 "
        f"{_p95_ms(lat)!r} ms")
    say_bursts(load.resend_bursts(win), traffic)

    # -- the program's state is freed before the reference runs ------------
    system.close()
    del system
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()

    def chunks():
        for i in range(corpus.n_chunks(spec)):
            c = corpus.corpus_chunk(spec, seed, i, device)
            if float(c.double().sum()) != sums[i]:
                raise RuntimeError(f"corpus chunk {i} made again differs "
                                   "from the one ingested")
            yield c

    t0 = time.perf_counter()
    verdict = ref.judge(answers, attempted, chunks(), queries,
                        config["check"], n_rows, device)
    say(f"check: {len(answers)} answers against the reference in "
        f"{time.perf_counter() - t0:.3f} s")

    result = {"correct": verdict["correct"], "attempted": attempted,
              "failed": attempted - len(answers)}
    dev = _device_kind(device)
    dev["memory_peak_bytes"] = peak
    if trace:
        rec = {"counters": {k: v - snap0["counters"].get(k, 0.0)
                            for k, v in snap1["counters"].items()},
               "engine_calls": _calls(snap1) - _calls(snap0),
               "trace": tr, "window_s": traced_s, "config": config,
               "traffic": traffic, "n_rows": n_rows,
               "latency_s": lat.tolist()}
        vals = {}
        for m in manifest.per_layer(bench, workload):
            v = manifest.module("metrics", m["name"]).read(rec)
            if v is not None and math.isfinite(v):
                vals[m["name"]] = {"value": v, "unit": m["unit"]}
        result["metrics"] = vals
        dev["busy_s"] = tr["busy_s"]
        dev["window_s"] = traced_s
        result["device"] = dev
        result["breakdown"] = tracing.breakdown(tr)
        say(f"trace: {tr['events']} events, busy {tr['busy_s']:.3f} of "
            f"{traced_s:.3f} s")
        say("counters over the window: " + ", ".join(
            f"{k} {v:g}" for k, v in sorted(rec["counters"].items())))
    else:
        e2e = {"qps": len(done) / seconds, "peak_device_gb": peak / 1e9,
               "setup_s": setup_s}
        result["metrics"] = {
            m["name"]: {"value": e2e[m["name"]], "unit": m["unit"]}
            for m in manifest.end_to_end(bench, workload)}
        result["device"] = dev
    result["checks"] = verdict["checks"]
    refuse_forbidden("the run", before)
    return result


def _p95_ms(lat: np.ndarray) -> float:
    """95th percentile of the latencies, in ms; NaN where none."""
    return float(np.percentile(lat, 95)) * 1e3 if lat.size else math.nan


def _calls(snap: dict) -> int:
    """Engine calls so far: the engine records each call's wall once."""
    h = snap["histograms"].get("match.topk_latency_s")
    return int(h["count"]) if h else 0


def say_bursts(bursts: np.ndarray, traffic: dict) -> None:
    """How long the driver took to resend after each batch of answers,
    beside the service's coalescing window."""
    if not len(bursts):
        return
    n, span, inside = bursts.T * [[1], [1e3], [1e3]]
    w_ms = 1e3 * float(traffic.get("session", {}).get("window_s", 0.002))
    say(f"resends after {len(n)} batches of answers: {np.median(n):g} "
        f"a batch (median); first to last {np.median(span):.3f} ms "
        f"median, {np.percentile(span, 95):.3f} p95, {span.max():.3f} "
        f"max, against a {w_ms:g} ms window ({(span > w_ms).mean():.1%} "
        f"over); inside submit {np.median(inside):.3f} ms median")


def refuse_forbidden(when: str, before=frozenset()) -> None:
    """Raise if JAX or the JAX package was loaded since ``before``."""
    bad = [m for m in forbidden_loaded() if m not in before]
    if bad:
        raise RuntimeError(f"{when} loaded JAX or the JAX package: "
                           + ", ".join(bad))
