"""Program spans (``repro_torch.obs.trace``: ``Recorder``, ``span``,
``recording``) on the CPU: their clock is the profiler's, their counters
add up to the served work, they change no answer, they cost nothing
with nothing attached, and the span log stays bounded and exports
Chrome trace events.  The service under test is ``MatchSession`` over
``make_engine_service`` on ``make_mesh(1, "cpu")``, ``verify="device"``
(the benchmark's route: device order, K1 closure, device merge).  On a
card, one more test holds the spans to the profiler's CUDA events and
prints what a span costs."""

import json
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import make_technique  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    make_engine_service, make_mesh)
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    MetricsRegistry, Recorder, Trace, recording)
from repro_torch.obs import trace as obs_trace  # noqa: E402
from repro_torch.service import MatchSession  # noqa: E402

T, L, N, NQ = 240, 10, 400, 12


@pytest.fixture(scope="module")
def served():
    X = season_dataset(N + NQ, T, L, 0.7, per_series_strength=True, seed=7)
    enc = make_technique("ssax", T=T, W=T // (2 * L), L=L, r2_season=0.7)
    eng = make_engine_service(enc, X[NQ:], make_mesh(1, "cpu"),
                              batch_size=16, verify="device")
    return eng, X[:NQ]


def _serve(eng, Q, *, k=2, explain=False, **session):
    """Serve ``Q`` one request each (submitted before the dispatcher
    starts, so they coalesce alike every time); returns the requests and
    the dispatcher's wall from start to close."""
    sess = MatchSession(eng, window_s=0.001, max_batch=8, **session)
    reqs = [sess.submit(q, k=k, explain=explain) for q in Q]
    t0 = time.perf_counter()
    sess.start()
    for r in reqs:
        assert r.wait(120) and r.ok, r.error
    sess.close()
    return sess, reqs, time.perf_counter() - t0


def _rounds_of(eng):
    """Wrap the engine's ``topk`` on the instance: the rounds of every
    call (the session calls ``engine.topk``)."""
    rounds, topk = [], eng.topk

    def counted(*a, **kw):
        res = topk(*a, **kw)
        rounds.append(res.rounds)
        return res
    eng.topk = counted
    return rounds


def test_span_clock_is_the_profilers():
    """Spans time on the monotonic clock; the log writes their stamps on
    the profiler's, where they bracket a ``record_function`` block."""
    from torch.profiler import ProfilerActivity, profile, record_function
    assert obs_trace.clock_ns is time.perf_counter_ns
    rec = Recorder(log=Trace("log", maxlen=8))
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with recording(rec), obs_trace.span("outer.block"):
            with record_function("inner_block"):
                torch.ones(64).sum()
    sp, = rec.log.spans
    d, = rec.log.to_dict()["spans"]
    ev = [e for e in prof.profiler.kineto_results.events()
          if e.name() == "inner_block"]
    assert len(ev) == 1
    a, b = ev[0].start_ns(), ev[0].start_ns() + ev[0].duration_ns()
    ms = 1_000_000
    assert d["start_ns"] - ms <= a <= b <= d["end_ns"] + ms
    assert d["start_ns"] - sp.start_ns == rec.log.clock_offset_ns
    assert d["end_ns"] - d["start_ns"] == sp.end_ns - sp.start_ns


def test_counters_match_the_served_work(served):
    eng, Q = served
    rounds = _rounds_of(eng)
    try:
        reg = MetricsRegistry()
        sess, reqs, wall = _serve(eng, Q, metrics=reg)
    finally:
        del eng.topk
    c = reg.snapshot()["counters"]
    assert c["serve.submit_calls"] == len(Q)
    assert c["serve.batches"] == len(rounds) >= 2
    assert c["match.rounds"] == sum(rounds) > 0
    assert c["serve.queue_wait_s"] > 0 and c["serve.submit_s"] > 0
    assert c["serve.coalesce_s"] + c["serve.dispatch_s"] <= wall
    assert c["serve.dispatch_s"] >= c["serve.group_s"] >= c["match.topk_s"]
    assert c["match.topk_s"] >= c["match.sweep_s"] + c["match.round_s"]
    assert c["match.round_s"] >= c["match.round.wait_s"] > 0
    assert c["match.sweep_s"] >= c["match.sweep.wait_s"] > 0
    assert {r.dispatch for r in reqs} == set(range(len(rounds)))


def test_answers_bitwise_with_and_without_spans(served):
    eng, Q = served
    want = eng.topk(Q, k=2)
    runs = {"none": _serve(eng, Q)[1],
            "metrics+log": _serve(eng, Q, metrics=MetricsRegistry(),
                                  span_log=4096)[1],
            "explain": _serve(eng, Q, explain=True,
                              metrics=MetricsRegistry(), span_log=64)[1]}
    for name, reqs in runs.items():
        for i, r in enumerate(reqs):
            assert np.array_equal(r.indices, want.indices[i]), name
            assert np.array_equal(r.distances, want.distances[i]), name
    for r in runs["explain"]:
        walls = [rd["wall_s"] for rd in r.trace.rounds]
        assert walls and all(w > 0 for w in walls)
        assert sum(walls) <= r.trace.span_seconds("verify")
        assert r.trace.span_names() == ["order", "verify"]


def test_null_path_makes_no_span_and_reads_no_extra_clock(served,
                                                          monkeypatch):
    eng, Q = served
    reads = []

    def clock():
        reads.append(1)
        return time.time_ns()

    def no_span(*a, **kw):
        raise AssertionError("a Span was made with nothing attached")
    monkeypatch.setattr(obs_trace, "clock_ns", clock)
    monkeypatch.setattr(obs_trace, "Span", no_span)
    rounds = _rounds_of(eng)
    try:
        sess, reqs, _ = _serve(eng, Q)
    finally:
        del eng.topk
    assert sess.recorder is None and sess.spans() == []
    assert all(r.t_submit_ns == 0 for r in reqs)
    # the planner's per-group wall, its clock pair before spans, alone
    assert len(reads) == 2 * len(rounds)


def test_span_log_bounded_with_parents_ids_and_chrome_export(served):
    eng, Q = served
    sess, reqs, _ = _serve(eng, Q, metrics=MetricsRegistry(), span_log=20)
    assert len(sess.spans()) == 20
    sess, reqs, _ = _serve(eng, Q, metrics=MetricsRegistry(),
                           span_log=65536)
    spans = sess.spans()
    by_id = {s.sid: s for s in spans}
    parent_of = {"serve.group": "serve.dispatch",
                 "match.topk": "serve.group", "match.sweep": "match.topk",
                 "match.round": "match.topk"}
    dispatches = {s.ident for s in spans if s.name == "serve.dispatch"}
    assert dispatches == {r.dispatch for r in reqs}
    for s in spans:
        assert s.end_ns >= s.start_ns > 0
        if s.name in parent_of:
            assert by_id[s.parent].name == parent_of[s.name]
            assert s.ident == by_id[s.parent].ident in dispatches
        elif s.name == "wait":
            assert by_id[s.parent].name in ("match.sweep", "match.round")
    # each request's submit, then its wait queued (request-scoped: on no
    # thread), the one ending where the other starts
    by_req = {r.rid: r for r in reqs}
    scoped = [s for s in spans if s.tid is None]
    assert {s.name for s in scoped} == {"serve.submit", "serve.queue"}
    for name in ("serve.submit", "serve.queue"):
        assert sorted(s.ident for s in scoped
                      if s.name == name) == sorted(by_req)
    queued = {s.ident: s for s in scoped if s.name == "serve.queue"}
    for s in scoped:
        if s.name == "serve.submit":
            assert s.end_ns == queued[s.ident].start_ns
        else:
            assert s.meta["dispatch"] == by_req[s.ident].dispatch
    ev = json.loads(json.dumps(sess.span_log.to_chrome()))["traceEvents"]
    x = [e for e in ev if e["ph"] == "X"]
    assert len(x) == len(spans) - len(scoped)
    assert all(e["dur"] >= 0 and e["args"]["id"] for e in x)
    assert sum(e["ph"] == "b" for e in ev) == sum(
        e["ph"] == "e" for e in ev) == len(scoped)
    names = {e["args"]["name"] for e in ev if e["ph"] == "M"}
    assert "match-dispatch" in names


def test_requeued_request_closes_its_spans_once():
    """A batch that a failing replica took and requeued closes each
    request's ``serve.submit`` and ``serve.queue`` spans at its first
    dispatch only, on the replicas' worker threads."""
    from repro_torch.service.queue import CoalescingQueue, MatchRequest
    rec = Recorder(MetricsRegistry(), Trace("log", maxlen=256))

    def dispatch(batch, rid):
        if rid == 0:
            raise RuntimeError("replica 0 crashed")
        for r in batch:
            r.done.set()
    q = CoalescingQueue(dispatch, n_replicas=2, metrics=rec.metrics,
                        window_s=0.0, max_batch=4,
                        place=lambda live, depths: 0 if 0 in live
                        else live[0], recorder=rec)
    reqs = [MatchRequest(query=np.zeros(4, np.float32),
                         t_call_ns=obs_trace.clock_ns()) for _ in range(3)]
    for r in reqs:
        q.submit(r)
    q.start()
    for r in reqs:
        assert r.wait(30) and r.error is None and r.requeues == 1
    q.close()
    c = rec.metrics.snapshot()["counters"]
    assert c["serve.batches"] == 2 and c["serve.submit_calls"] == 3
    spans = list(rec.log.spans)
    first, _ = sorted(s.ident for s in spans if s.name == "serve.dispatch")
    for name, key in (("serve.submit", "serve.submit_s"),
                      ("serve.queue", "serve.queue_wait_s")):
        closed = [s for s in spans if s.name == name]
        assert sorted(s.ident for s in closed) == sorted(r.rid for r in reqs)
        assert c[key] == pytest.approx(sum(s.seconds for s in closed))
    assert {r.dispatch for r in reqs} == {first}


def test_span_log_and_counters_under_threads():
    """More threads than cores, a short switch interval: every span's
    count and every log entry arrives, each thread's spans under their
    own parent."""
    rec = Recorder(MetricsRegistry(), Trace("log", maxlen=1 << 16))
    n_threads, n_spans = 16, 400
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)

    def work():
        with recording(rec):
            for _ in range(n_spans):
                with obs_trace.span("t.outer", count="t.calls"):
                    with obs_trace.span("inner"):
                        pass
    try:
        ts = [threading.Thread(target=work) for _ in range(n_threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(60)
        assert not any(t.is_alive() for t in ts)
    finally:
        sys.setswitchinterval(old)
    c = rec.metrics.snapshot()["counters"]
    assert c["t.calls"] == n_threads * n_spans
    assert c["t.outer.inner_s"] <= c["t.outer_s"]
    spans = list(rec.log.spans)
    assert len(spans) == 2 * n_threads * n_spans
    by_id = {s.sid: s for s in spans}
    for s in spans:
        if s.name == "inner":
            p = by_id[s.parent]
            assert p.name == "t.outer" and p.tid == s.tid


def span_cost_us(n: int = 200_000) -> dict:
    """Microseconds per span, open to close, best of 5 loops of ``n``:
    by what is attached, nested in an open span (a round's waits) or
    outermost (its sums go to the registry at once)."""
    from contextlib import nullcontext

    def loop(rec, nested):
        best = float("inf")
        for _ in range(5):
            with recording(rec), (obs_trace.span("cost.outer") if nested
                                  else nullcontext()):
                t0 = time.perf_counter()
                for _ in range(n):
                    with obs_trace.span("wait"):
                        pass
                best = min(best, (time.perf_counter() - t0) / n * 1e6)
        return best
    return {
        "registry, log off, nested": loop(Recorder(MetricsRegistry()), True),
        "registry, log off, outermost": loop(Recorder(MetricsRegistry()),
                                             False),
        "registry, log on, nested": loop(Recorder(
            MetricsRegistry(), Trace("cost", maxlen=65536)), True),
        "nothing attached": loop(None, False)}


def test_spans_on_card_bracket_the_device_work():
    """On the card, a few served dispatches under ``torch.profiler`` with
    CPU and CUDA activity and the span log on: each ``match.sweep`` span
    holds the host call that launched its dispatch's K2 sweep, and each
    round's ``wait`` ends after the device work issued before it, within
    0.2 ms.  Prints what one span costs and how late the waits end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.core import SSAX
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.kernels.ops import make_pairwise
    for what, us in span_cost_us().items():
        print(f"[spans] one span, {what}: {us:.3f} us")
    c, n_disp, n = 64, 4, 262_144
    n_q = c * (n_disp + 1)
    X = season_corpus(n + n_q, 960, 10, 0.5, seed=5,
                      per_series_strength=True)
    enc = SSAX(T=960, W=48, L=10, A_seas=9, A_res=64, r2_season=0.5)
    eng = make_engine_service(enc, X[n_q:], make_mesh(1, "cuda"),
                              batch_size=256, verify="device",
                              pairwise=make_pairwise(enc))
    sess = MatchSession(eng, metrics=MetricsRegistry(),
                        span_log=65536).start()

    def serve(qs):
        reqs = [sess.submit(q, k=1) for q in qs]
        for r in reqs:
            assert r.wait(300) and r.ok, r.error
    serve(X[:c])                                  # builds and warms
    n_warm = len(sess.spans())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for i in range(1, n_disp + 1):
            serve(X[i * c:(i + 1) * c])
        torch.cuda.synchronize()
    sess.close()
    off = sess.span_log.clock_offset_ns
    spans = sess.spans()[n_warm:]
    events = list(prof.profiler.kineto_results.events())
    on_dev = [e for e in events if str(e.device_type()).endswith("CUDA")]
    runtime = {e.correlation_id(): e for e in events
               if not str(e.device_type()).endswith("CUDA")
               and e.name().startswith(("cuda", "cu"))}
    launches = [runtime.get(e.linked_correlation_id())
                or runtime.get(e.correlation_id())
                for e in on_dev if "ssax_dist" in e.name()]
    assert launches and None not in launches
    sweeps = [s for s in spans if s.name == "match.sweep"]
    assert len(sweeps) >= n_disp
    for s in sweeps:
        a, b = s.start_ns + off, s.end_ns + off
        assert sum(a <= e.start_ns() and e.start_ns() + e.duration_ns()
                   <= b for e in launches) == 1, s.sid
    by_id = {s.sid: s for s in spans}
    waits = [s for s in spans if s.name == "wait"
             and by_id.get(s.parent) is not None
             and by_id[s.parent].name == "match.round"]
    assert waits
    ends = [(e.start_ns(), e.start_ns() + e.duration_ns()) for e in on_dev]
    lags = sorted(w.end_ns + off - max(b for a, b in ends
                                       if a < w.end_ns + off)
                  for w in waits)
    print(f"[spans] {len(sweeps)} sweeps, {len(launches)} K2 launches; "
          f"{len(waits)} round waits end {lags[0] / 1e3:.1f} to "
          f"{lags[-1] / 1e3:.1f} us (median {lags[len(lags) // 2] / 1e3:.1f})"
          " after the device work before them")
    assert 0 <= lags[0] and lags[-1] <= 200_000
