"""The port's observability on the CPU (T=480, W=24, L=10, N=240).

Units: metrics (counters, gauges, fixed-bucket histograms, snapshot
merges, concurrent recording), traces (span nesting, accumulation,
JSON export), EXPLAIN rendering and the trace check, and the fence.
Neutrality: for all four encoders, linear and indexed, a traced call
and a ``metrics=`` call return the same ids, distances, raw accesses,
rounds and store accounting as an untraced one, and call the plain
kernels exactly as often.  Against the JAX package: for one query
batch the span names, the per-query generated / verified counts and
the metric names are the reference's."""

import json
import math
import threading

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MatchEngine, make_technique  # noqa: E402
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.obs import (  # noqa: E402
    LATENCY_BUCKETS, REQUIRED_SPANS, Histogram, MetricsRegistry, Trace,
    block_until_ready, check_trace, maybe_span, merge_snapshots,
    render_trace)
from repro_torch.store import SymbolicStore  # noqa: E402

T, W, L, N, NQ = 480, 24, 10, 240, 3
TECHS = ("sax", "ssax", "tsax", "stsax")
PLAIN = ("euclid_gather_ref", "euclid_ref", "paa_ref", "sax_dist_ref",
         "ssax_dist_ref", "ssax_dist_batch_ref")


# -- metrics -------------------------------------------------------------------

def test_counter_gauge_histogram_basics():
    reg = MetricsRegistry()
    reg.counter("c").inc()
    reg.counter("c").inc(2.5)
    reg.gauge("g").set(0.25)
    reg.gauge("g").set(0.75)
    h = reg.histogram("h")
    for v in (1e-5, 1e-5, 2.0):
        h.observe(v)
    snap = reg.snapshot()
    assert snap["counters"]["c"] == 3.5
    assert snap["gauges"]["g"] == 0.75
    assert snap["histograms"]["h"]["count"] == 3
    assert sum(snap["histograms"]["h"]["counts"]) == 3
    assert reg.histogram("h") is h
    json.dumps(snap)


def test_registry_kind_mismatch_and_reset():
    reg = MetricsRegistry()
    reg.counter("x").inc(7)
    for get in (reg.gauge, reg.histogram):
        with pytest.raises(TypeError):
            get("x")
    reg.reset()
    assert reg.snapshot() == {"counters": {}, "gauges": {},
                              "histograms": {}}
    assert reg.counter("x").value == 0.0


def test_histogram_quantile_and_bounds():
    from repro.obs import LATENCY_BUCKETS as REF_BUCKETS
    assert LATENCY_BUCKETS == REF_BUCKETS
    h = Histogram()
    assert h.bounds == LATENCY_BUCKETS
    assert math.isnan(h.quantile(0.5))
    for _ in range(99):
        h.observe(1e-4)
    h.observe(1e6)
    assert 1e-4 <= h.quantile(0.5) < 2e-4
    assert h.quantile(1.0) == float("inf")
    with pytest.raises(ValueError):
        Histogram((1.0, 2.0)).merge(Histogram((1.0, 3.0)))
    assert Histogram.from_dict(h.to_dict()).to_dict() == h.to_dict()


def test_merge_snapshots_deterministic():
    obs_a, obs_b = [1e-5, 3e-3, 0.2], [4e-6, 0.2, 50.0, 1e9]
    split = []
    for obs in (obs_a, obs_b):
        reg = MetricsRegistry()
        reg.counter("n").inc(len(obs))
        for v in obs:
            reg.histogram("lat").observe(v)
        split.append(reg.snapshot())
    merged = merge_snapshots(split[0], split[1])
    one = MetricsRegistry()
    one.counter("n").inc(len(obs_a) + len(obs_b))
    for v in obs_a + obs_b:
        one.histogram("lat").observe(v)
    assert merged == one.snapshot()
    assert merge_snapshots(merged, None) == merged


def test_concurrent_recording_loses_nothing():
    reg, n_threads, n_ops = MetricsRegistry(), 8, 400

    def hammer(tid):
        for i in range(n_ops):
            reg.counter("c.total").inc()
            reg.counter(f"c.thread{tid}").inc(2)
            reg.histogram("h.lat").observe(1e-5 * (i % 7 + 1))
            reg.gauge(f"g.thread{tid}").set(float(i))
    ts = [threading.Thread(target=hammer, args=(t,))
          for t in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    snap = reg.snapshot()
    assert snap["counters"]["c.total"] == n_threads * n_ops
    for t in range(n_threads):
        assert snap["counters"][f"c.thread{t}"] == 2 * n_ops
    assert snap["histograms"]["h.lat"]["count"] == n_threads * n_ops


def test_merged_phase_snapshots_equal_shared_registry():
    shared, phases = MetricsRegistry(), [MetricsRegistry() for _ in range(3)]

    def worker():
        for p, reg in enumerate(phases):
            for i in range(50):
                for r in (reg, shared):
                    r.counter("c.ops").inc()
                    r.histogram("h.lat").observe(1e-4 * (i % 5 + 1 + p))
    ts = [threading.Thread(target=worker) for _ in range(4)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    merged = None
    for reg in phases:
        merged = merge_snapshots(merged, reg.snapshot())
    want = shared.snapshot()
    assert merged["counters"] == want["counters"]
    assert merged["histograms"]["h.lat"]["counts"] == \
        want["histograms"]["h.lat"]["counts"]


def test_snapshot_while_recording_does_not_deadlock():
    reg, stop = MetricsRegistry(), threading.Event()

    def rec():
        while not stop.is_set():
            reg.counter("c.x").inc()
            reg.histogram("h.x").observe(1e-3)
    ts = [threading.Thread(target=rec) for _ in range(3)]
    for t in ts:
        t.start()
    try:
        for _ in range(200):
            assert set(reg.snapshot()) == {"counters", "gauges",
                                           "histograms"}
    finally:
        stop.set()
        for t in ts:
            t.join()
    assert reg.snapshot()["counters"]["c.x"] > 0


# -- traces, explain, fence ------------------------------------------------------

def test_trace_span_nesting_and_accumulation():
    tr = Trace("t")
    with tr.span("order"):
        with tr.span("seed"):
            pass
    with tr.span("verify"):
        pass
    assert tr.span_names() == ["order", "order/seed", "verify"]
    assert tr.has_span("seed") and not tr.has_span("nope")
    assert tr.span_seconds("order") >= tr.span_seconds("seed") >= 0.0
    live = np.array([1, 2], np.int64)
    tr.add("examined", live)
    live[:] = 99                          # the caller's buffer moves on
    tr.add("examined", np.array([10, 20], np.int64))
    np.testing.assert_array_equal(tr.get("examined"), [11, 22])
    tr.note_ids("generated", 0, [3, 4])
    tr.note_ids("generated", 0, [4, 5])
    tr.note_counts("generated", [2, 0])
    np.testing.assert_array_equal(tr.unique_counts("generated", 2), [5, 0])
    assert tr.unique_counts("other", 2) is None
    tr.record_round(phase="scan", kth=np.array([1.5], np.float32))
    d = tr.to_dict()
    json.dumps(d)
    assert d["rounds"][0]["kth"] == [1.5]
    assert maybe_span(None, "a") is maybe_span(None, "b")


def _fake_trace(**overrides):
    tr = Trace("match.topk")
    tr.meta.update(engine="match", k=4, q_n=2, total=100,
                   source="linear", verify="host")
    for name in REQUIRED_SPANS:
        with tr.span(name):
            pass
    tr.add("generated", np.array([100, 100], np.int64))
    tr.add("examined", np.array([20, 30], np.int64))
    tr.add("verified", np.array([20, 30], np.int64))
    tr.set("pruning_power", np.array([0.8, 0.7]))
    tr.add("rows_fetched", 50)
    tr.add("seeks", 2)
    tr.add("modeled_io_s", 0.01)
    tr.record_round(phase="scan", active=2, examined=50,
                    kth=np.array([1.0, 2.0]), wall_s=0.001)
    tr.meta.update(overrides)
    return tr


def test_render_and_check_trace():
    out = render_trace(_fake_trace())
    assert "match.topk" in out and "k=4" in out
    assert "order" in out and "verify" in out
    assert "pruning" in out and "50 rows in 2 seeks" in out
    assert check_trace(_fake_trace()) == []
    joined = " ".join(check_trace(Trace("match.topk")))
    assert "order" in joined and "verify" in joined and "rounds" in joined
    assert check_trace(None) == ["no trace recorded"]
    assert check_trace(_fake_trace(), device=True)
    assert check_trace(_fake_trace(host_order_bytes=0, rows_to_host=0),
                       device=True) == []
    assert len(check_trace(_fake_trace(host_order_bytes=4096,
                                       rows_to_host=3), device=True)) == 2


def test_fence_passes_over_host_values_by_type(monkeypatch):
    """Host values never reach ``torch.cuda.synchronize``; the fence
    catches nothing."""
    def no_sync(*a):
        raise AssertionError("synchronize called for a host value")
    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    for value in (None, np.zeros(3), (np.zeros(2), None), 1.5,
                  torch.zeros(3), [torch.zeros(1), {"a": np.ones(1)}]):
        block_until_ready(value)
    tr = Trace("t")
    with tr.span("verify", fence=(torch.zeros(2), None)):
        pass
    assert tr.span_seconds("verify") >= 0.0


def test_fence_synchronizes_cuda_tensors():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the fence synchronizes it")
    x = torch.ones(1 << 20, device="cuda")
    block_until_ready((x * 2, None, np.zeros(1)))


# -- neutrality ----------------------------------------------------------------

@pytest.fixture(scope="module")
def season():
    X = season_dataset(N + NQ, T, L, 0.7, per_series_strength=True, seed=5)
    return X[:NQ], X[NQ:]


def _store(tech, D):
    store = SymbolicStore.from_rows(make_technique(tech, T=T, W=W, L=L), D,
                                    media="ssd", device="cpu")
    store.build_index(leaf_fill=16)
    return store


def _fingerprint(res, store):
    return {"ids": res.indices.copy(), "distances": res.distances.copy(),
            "raw_accesses": res.raw_accesses.copy(), "rounds": res.rounds,
            "store_accesses": res.store_accesses,
            "store_fetches": res.store_fetches,
            "io_seconds": res.io_seconds, "accesses": store.accesses,
            "fetches": store.fetches}


@pytest.fixture
def plain_calls(monkeypatch):
    """Counts of the plain kernels' calls (what the wrappers run on the
    CPU in place of K1-K4)."""
    calls = dict.fromkeys(PLAIN, 0)
    for name in PLAIN:
        real = getattr(ref, name)

        def counted(*a, _name=name, _real=real, **kw):
            calls[_name] += 1
            return _real(*a, **kw)
        monkeypatch.setattr(ref, name, counted)
    return calls


@pytest.mark.parametrize("source", [None, "index"])
@pytest.mark.parametrize("tech", TECHS)
def test_tracing_and_metrics_are_neutral(season, plain_calls, tech, source):
    Q, D = season
    store = _store(tech, D)
    plain = MatchEngine(store.encoder, store, verify="kernel",
                        batch_size=32, pairwise=ops.make_pairwise(
                            store.encoder), device="cpu")
    reg = MetricsRegistry()
    metered = MatchEngine(store.encoder, store, verify="kernel",
                          batch_size=32, pairwise=ops.make_pairwise(
                              store.encoder), metrics=reg, device="cpu")
    runs = {}
    for name, call in (
            ("base", lambda: plain.topk(Q, k=4, source=source)),
            ("explain", lambda: plain.topk(Q, k=4, source=source,
                                           explain=True)),
            ("trace", lambda: plain.topk(Q, k=4, source=source,
                                         trace=Trace("given"))),
            ("metrics", lambda: metered.topk(Q, k=4, source=source)),
            ("replay", lambda: plain.topk(Q, k=4, source=source))):
        store.reset()
        before = dict(plain_calls)
        res = call()
        runs[name] = (_fingerprint(res, store),
                      {n: plain_calls[n] - before[n] for n in PLAIN}, res)
    base_fp, base_calls, _ = runs["base"]
    assert base_calls["euclid_gather_ref"] == base_fp["rounds"] > 0
    for name, (fp, calls, res) in runs.items():
        assert calls == base_calls, name
        for key, want in base_fp.items():
            assert np.array_equal(fp[key], want), (name, key)
        assert hasattr(res, "trace") == (name in ("explain", "trace"))
    for name in ("explain", "trace"):
        trace = runs[name][2].trace
        assert check_trace(trace) == [], name
        json.dumps(trace.to_dict())
        assert trace.get("source") == ("index" if source else "linear")
        assert len(trace.rounds) == base_fp["rounds"]
    snap = reg.snapshot()
    assert snap["counters"]["match.queries"] == NQ
    assert snap["counters"]["match.rows_fetched"] == base_fp["accesses"]
    assert snap["histograms"]["match.topk_latency_s"]["count"] == 1


def test_approximate_path_is_neutral_and_traced(season):
    Q, D = season
    store = _store("ssax", D)
    eng = MatchEngine(store.encoder, store, verify="numpy", device="cpu")
    base = eng.topk(Q, k=3, exact=False)
    res = eng.topk(Q, k=3, exact=False, explain=True)
    np.testing.assert_array_equal(res.indices, base.indices)
    np.testing.assert_array_equal(res.distances, base.distances)
    assert res.trace.get("exact") is False
    assert [r["phase"] for r in res.trace.rounds] == ["approx"]
    assert check_trace(res.trace) == []


# -- against the reference -----------------------------------------------------

@pytest.mark.parametrize("source", [None, "index"])
def test_trace_matches_reference(season, source):
    import dataclasses
    from repro.core import MatchEngine as RefEngine
    from repro.core import make_technique as ref_make
    from repro.obs import MetricsRegistry as RefRegistry
    from repro.store import SymbolicStore as RefStore
    from repro_torch.core import from_reference
    Q, D = season
    renc = ref_make("ssax", T=T, W=W, L=L)
    rstore = RefStore.from_rows(renc, D, media="ssd")
    rstore.build_index(leaf_fill=16)
    rreg = RefRegistry()
    want = RefEngine(renc, rstore, verify="numpy", batch_size=32,
                     metrics=rreg).topk(Q, k=4, source=source,
                                        explain=True)
    enc = from_reference("SSAX", dataclasses.asdict(renc))
    store = SymbolicStore.from_rows(enc, D, media="ssd", device="cpu")
    store.build_index(leaf_fill=16)
    reg = MetricsRegistry()
    got = MatchEngine(enc, store, verify="numpy", batch_size=32,
                      metrics=reg, device="cpu").topk(
        Q, k=4, source=source, explain=True)
    np.testing.assert_array_equal(got.indices, want.indices)
    assert got.trace.span_names() == want.trace.span_names()
    for key in ("generated", "verified", "examined", "generated_unique"):
        np.testing.assert_array_equal(got.trace.get(key),
                                      want.trace.get(key), err_msg=key)
    assert [r["phase"] for r in got.trace.rounds] == \
        [r["phase"] for r in want.trace.rounds]
    assert check_trace(got.trace) == []
    ours, theirs = reg.snapshot(), rreg.snapshot()
    for kind in ("counters", "gauges", "histograms"):
        assert sorted(ours[kind]) == sorted(theirs[kind]), kind
