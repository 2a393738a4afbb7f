"""The port's matching service (``repro_torch.service``) on the CPU,
following the reference's ``tests/test_service.py`` and the service half
of ``tests/test_epochs.py``, with host-route engines (``MatchEngine``,
``verify="host"``) and device-route engines (``make_engine_service`` on
``make_mesh(1|2, device="cpu")``, ``verify="device"``).

Within the port, bitwise: a planner-routed exact answer equals a direct
``engine.topk`` with that tier's source; a coalesced batch answers every
request as it is answered alone (odd sizes and every power-of-two bucket
to 8); an epoch-pinned answer equals a store frozen at the pin while a
writer ingests; replicas over one store answer alike.  Against the
reference (``repro.service`` over the reference's engine): the same
requests get the same ids, distances within rtol 1e-5, through the same
tiers.  Plus the front-end contracts: sheds carry reasons and sum to
``serve.rejected``, an engine error resolves its requests, deadline
downgrades carry an error bar, the planner routes, learns, seeds and
persists, and the ``selfjoin`` tier answers from the exact profile."""

import os
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import MatchEngine, make_technique  # noqa: E402
from repro_torch.core.distributed import (  # noqa: E402
    make_engine_service, make_mesh)
from repro_torch.data.synthetic import season_dataset  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.service import (  # noqa: E402
    SHED_ENGINE_ERROR, TIERS, CoalescingQueue, MatchRequest, MatchSession,
    QueryPlanner)
from repro_torch.store import SymbolicStore  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
L = 10
TECHS = ("sax", "ssax", "tsax", "stsax")
TECH_KW = {"sax": {}, "ssax": {"r2_season": 0.7}, "tsax": {"r2_trend": 0.3},
           "stsax": {"r2_season": 0.5}}
T = 240


def _enc(tech, t=T):
    return make_technique(tech, T=t, W=t // (2 * L), L=L, **TECH_KW[tech])


def _data(n=64, n_q=5, seed=5, t=T):
    X = season_dataset(n + n_q, t, L, 0.7, per_series_strength=True,
                       seed=seed)
    return X[:n_q], X[n_q:]


def _host_engine(tech, D, t=T):
    enc = _enc(tech, t)
    store = SymbolicStore.from_rows(enc, D, media="ssd", device="cpu")
    store.build_index(leaf_fill=16)
    return MatchEngine(enc, store, verify="host", batch_size=32,
                       device="cpu")


def _device_engine(tech, D, t=T, shards=1):
    eng = make_engine_service(_enc(tech, t), D, make_mesh(shards, "cpu"),
                              batch_size=32, verify="device")
    eng.store.build_index(leaf_fill=16)
    return eng


ENGINES = {"host": _host_engine, "device": _device_engine}


def _served(sess, queries, **kw):
    """Submit before start (one coalesced batch), wait, close."""
    reqs = [sess.submit(q, **kw) for q in queries]
    sess.start()
    for r in reqs:
        assert r.wait(120) and r.ok, r.error
    sess.close()
    return reqs


# ---------------------------------------------------------------------------
# exactness and batching neutrality
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("tech", TECHS)
@pytest.mark.parametrize("verify", ["host", "device"])
def test_exact_tiers_bitwise_and_batch_neutral(tech, verify):
    """Coalesced, planner-routed exact answers == direct per-request
    ``topk`` for both exact tiers, all encoders, both routes."""
    k = 4
    Q, D = _data()
    engine = ENGINES[verify](tech, D)
    src = {"index": "index", "linear": None}
    for tier in ("index", "linear"):
        sess = MatchSession(engine, metrics=MetricsRegistry(),
                            window_s=0.05, max_batch=len(Q))
        reqs = _served(sess, Q, k=k, tier=tier)
        assert all(r.tier_served == tier for r in reqs)
        batch = engine.topk(Q, k=k, source=src[tier])
        for i, r in enumerate(reqs):
            solo = engine.topk(Q[i][None], k=k, source=src[tier])
            label = (tech, verify, tier, i)
            assert np.array_equal(r.indices, batch.indices[i]), label
            assert np.array_equal(r.distances, batch.distances[i]), label
            assert np.array_equal(r.indices, solo.indices[0]), label
            assert np.array_equal(r.distances, solo.distances[0]), label


@pytest.mark.parametrize("tech", TECHS)
def test_batch_neutrality_every_bucket(tech):
    """Coalesced batches of 1, 2, 3, 4, 5 and 8 requests (every padded
    bucket up to 8) on the device route answer each request as it is
    answered alone."""
    k = 3
    Q, D = _data(n_q=8, seed=6)
    engine = _device_engine(tech, D, shards=2)
    solo = [engine.topk(q[None], k=k) for q in Q]
    for n_sub in (1, 2, 3, 4, 5, 8):
        sess = MatchSession(engine, metrics=MetricsRegistry(),
                            window_s=0.05, max_batch=8)
        reqs = _served(sess, Q[:n_sub], k=k, tier="linear")
        for i, r in enumerate(reqs):
            assert np.array_equal(r.indices, solo[i].indices[0]), n_sub
            assert np.array_equal(r.distances, solo[i].distances[0]), n_sub
    assert np.array_equal(MatchSession._bucket(Q[:4]), Q[:4])
    assert np.array_equal(MatchSession._bucket(Q[:5]),
                          np.concatenate([Q[:5], np.repeat(Q[4:5], 3, 0)]))


@pytest.mark.parametrize("verify", ["host", "device"])
def test_subseq_session_exact_tiers(verify):
    """The session serves a ``SubseqEngine``: exact window answers equal
    a direct windowed ``topk`` bitwise (the device route on a mesh)."""
    from repro_torch.subseq import SubseqEngine, WindowView
    n, t, m, stride, k = 6, 360, 120, 6, 3
    rng = np.random.default_rng(9)
    D = season_dataset(n, t, L, 0.7, per_series_strength=True, seed=9)
    rows_ = rng.integers(0, n, size=3)
    offs = rng.integers(0, t - m, size=3)
    Q = np.stack([D[r, o:o + m] for r, o in zip(rows_, offs)])
    view = WindowView(_enc("ssax", m), D, stride=stride, media="ssd",
                      device="cpu")
    view.build_index(leaf_fill=16)
    mesh = make_mesh(2, "cpu") if verify == "device" else None
    engine = SubseqEngine(view, verify=verify, batch_size=64, mesh=mesh)
    for tier, use_index in (("index", True), ("linear", False)):
        sess = MatchSession(engine, metrics=MetricsRegistry(),
                            window_s=0.05, max_batch=4)
        reqs = _served(sess, Q, k=k, tier=tier)
        for i, r in enumerate(reqs):
            solo = engine.topk(Q[i][None], k=k, use_index=use_index)
            assert np.array_equal(r.indices, solo.window_ids[0])
            assert np.array_equal(r.rows, solo.rows[0])
            assert np.array_equal(r.starts, solo.starts[0])
            assert np.array_equal(r.distances, solo.distances[0])
            assert r.epoch is not None


@pytest.mark.parametrize("tech", TECHS)
def test_session_answers_equal_the_reference(tech):
    """The same requests through the port's session and the reference's
    session: the same tiers, ids bitwise, distances within rtol 1e-5."""
    pytest.importorskip("jax")
    from repro.core import MatchEngine as RefEngine
    from repro.core import make_technique as ref_make
    from repro.obs import MetricsRegistry as RefRegistry
    from repro.service import MatchSession as RefSession
    from repro.store import SymbolicStore as RefStore
    k = 4
    Q, D = _data(seed=7)
    engine = _host_engine(tech, D)
    renc = ref_make(tech, T=T, W=T // (2 * L), L=L, **TECH_KW[tech])
    rstore = RefStore.from_rows(renc, D, media="ssd")
    rstore.build_index(leaf_fill=16)
    rengine = RefEngine(renc, rstore, verify="host", batch_size=32)
    for tier in ("index", "linear", "approx"):
        got = _served(MatchSession(engine, metrics=MetricsRegistry(),
                                   window_s=0.05, max_batch=8),
                      Q, k=k, tier=tier)
        want = _served(RefSession(rengine, metrics=RefRegistry(),
                                  window_s=0.05, max_batch=8),
                       Q, k=k, tier=tier)
        for g, w in zip(got, want):
            assert g.tier_served == w.tier_served == tier
            np.testing.assert_array_equal(g.indices, w.indices)
            np.testing.assert_allclose(g.distances, w.distances, rtol=1e-5)
            assert g.epoch.n_rows == w.epoch.n_rows == len(D)


# ---------------------------------------------------------------------------
# admission, errors, deadlines
# ---------------------------------------------------------------------------

def test_shed_accounting_and_reasons():
    """Every rejected request carries a reason; per-reason counters sum
    to ``serve.rejected``; nothing is silently dropped."""
    Q, D = _data()
    engine = _host_engine("sax", D)
    reg = MetricsRegistry()
    sess = MatchSession(engine, metrics=reg, window_s=0.0,
                        max_batch=2, max_queue=2)
    sheds = [sess.submit(np.zeros(7)),                 # bad shape
             sess.submit(Q[0], k=0),                   # bad k
             sess.submit(Q[0], tier="nope"),           # bad tier
             sess.submit(Q[0], deadline_s=-1.0)]       # dead budget
    bad_vals = Q[0].copy()
    bad_vals[0] = np.nan
    sheds.append(sess.submit(bad_vals))                # non-finite
    ok1 = sess.submit(Q[0])
    ok2 = sess.submit(Q[1])
    sheds.append(sess.submit(Q[2]))                    # queue full
    for r in sheds:
        assert r.done.is_set() and not r.ok and r.error is not None
        assert r.shed_reason in ("bad_query", "deadline_expired",
                                 "queue_full")
    sess.start()
    sess.close()
    assert ok1.ok and ok2.ok
    sess2 = MatchSession(engine, metrics=reg, window_s=0.0, max_batch=2)
    late = MatchRequest(query=Q[0].astype(np.float32))
    sess2.start()
    sess2.close()
    sess2.queue.submit(late)                           # after shutdown
    assert late.shed_reason == "shutdown"
    c = reg.snapshot()["counters"]
    shed_total = sum(v for name, v in c.items()
                     if name.startswith("serve.shed."))
    assert shed_total == c["serve.rejected"] == len(sheds) + 1
    assert c["serve.requests"] == 2


def test_engine_error_resolves_requests():
    """A dispatch exception sheds the batch with ``engine_error``: the
    request is resolved with the error, never served."""
    def boom(batch):
        raise RuntimeError("kaput")

    reg = MetricsRegistry()
    q = CoalescingQueue(boom, window_s=0.0, max_batch=4, metrics=reg)
    req = MatchRequest(query=np.zeros(4, np.float32))
    q.submit(req)
    q.start()
    assert req.wait(30)
    q.close()
    assert req.shed_reason == SHED_ENGINE_ERROR and "kaput" in req.error
    assert not req.ok and req.indices is None
    c = reg.snapshot()["counters"]
    assert c["serve.shed.engine_error"] == c["serve.rejected"] == 1


def test_session_engine_error_is_not_served():
    """An engine that raises inside a session's dispatch (as a kernel
    launch on a missing card would) resolves every request of the batch
    with the error; none is counted served."""
    Q, D = _data()
    engine = _host_engine("ssax", D)

    def broken(*a, **kw):
        raise RuntimeError("CUDA kernel euclid failed to launch")
    engine.topk = broken
    reg = MetricsRegistry()
    sess = MatchSession(engine, metrics=reg, window_s=0.01, max_batch=8)
    reqs = [sess.submit(q, k=2, tier="linear") for q in Q]
    sess.start()
    for r in reqs:
        assert r.wait(30)
    sess.close()
    assert all(not r.ok and r.shed_reason == SHED_ENGINE_ERROR
               and "euclid" in r.error and r.tier_served is None
               for r in reqs)
    c = reg.snapshot()["counters"]
    assert c["serve.rejected"] == len(Q)
    assert "serve.tier.linear" not in c


@pytest.mark.parametrize("verify", ["host", "device"])
def test_deadline_downgrade_serves_approx_with_error_bar(verify):
    """A request whose budget cannot cover the exact tier is downgraded
    (not shed): served from the anytime tier with kth_lb and an error
    bar that certifies the exact answer."""
    k = 4
    Q, D = _data()
    engine = ENGINES[verify]("stsax", D)
    reg = MetricsRegistry()
    sess = MatchSession(engine, metrics=reg, window_s=0.0, max_batch=4)
    sess.calibrate(Q[:1], k=k)
    sess.planner._est["index"].wall_s = 10.0
    sess.planner._est["linear"].wall_s = 10.0
    sess.start()
    reqs = [sess.submit(q, k=k, deadline_s=5.0) for q in Q]
    for r in reqs:
        assert r.wait(120)
    sess.close()
    exact = engine.topk(Q, k=k, source="index")
    for i, r in enumerate(reqs):
        assert r.ok, r.error
        assert r.tier_served == "approx"
        assert r.plan is not None and r.plan.downgraded
        assert r.kth_lb is not None and r.error_bar is not None
        assert r.error_bar >= 0.0
        assert r.kth_lb <= exact.distances[i, -1] + 1e-5
        if r.error_bar == 0.0:
            assert np.array_equal(r.indices, exact.indices[i])
    assert reg.snapshot()["counters"]["serve.downgraded"] == len(Q)


def test_deadline_rechecked_at_dispatch():
    X = season_dataset(34, T, L, 0.7, per_series_strength=True, seed=11)
    Q, D = X[:2], X[2:]
    engine = _host_engine("ssax", D)
    reg = MetricsRegistry()
    sess = MatchSession(engine, metrics=reg, window_s=0.01, max_batch=8)
    req = MatchRequest(query=Q[0], k=1)
    req.t_submit = time.monotonic() - 1.0
    req.t_deadline = time.monotonic() - 0.5            # already expired
    sess._run_group("linear", 1, [req])
    assert req.done.is_set() and not req.ok
    assert req.shed_reason == "deadline_expired"
    snap = reg.snapshot()["counters"]
    assert snap.get("serve.shed.deadline_expired") == 1
    assert snap.get("serve.rejected") == 1
    ok_req = MatchRequest(query=Q[1], k=1)
    ok_req.t_submit = time.monotonic()
    ok_req.t_deadline = time.monotonic() + 60.0
    sess._run_group("linear", 1, [ok_req])
    assert ok_req.ok and ok_req.tier_served == "linear"


# ---------------------------------------------------------------------------
# the planner
# ---------------------------------------------------------------------------

def test_planner_routing_and_learning():
    planner = QueryPlanner(total=10_000, has_index=True)
    d = planner.route(k=1)
    assert d.tier == "index" and d.reason == "cost"

    class _R:
        raw_accesses = np.array([100.0])
    planner.observe("index", 1, 5.0, _R())
    planner.observe("linear", 1, 0.01, _R())
    assert planner.route(k=1).tier == "linear"
    d = planner.route(k=1, deadline_left=1e-4)
    assert d.tier == "approx" and d.downgraded
    assert planner.route(k=1, tier="linear").reason == "forced"
    p2 = QueryPlanner(total=100, has_index=False)
    assert p2.route(k=1).tier == "linear"
    assert p2.route(k=1).reason == "only_tier"
    assert TIERS == ("index", "linear", "approx")
    assert not p2.servable("selfjoin") and not p2.servable("index")


def test_planner_seeds_from_registry_history():
    reg = MetricsRegistry()
    for _ in range(8):
        reg.histogram("match.topk_latency_s").observe(0.25)
    planner = QueryPlanner(total=1000, has_index=True)
    planner.seed_from_metrics(reg)
    assert 0.2 <= planner.estimate("index") <= 0.5
    assert 0.2 <= planner.estimate("linear") <= 0.5
    empty = QueryPlanner(total=1000, has_index=True)
    before = empty.snapshot()
    empty.seed_from_metrics(MetricsRegistry())
    assert empty.snapshot() == before


def test_planner_placement_prefers_the_faster_replica():
    p = QueryPlanner(total=100, has_index=True)
    p.observe_replica(0, 0.5)
    p.observe_replica(1, 0.1)
    assert p.place([0, 1], {0: 0, 1: 0}) == 1
    assert p.place([0, 1], {0: 0, 1: 9}) == 0
    assert p.place([0], {0: 3}) == 0
    with pytest.raises(ValueError):
        p.place([], {})


def test_planner_state_roundtrip(tmp_path):
    k = 3
    X = season_dataset(44, T, L, 0.7, per_series_strength=True, seed=11)
    Q, D = X[:4], X[4:]
    engine = _host_engine("ssax", D)
    sd = str(tmp_path / "svc")
    sess = MatchSession(engine, metrics=MetricsRegistry(),
                        window_s=0.01, max_batch=8, state_dir=sd)
    sess.start()
    for r in sess.serve(Q, k=k):
        assert r.ok, r.error
    before = sess.planner.snapshot()
    sess.close()                         # close persists planner.json
    assert (tmp_path / "svc" / "planner.json").exists()
    assert any(e["n_obs"] > 0 for e in before.values())
    sess2 = MatchSession(engine, metrics=MetricsRegistry(),
                         window_s=0.01, max_batch=8, state_dir=sd)
    after = sess2.planner.snapshot()
    for tier, e in before.items():
        assert after[tier]["wall_s"] == pytest.approx(e["wall_s"])
        assert after[tier]["n_obs"] == e["n_obs"]
    p = QueryPlanner(total=100, has_index=False)
    p.observe("linear", 1, 0.5, type("R", (), {
        "raw_accesses": np.array([3.0])})())
    p.seed_from_snapshot({"linear": {"wall_s": 9.0, "cands": 1,
                                     "n_obs": 50}})
    assert p.estimate("linear") == pytest.approx(0.5)
    (tmp_path / "bad").mkdir()
    (tmp_path / "bad" / "planner.json").write_text("{not json")
    sess3 = MatchSession(engine, state_dir=str(tmp_path / "bad"))
    assert sess3.planner.snapshot()["linear"]["n_obs"] == 0


# ---------------------------------------------------------------------------
# replicas and ingest while serving
# ---------------------------------------------------------------------------

def _replica(engine, verify):
    """Another engine over ``engine``'s store, on the same route."""
    enc = engine.encoder
    if verify == "host":
        return MatchEngine(enc, engine.store, verify="host", batch_size=32,
                           device="cpu")
    return make_engine_service(enc, None, make_mesh(1, "cpu"),
                               store=engine.store, batch_size=32,
                               verify="device")


@pytest.mark.parametrize("verify", ["host", "device"])
def test_replicated_session_exact_and_failover(verify):
    k = 3
    X = season_dataset(54, T, L, 0.7, per_series_strength=True, seed=11)
    Q, D = X[:6], X[6:]
    engine = ENGINES[verify]("ssax", D)
    replica = _replica(engine, verify)
    enc = engine.encoder
    with pytest.raises(ValueError):
        MatchSession(engine, replicas=[MatchEngine(
            enc, SymbolicStore.from_rows(enc, D[:8], device="cpu"),
            verify="host", device="cpu")])
    reg = MetricsRegistry()
    sess = MatchSession(engine, replicas=[replica], metrics=reg,
                        window_s=0.005, max_batch=4)
    sess.start()
    oracle = engine.topk(Q, k=k, source="index")
    reqs = [sess.submit(q, k=k, tier="index") for q in Q]
    for i, r in enumerate(reqs):
        assert r.wait(120) and r.ok, r.error
        assert r.replica in (0, 1)
        assert np.array_equal(r.indices, oracle.indices[i])
        assert np.array_equal(r.distances, oracle.distances[i])
    sess.kill_replica(1)
    assert sess.queue.live_replicas() == [0]
    reqs2 = [sess.submit(q, k=k, tier="index") for q in Q]
    for i, r in enumerate(reqs2):
        assert r.wait(120) and r.ok, r.error
        assert r.replica == 0
        assert np.array_equal(r.indices, oracle.indices[i])
    sess.close()
    snap = reg.snapshot()["counters"]
    assert snap.get("serve.rejected", 0) == 0
    assert snap.get("serve.replica_killed") == 1
    assert sess.snapshot()["live_replicas"] == [0]


def test_queue_requeues_batch_on_replica_failure():
    reg = MetricsRegistry()
    served_on = []

    def dispatch(batch, rid):
        if rid == 0:
            raise RuntimeError("replica 0 crashed")
        for r in batch:
            served_on.append(rid)
            r.done.set()

    q = CoalescingQueue(dispatch, n_replicas=2, metrics=reg,
                        window_s=0.0, max_batch=4,
                        place=lambda live, depths: 0 if 0 in live
                        else live[0])
    reqs = [MatchRequest(query=np.zeros(4, np.float32)) for _ in range(3)]
    for r in reqs:
        q.submit(r)
    q.start()
    for r in reqs:
        assert r.wait(30)
        assert r.error is None, r.error
        assert r.requeues == 1
    q.close()
    assert served_on and all(rid == 1 for rid in served_on)
    snap = reg.snapshot()["counters"]
    assert snap.get("serve.requeued") == 3
    assert snap.get("serve.rejected", 0) == 0


@pytest.mark.parametrize("verify", ["host", "device"])
def test_threaded_ingest_while_serving_stress(verify):
    """A writer appends while two reader threads are served (through two
    replicas on the device route): every answer equals a store frozen at
    its admission epoch, and the shed accounting stays exact."""
    k, n0, n_chunks, chunk = 3, 40, 6, 5
    X = season_dataset(n0 + n_chunks * chunk + 4, T, L, 0.7,
                       per_series_strength=True, seed=11)
    Q, D = X[:4], X[4:]
    engine = ENGINES[verify]("ssax", D[:n0])
    replicas = [_replica(engine, verify)] if verify == "device" else []
    reg = MetricsRegistry()
    sess = MatchSession(engine, replicas=replicas, metrics=reg,
                        window_s=0.001, max_batch=16, max_queue=512)
    sess.start()
    stop = threading.Event()
    served, lock = [], threading.Lock()

    def writer():
        for c in range(n_chunks):
            lo = n0 + c * chunk
            if verify == "host":
                engine.store.append(D[lo:lo + chunk])
            else:
                engine.ingest(D[lo:lo + chunk])
            time.sleep(0.002)
        stop.set()

    def reader(tier):
        while not stop.is_set():
            reqs = [sess.submit(q, k=k, tier=tier) for q in Q]
            for r in reqs:
                assert r.wait(120)
                if r.ok:
                    with lock:
                        served.append(r)

    wt = threading.Thread(target=writer)
    rts = [threading.Thread(target=reader, args=(t,))
           for t in ("index", "linear")]
    wt.start()
    for t in rts:
        t.start()
    wt.join()
    for t in rts:
        t.join()
    sess.close()

    assert served, "the stress loop served nothing"
    oracles = {}
    n_final = n0 + n_chunks * chunk
    qkey = {q.tobytes(): i for i, q in enumerate(Q)}
    for r in served:
        n_e = r.epoch.n_rows
        assert n0 <= n_e <= n_final
        src = "index" if r.tier_served == "index" else None
        if (n_e, src) not in oracles:
            frozen = ENGINES[verify]("ssax", D[:n_e])
            oracles[(n_e, src)] = frozen.topk(Q, k=k, source=src)
        want = oracles[(n_e, src)]
        qi = qkey[r.query.tobytes()]
        assert np.array_equal(r.indices, want.indices[qi]), \
            (n_e, r.tier_served)
        assert np.array_equal(r.distances, want.distances[qi])
    snap = reg.snapshot()["counters"]
    sheds = sum(v for n, v in snap.items() if n.startswith("serve.shed."))
    assert sheds == snap.get("serve.rejected", 0)


# ---------------------------------------------------------------------------
# the self-join tier
# ---------------------------------------------------------------------------

def test_service_selfjoin_tier():
    """Motif / discord requests are served from the shared exact profile
    at the dispatch-time epoch; bad kinds shed with a reason."""
    from repro_torch.profile import (SelfJoinEngine, topk_discords,
                                     topk_motifs)
    from repro_torch.subseq import SubseqEngine, WindowView
    D = season_dataset(5, 300, L, 0.6, per_series_strength=True, seed=13)
    view = WindowView(_enc("ssax", 60), D, stride=6, media="ssd",
                      device="cpu")
    sub = SubseqEngine(view, verify="host", batch_size=64)
    reg = MetricsRegistry()
    sj = SelfJoinEngine(view, verify="host", batch_size=64, metrics=reg)
    oracle = sj.scan_profile()
    sess = MatchSession(sub, selfjoin=sj, metrics=reg, window_s=0.05,
                        max_batch=4)
    r_m = sess.submit_selfjoin("motifs", k=2)
    r_d = sess.submit_selfjoin("discords", k=2)
    r_bad = sess.submit_selfjoin("profiles", k=1)
    r_k = sess.submit_selfjoin("motifs", k=0)
    sess.start()
    assert r_m.wait(300) and r_m.ok, r_m.error
    assert r_d.wait(300) and r_d.ok, r_d.error
    assert r_bad.wait(300) and not r_bad.ok and r_bad.error
    assert r_k.wait(300) and r_k.shed_reason == "bad_query"
    sess.close()
    assert r_m.tier_served == r_d.tier_served == "selfjoin"
    assert r_m.result == topk_motifs(oracle, view.locate, 2)
    assert r_d.result == topk_discords(oracle, view.locate, 2)
    assert r_m.epoch.n_rows == view.n
    assert reg.snapshot()["counters"].get("selfjoin.queries", 0) > 0
    plain = MatchSession(sub)
    r = plain.submit_selfjoin("motifs")
    assert r.shed_reason == "bad_query" and "not configured" in r.error
    with pytest.raises(ValueError, match="WindowView"):
        other = WindowView(_enc("ssax", 60), D, stride=6, device="cpu")
        MatchSession(sub, selfjoin=SelfJoinEngine(other))


# ---------------------------------------------------------------------------
# the launcher and the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("argv", [[], ["--replicas", "2",
                                       "--ingest-while-serving"]])
def test_serve_launcher_dryrun_on_cpu(argv):
    """``python -m repro_torch.launch.serve_match --dryrun --device
    cpu`` exits 0 with its bit-identity line (replicas and ingest while
    serving too)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve_match",
         "--dryrun", "--device", "cpu", *argv], env=env, cwd=ROOT,
        capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "exact-tier bit-identity vs direct topk: 16/16" in out.stdout
    assert "wave 1: 16/16 served" in out.stdout
    if argv:
        assert "answers pinned across" in out.stdout
        assert "replica placement" in out.stdout


@pytest.mark.parametrize("verify", ["host", "device"])
def test_serve_waves_holds_answers_to_the_pinned_oracle(verify):
    """``launch.serve_match.serve_waves`` (the waves the launcher and
    the card smoke share): with a writer ingesting beside wave 1 every
    request is served and every exact answer equals the oracle at its
    pin, so no problem is reported; held against an engine over other
    rows, the same answers are reported as mismatches."""
    from repro_torch.launch.serve_match import report, serve_waves
    Q, D = _data(n=96, n_q=8, seed=13)
    extra = _data(n=24, n_q=0, seed=14)[1]
    engine = ENGINES[verify]("ssax", D)

    def writer(stop):
        for lo in range(0, len(extra), 8):
            engine.ingest(extra[lo:lo + 8]) if verify == "device" else \
                engine.store.append(extra[lo:lo + 8])

    sess = MatchSession(engine, metrics=MetricsRegistry(), window_s=0.002,
                        max_batch=4).start()
    run = serve_waves(sess, engine, Q, clients=4, requests=2, k=3,
                      deadline_s=0.005, writer=writer, timeout=60.0)
    assert run.problems == [] and run.mismatches == 0
    assert run.exact_n >= len(Q) and all(r.ok for r in run.wave1)
    assert len(run.wave2) == 4 and engine.store.n == len(D) + len(extra)
    lines = report(run)
    assert f"exact-tier bit-identity vs direct topk: {run.exact_n}/" \
        f"{run.exact_n}" in lines[2]
    other = ENGINES[verify]("ssax", _data(n=120, n_q=0, seed=15)[1])
    bad = serve_waves(sess, other, Q, clients=4, requests=2, k=3,
                      deadline_s=0.005, timeout=60.0)
    sess.close()
    assert bad.mismatches > 0
    assert any("differ from engine.topk" in p for p in bad.problems)


@pytest.mark.parametrize("tech", TECHS)
def test_session_on_card_bitwise_and_batch_neutral(tech):
    """On the card: a request alone equals it in coalesced batches of
    every power-of-two bucket to 16, on the device route, and K1
    launches equal the dispatches' rounds."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels run only there")
    from repro_torch.kernels import KERNELS
    from repro_torch.kernels.ops import make_pairwise
    Q, D = _data(n=512, n_q=16, seed=8)
    enc = _enc(tech)
    engine = make_engine_service(enc, D, make_mesh(4), verify="device",
                                 pairwise=make_pairwise(enc))
    solo = [engine.topk(q[None], k=4) for q in Q]
    rounds = []
    inner = engine.topk

    def counted(*a, **kw):
        res = inner(*a, **kw)
        rounds.append(res.rounds)
        return res
    engine.topk = counted
    k1 = KERNELS["euclid"]
    before = k1.launches
    for n_sub in (1, 2, 4, 8, 16):
        sess = MatchSession(engine, window_s=0.05, max_batch=16)
        for i, r in enumerate(_served(sess, Q[:n_sub], k=4,
                                      tier="linear")):
            assert np.array_equal(r.indices, solo[i].indices[0])
            assert np.array_equal(r.distances, solo[i].distances[0])
    assert k1.launches - before == sum(rounds)
