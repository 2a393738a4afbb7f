"""Rank functions for ``test_torch_dist_service.py``: the port's matching
service over a ``torch.distributed`` world of ranks on the CPU (gloo),
JAX-free, so the spawned ranks import only torch and the port.

Every case is a function of a mesh that builds its engines alike on
every rank and serves them through :func:`serving`: over a world, rank 0
runs the case's body on the fronts of a ``service.world.WorldChannel``
while the other ranks replay its engine calls; without a group (the
single process at the same S) the body runs on the engines themselves.
So rank 0 of a world can run every case again alone on ``make_mesh(S,
"cpu")``, and the test holds the two bitwise.  Each case returns the
body's plain numpy answers, every rank's channel summary (op hash,
ops, errors, epoch ledger) and the leader's channel counters."""

import os
import pickle
import threading
import time
from datetime import timedelta

from dist_match_workers import BATCH, TECHS, enc, season, windows

K = 5
N_NEUTRAL = 16
BUCKETS = (1, 2, 4, 8, 16)
IDLE = dict(timeout_s=4.0, keepalive_s=0.25, sleep_s=5.0)


def queries(n=N_NEUTRAL, seed=21):
    """``n`` more queries of the season corpus's shape."""
    from dist_match_workers import L, T
    from repro_torch.data.synthetic import season_dataset
    return season_dataset(n, T, L, 0.7, per_series_strength=True, seed=seed)


def answer(r) -> dict:
    """A served request as plain values."""
    out = dict(ok=r.ok, tier=r.tier_served, shed=r.shed_reason,
               epoch=None if r.epoch is None else int(r.epoch.n_rows))
    if r.ok and r.indices is not None:
        out.update(indices=r.indices, distances=r.distances)
        for name in ("rows", "starts"):
            if getattr(r, name) is not None:
                out[name] = getattr(r, name)
        if r.error_bar is not None:
            out.update(kth_lb=r.kth_lb, error_bar=r.error_bar)
    if r.result is not None:
        out["result"] = r.result
    if r.error is not None:
        out["error"] = r.error
    return out


def topk_answer(res) -> dict:
    ids = getattr(res, "window_ids", None)
    return dict(indices=res.indices if ids is None else ids,
                distances=res.distances)


def serving(mesh, engines, body, **channel_kw):
    """``(answers, summaries, stats)``: ``body(engines)`` on rank 0 over
    the fronts of a ``WorldChannel`` of ``engines`` (the other ranks
    follow; their answers are None), or on ``engines`` themselves
    without a group (summaries and stats None)."""
    from repro_torch.service import WorldChannel
    if mesh.group is None:
        return body(engines), None, None
    chan = WorldChannel(engines, mesh.group, **channel_kw)
    if mesh.rank:
        return None, chan.follow(), None
    try:
        out = body(chan.fronts)
    finally:
        every = chan.close()
    return out, every, {k: v for k, v in chan.stats.items()
                        if k != "by_method"}


def _service(e, mesh, store, verify, **kw):
    from repro_torch.core.distributed import make_engine_service
    from repro_torch.kernels.ops import make_pairwise
    return make_engine_service(e, None, mesh, store=store, verify=verify,
                               batch_size=BATCH, pairwise=make_pairwise(e),
                               **kw)


def _store(tech, rows):
    from repro_torch.store import SymbolicStore
    return SymbolicStore.from_rows(enc(tech), rows, device="cpu")


def _build_index(engine, **kw):
    """Build the index through the channel on a front; on the engine's
    store or view in a single process."""
    fn = getattr(engine, "build_index", None)
    if fn is None:
        fn = getattr(engine, "view", None) or engine.store
        fn = fn.build_index
    return fn(**kw)


def _session(engine, **kw):
    from repro_torch.obs import MetricsRegistry
    from repro_torch.service import MatchSession
    return MatchSession(engine, metrics=MetricsRegistry(), **kw)


def _clients(sess, jobs, n_threads=3):
    """Submit ``jobs`` ((query, kwargs) pairs) from ``n_threads``
    threads, job j on thread j % n_threads; returns the resolved
    requests in job order."""
    out = [None] * len(jobs)

    def client(c):
        for j in range(c, len(jobs), n_threads):
            q, kw = jobs[j]
            r = sess.submit(q, **kw)
            r.wait(120)
            out[j] = r
    ts = [threading.Thread(target=client, args=(c,))
          for c in range(n_threads)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(120)
    return out


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def case_exact(mesh):
    """Exact tiers "index" and "linear" for all four encoders, verify on
    the devices and on the host, from three client threads; the index is
    built through the channel; the direct oracle beside."""
    Q, D = season()
    engines = [_service(enc(t), mesh, _store(t, D), v)
               for t in TECHS for v in ("device", "host")]

    def body(fronts):
        out = {}
        for i, front in enumerate(fronts):
            key = f"{TECHS[i // 2]}/{('device', 'host')[i % 2]}"
            _build_index(front, leaf_fill=12, max_bits=4)
            sess = _session(front, window_s=0.01, max_batch=8).start()
            jobs = [(q, dict(k=K, tier=tier)) for tier in ("index", "linear")
                    for q in Q for _ in range(2)]
            out[key] = [answer(r) for r in _clients(sess, jobs)]
            sess.close()
            out[key + "/oracle"] = {
                tier: topk_answer(front.topk(Q, k=K, source=src))
                for tier, src in (("index", "index"), ("linear", None))}
        return out
    return serving(mesh, engines, body)


def case_neutral(mesh):
    """Batch neutrality: 16 queries coalesced 1, 2, 4, 8 and 16 at a
    time (each bucket one dispatch) on the device route."""
    _, D = season()
    Q = queries()

    def body(fronts):
        out = {}
        for b in BUCKETS:
            sess = _session(fronts[0], window_s=0.05, max_batch=b,
                            max_queue=N_NEUTRAL)
            reqs = [sess.submit(q, k=K, tier="linear") for q in Q]
            sess.start()
            for r in reqs:
                r.wait(120)
            sess.close()
            out[b] = [answer(r) for r in reqs]
            out[b, "batches"] = sess.metrics.snapshot()["counters"][
                "serve.batches"]
        return out
    return serving(mesh, [_service(enc("ssax"), mesh, _store("ssax", D),
                                   "device")], body)


def _subseq_engine(mesh, view):
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.subseq import SubseqEngine
    return SubseqEngine(view, verify="device", mesh=mesh, batch_size=BATCH,
                        pairwise=make_pairwise(view.encoder))


def case_subseq(mesh):
    """The subsequence session's exact tiers over the window index
    (built through the channel) and the linear window sweep."""
    from repro_torch.subseq import WindowView
    X, Q = windows()
    view = WindowView(enc("ssax", 120), X, stride=3, device="cpu")

    def body(fronts):
        _build_index(fronts[0], leaf_fill=16)
        sess = _session(fronts[0], window_s=0.01, max_batch=4).start()
        jobs = [(q, dict(k=3, tier=tier)) for tier in ("index", "linear")
                for q in Q]
        out = {"served": [answer(r) for r in _clients(sess, jobs, 2)]}
        sess.close()
        out["oracle"] = {
            tier: topk_answer(fronts[0].topk(Q, k=3,
                                             use_index=tier == "index"))
            for tier in ("index", "linear")}
        return out
    return serving(mesh, [_subseq_engine(mesh, view)], body)


def case_selfjoin(mesh):
    """The self-join tier: motifs and discords from the device stream
    profile, and the profile itself through the channel."""
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.profile import SelfJoinEngine
    from repro_torch.subseq import WindowView
    X, _ = windows()
    view = WindowView(enc("ssax", 120), X[:3, :300], stride=4, device="cpu")
    sj = SelfJoinEngine(view, verify="device", mesh=mesh, batch_size=BATCH,
                        pairwise=make_pairwise(view.encoder))

    def body(fronts):
        sess = _session(fronts[0], selfjoin=fronts[1], window_s=0.01)
        reqs = [sess.submit_selfjoin(kind, k=2)
                for kind in ("motifs", "discords")]
        sess.start()
        for r in reqs:
            r.wait(120)
        sess.close()
        prof = fronts[1].profile()
        return {"served": [answer(r) for r in reqs],
                "profile": dict(distances=prof.distances,
                                neighbors=prof.neighbors,
                                exclusion=prof.exclusion)}
    return serving(mesh, [_subseq_engine(mesh, view), sj], body)


def case_replicas(mesh):
    """Two replicas over one store, then replica 1 killed: nothing shed,
    every answer the oracle's."""
    _, D = season()
    Q = queries(6, seed=22)
    store = _store("ssax", D)
    store.build_index(leaf_fill=12, max_bits=4)
    engines = [_service(enc("ssax"), mesh, store, "device")
               for _ in range(2)]

    def body(fronts):
        sess = _session(fronts[0], replicas=fronts[1:], window_s=0.005,
                        max_batch=4).start()
        first = _clients(sess, [(q, dict(k=K, tier="index")) for q in Q], 2)
        moved = sess.kill_replica(1)
        second = _clients(sess, [(q, dict(k=K, tier="index")) for q in Q], 2)
        sess.close()
        return {"first": [answer(r) for r in first],
                "second": [answer(r) for r in second],
                "replicas": [[r.replica for r in first],
                             [r.replica for r in second]],
                "moved": moved, "live": sess.queue.live_replicas(),
                "counters": sess.metrics.snapshot()["counters"],
                "oracle": topk_answer(fronts[0].topk(Q, k=K,
                                                     source="index"))}
    return serving(mesh, engines, body)


def case_ingest(mesh):
    """A writer ingests 61 rows in 4 chunks through the channel while two
    client threads are served (tiers "index" and "linear", replicas 2);
    every answer is held to a store frozen at its pin by the test."""
    Q, D = season()
    store = _store("ssax", D[:40])
    store.build_index(leaf_fill=12, max_bits=4)
    engines = [_service(enc("ssax"), mesh, store, "device")
               for _ in range(2)]

    def body(fronts):
        sess = _session(fronts[0], replicas=fronts[1:], window_s=0.002,
                        max_batch=8, max_queue=512).start()
        served, stop = [], threading.Event()

        def writer():
            for lo in range(40, len(D), 16):
                fronts[0].ingest(D[lo:lo + 16])
                time.sleep(0.005)
            stop.set()

        def reader(tier):
            while not stop.is_set():
                reqs = [sess.submit(q, k=K, tier=tier) for q in Q]
                for r in reqs:
                    r.wait(120)
                served.extend((tier, qi, answer(r))
                              for qi, r in enumerate(reqs))
        ts = [threading.Thread(target=writer)] + [
            threading.Thread(target=reader, args=(t,))
            for t in ("index", "linear")]
        for t in ts:
            t.start()
        for t in ts:
            t.join(120)
        sess.close()
        return {"served": served, "n": fronts[0].store.n,
                "index_n": fronts[0].store.index.n}
    return serving(mesh, engines, body)


def case_deadline(mesh):
    """The deadline wave: the planner believes the exact tiers take 10 s,
    so 5 s budgets downgrade to the anytime tier; a 0.1 ms budget expires
    in the queue.  The single process's ``topk_approx`` of the same
    bucketed batch at the same pin and collect is taken beside."""
    from repro_torch.service import MatchSession
    Q, D = season()
    store = _store("stsax", D)
    store.build_index(leaf_fill=12, max_bits=4)

    def body(fronts):
        sess = _session(fronts[0], window_s=0.0, max_batch=8)
        sess.calibrate(Q[:1], k=K)
        sess.planner._est["index"].wall_s = 10.0
        sess.planner._est["linear"].wall_s = 10.0
        reqs = [sess.submit(q, k=K, deadline_s=5.0) for q in Q]
        reqs.append(sess.submit(Q[0], k=K, deadline_s=1e-4))
        time.sleep(0.01)
        sess.start()
        for r in reqs:
            r.wait(120)
        sess.close()
        pin = reqs[0].epoch
        direct = fronts[0].topk_approx(MatchSession._bucket(Q), k=K,
                                       epoch=pin)
        return {"served": [answer(r) for r in reqs],
                "downgraded": [r.plan is not None and r.plan.downgraded
                               for r in reqs],
                "direct": dict(topk_answer(direct), kth_lb=direct.kth_lb,
                               error_bar=direct.error_bar),
                "exact": topk_answer(fronts[0].topk(Q, k=K))}
    return serving(mesh, [_service(enc("stsax"), mesh, store, "device")],
                   body)


class Flaky:
    """An engine whose ``fail_at``-th ``topk`` raises — on every rank
    alike, since every rank makes the same calls."""

    def __init__(self, engine, fail_at: int):
        self._engine, self._fail_at, self._calls = engine, fail_at, 0

    def __getattr__(self, name):
        return getattr(self.__dict__["_engine"], name)

    def topk(self, *a, **kw):
        self._calls += 1
        if self._calls == self._fail_at:
            raise RuntimeError("injected engine failure")
        return self._engine.topk(*a, **kw)


def case_error(mesh):
    """An engine that raises at one op on every rank: that request is
    resolved with the error, and the next op is exact."""
    Q, D = season()
    engine = Flaky(_service(enc("ssax"), mesh, _store("ssax", D), "device"),
                   fail_at=1)

    def body(fronts):
        sess = _session(fronts[0], window_s=0.0, max_batch=4).start()
        bad = sess.submit(Q[0], k=K, tier="linear")
        bad.wait(120)
        good = sess.submit(Q[1], k=K, tier="linear")
        good.wait(120)
        sess.close()
        return {"bad": answer(bad), "good": answer(good),
                "oracle": topk_answer(fronts[0].topk(Q[1:2], k=K))}
    return serving(mesh, [engine], body)


def case_idle(mesh):
    """The leader idles past the channel group's timeout between two
    requests: its keep-alives keep the followers waiting, and the
    second request is served exactly."""
    Q, D = season()

    def body(fronts):
        sess = _session(fronts[0], window_s=0.0, max_batch=4).start()
        first = sess.serve(Q[:1], k=K, tier="linear")
        time.sleep(IDLE["sleep_s"])
        second = sess.serve(Q[1:2], k=K, tier="linear")
        sess.close()
        return {"served": [answer(r) for r in first + second]}
    return serving(mesh, [_service(enc("ssax"), mesh, _store("ssax", D),
                                   "device")], body,
                   timeout_s=IDLE["timeout_s"],
                   keepalive_s=IDLE["keepalive_s"])


class Skewed:
    """An engine whose answers carry every distance plus one: a rank that
    computes differently from rank 0."""

    def __init__(self, engine):
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self.__dict__["_engine"], name)

    def topk(self, *a, **kw):
        res = self._engine.topk(*a, **kw)
        res.distances = res.distances + 1
        return res


def case_mismatch(mesh):
    """The last rank's engine answers differently: its ``follow()``
    raises at close, and rank 0 sees its hash differ."""
    Q, D = season()
    engine = _service(enc("ssax"), mesh, _store("ssax", D), "host")
    if mesh.group is not None and mesh.rank == mesh.world - 1:
        engine = Skewed(engine)

    def body(fronts):
        return {"answer": topk_answer(fronts[0].topk(Q, k=K))}
    try:
        return serving(mesh, [engine], body)
    except RuntimeError as err:
        return {"raised": str(err)}, None, None


def case_refused(mesh):
    """A raw engine over a world mesh is refused by the session."""
    _, D = season()
    eng = _service(enc("ssax"), mesh, _store("ssax", D[:20]), "device")
    try:
        _session(eng).close()
        return "accepted", None, None
    except ValueError as err:
        return f"refused: {err}", None, None


CASES = {f.__name__[5:]: f for f in (
    case_exact, case_neutral, case_subseq, case_selfjoin, case_replicas,
    case_ingest, case_deadline, case_error, case_idle, case_mismatch,
    case_refused)}
#: cases whose answers depend on the world's timing, so the single
#: process is not run for them (the test holds them to frozen oracles)
WORLD_ONLY = ("ingest", "idle", "mismatch", "refused")


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def start(world: int, out: str):
    """Start :func:`run_cases` on ``world`` gloo ranks that join through a
    file under ``out``, each with one intra-op thread; a collective of
    the world group that waits longer than 60 s fails the run instead of
    hanging it.  Returns the ranks' ``ProcessContext``."""
    import torch.multiprocessing as mp
    init = "file://" + os.path.join(out, f"init-{world}")
    return mp.spawn(_rank, args=(world, init, out), nprocs=world,
                    join=False)


def _rank(rank, world, init, out):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world, timeout=timedelta(seconds=60))
    try:
        run_cases(rank, world, out)
    finally:
        dist.destroy_process_group()


def run_cases(rank, world, out):
    """Every case over the world at S = R; rank 0 then runs the cases
    that do not depend on timing again alone on ``make_mesh(S, "cpu")``
    and pickles both."""
    import torch.distributed as dist
    from repro_torch.core.distributed import make_mesh
    mesh = make_mesh(world, "cpu", group=dist.group.WORLD)
    res = {name: fn(mesh) for name, fn in CASES.items()}
    if rank == 0:
        single = {name: fn(make_mesh(world, "cpu"))[0]
                  for name, fn in CASES.items() if name not in WORLD_ONLY}
        with open(os.path.join(out, f"world-{world}.pkl"), "wb") as f:
            pickle.dump({"world": res, "single": single}, f)
