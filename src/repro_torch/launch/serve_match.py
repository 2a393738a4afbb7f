"""Always-on matching service launcher.

    PYTHONPATH=src python -m repro_torch.launch.serve_match \
        --n 40000 --technique ssax --clients 32 --k 8 --window-ms 2

Builds the sharded engine service (``core.distributed.
make_engine_service`` on ``make_mesh(1, --device)``) with its split-tree
index, wraps it in a :class:`repro_torch.service.MatchSession` — the
coalescing queue front-end plus the telemetry-driven query planner — and
drives it with ``--clients`` concurrent threads submitting single-query
requests.  The run shows the service contract end to end:

* coalescing: waiting requests batch into one (Q, T) engine dispatch;
  the run reports requests per dispatch, QPS and latency quantiles.
* exactness: every planner-routed exact answer is checked bitwise
  against a direct ``engine.topk`` oracle at the request's pinned
  epoch; the run exits nonzero on any mismatch.
* deadlines: a second wave runs under a tight per-request budget —
  deadline-threatened requests downgrade to the anytime tier and come
  back with an error bar instead of being shed.
* ``--explain`` renders the plan trace of the first request and
  validates it (the device invariants too under ``--verify device``).
* ``--spans PATH`` keeps the session's last 65,536 program spans
  (``MatchSession(span_log=)``: submit, queue wait, the dispatcher's
  coalescing time, each dispatch's engine sweep, rounds and blocking
  copies) and writes them to PATH as Chrome trace events on
  the clock ``torch.profiler`` stamps host events with.
* ``--replicas N`` serves through N engine replicas over the ONE
  shared store (per-replica dispatch workers, planner-EWMA placement);
  each replica keeps its own device mirrors.  ``--ingest-while-serving``
  runs a writer thread appending rows throughout wave 1; every request
  is pinned to its admission-time corpus epoch, so exactness holds
  mid-ingest.

Runs on the CUDA card by default (``--device cuda``: the K4 encode, the
K2 / K3 sweep, K1 verification) and raises without one; ``--device
cpu`` runs every kernel's plain version.  ``--dryrun`` shrinks
everything to a seconds-scale smoke.  The last line hashes wave 1's
answers (``[answers] sha256 ...``).

Started under ``torch.distributed.run`` (``WORLD_SIZE`` > 1, or with
``--distributed``) each rank joins the process group as
``launch/match.py`` does (NCCL on ``cuda:LOCAL_RANK``, gloo on the CPU)
and builds the corpus, the engine, its index and the replicas over
``make_mesh(R * --shards-per-rank, device, group=WORLD)``.  Rank 0 serves
through the fronts of a ``service.world.WorldChannel`` and prints; the
other ranks replay its engine calls in order.  At the end every rank's
hash of its calls' results is held against rank 0's, and any rank that
differs exits nonzero:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.serve_match --device cpu \
        --dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import json
import threading
import time
from dataclasses import dataclass

import numpy as np

#: Spans the ``--spans`` log keeps (the last ones, of every thread).
SPAN_LOG = 65536


def _percentile(xs, q):
    return float(np.percentile(np.asarray(xs, np.float64), q)) if len(xs) \
        else float("nan")


@dataclass
class ServeRun:
    """What :func:`serve_waves` resolved and checked."""
    wave1: list              # one MatchRequest per client request
    wall1_s: float           # wave 1's wall time, first submit to last answer
    counters1: dict          # the session's metric counters after wave 1
    wave2: list              # the deadline wave's MatchRequests
    deadline_s: float        # wave 2's budget per request
    exact_n: int             # exact-tier answers held against the oracle
    mismatches: int          # of those, answers that differ from it
    oracle_s: float          # the oracle's wall time
    problems: list           # every broken promise, as text (empty: none)


def serve_waves(session, engine, Q, *, clients: int, requests: int,
                k: int, deadline_s: float, writer=None, gate=None,
                explain: bool = False, timeout: float = 120.0) -> ServeRun:
    """Drive a started ``session`` over ``engine`` with both waves and
    hold the answers to the service contract.

    Wave 1: ``clients`` threads each submit ``requests`` single-query
    requests (client ``c``'s j-th is ``Q[c * requests + j]``) at ``k``;
    ``writer(stop)``, when given, runs on its own thread from just
    before the clients start until they are done (``stop`` is set then,
    and the thread joined); ``gate(i)``, when given, is called by the
    client just before it submits request ``i`` (to pace requests behind
    the writer).  Wave 2: the first ``clients`` queries at a
    ``deadline_s`` budget each.  Every wave-1 request must be served;
    every exact-tier answer (both waves) must equal ``engine.topk(...,
    epoch=)`` at the request's pinned epoch bitwise (one oracle call per
    (tier, pin) group; a batch answers each query as alone); every
    wave-2 downgrade carries an error bar and every wave-2 shed is
    ``deadline_expired``."""
    n_q = clients * requests
    results = [None] * n_q

    def client(cid):
        for j in range(requests):
            i = cid * requests + j
            if gate is not None:
                gate(i)
            req = session.submit(Q[i], k=k, explain=explain and i == 0)
            req.wait(timeout)
            results[i] = req

    stop = threading.Event()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(clients)]
    wt = threading.Thread(target=writer, args=(stop,)) if writer else None
    t0 = time.perf_counter()
    if wt is not None:
        wt.start()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    wall = time.perf_counter() - t0
    if wt is not None:
        stop.set()
        wt.join()
    counters1 = (session.metrics.snapshot()["counters"]
                 if session.metrics is not None else {})
    problems = []
    bad = [r for r in results if r is None or not r.ok]
    if bad:                          # shed or failed: never counted served
        r = bad[0]
        problems.append(f"wave 1: {len(bad)} of {n_q} requests not served, "
                        f"e.g. {getattr(r, 'shed_reason', None)}: "
                        f"{getattr(r, 'error', 'no answer')}")

    wave2 = session.serve(Q[:clients], k=k, deadline_s=deadline_s,
                          timeout=timeout)
    down = [r for r in wave2 if r.ok and r.plan is not None
            and r.plan.downgraded]
    if any(r.error_bar is None or r.error_bar < 0 for r in down):
        problems.append("wave 2: a downgraded answer carries no error bar")
    sheds = [r.shed_reason for r in wave2 if not r.ok]
    if any(s != "deadline_expired" for s in sheds):
        problems.append(f"wave 2: sheds for {sheds}")

    # the oracle answers at each request's PINNED epoch: with a writer
    # the live corpus has moved on, and bit-identity is defined against
    # the admission frontier
    groups = {}
    for r in [r for r in results if r is not None] + wave2:
        if r.ok and r.tier_served != "approx":
            key = (r.tier_served, r.epoch.n_rows, r.k)
            groups.setdefault(key, []).append(r)
    t0 = time.perf_counter()
    mism = 0
    for (tier, _, kk), reqs in groups.items():
        want = engine.topk(np.stack([r.query for r in reqs]), k=kk,
                           source="index" if tier == "index" else None,
                           epoch=reqs[0].epoch)
        mism += sum(not (np.array_equal(r.indices, want.indices[i])
                         and np.array_equal(r.distances, want.distances[i]))
                    for i, r in enumerate(reqs))
    exact_n = sum(len(v) for v in groups.values())
    if mism:
        problems.append(f"{mism} of {exact_n} exact-tier answers differ "
                        f"from engine.topk(epoch=pin)")
    return ServeRun(results, wall, counters1, wave2, deadline_s, exact_n, mism,
                    time.perf_counter() - t0, problems)


def report(run: ServeRun) -> list:
    """The run's report lines: wave 1 (served, QPS, latency quantiles,
    requests per dispatch from the ``serve.*`` counters, tiers, epochs,
    replica placement), the oracle, wave 2."""
    ok = [r for r in run.wave1 if r is not None and r.ok]
    lat = [r.latency_s for r in ok]
    snap = run.counters1
    batches = snap.get("serve.batches", 0)
    batched = snap.get("serve.batched_requests", 0)
    tiers, by_rep = {}, {}
    for r in ok:
        tiers[r.tier_served] = tiers.get(r.tier_served, 0) + 1
        by_rep[r.replica] = by_rep.get(r.replica, 0) + 1
    epochs = sorted({r.epoch.n_rows for r in ok if r.epoch is not None})
    n_q = len(run.wave1)
    lines = [
        f"wave 1: {len(ok)}/{n_q} served in {run.wall1_s:.3f}s "
        f"({len(ok) / max(run.wall1_s, 1e-9):.1f} QPS); p50 "
        f"{_percentile(lat, 50) * 1e3:.1f}ms p99 "
        f"{_percentile(lat, 99) * 1e3:.1f}ms; "
        f"{batched / max(batches, 1):.2f} requests/dispatch "
        f"({batches:g} dispatches); tiers {tiers}",
        f"answers pinned across {len(epochs)} epochs "
        f"({epochs[0] if epochs else 0}..{epochs[-1] if epochs else 0} "
        f"rows); replica placement: {by_rep}",
        f"exact-tier bit-identity vs direct topk: "
        f"{run.exact_n - run.mismatches}/{run.exact_n} (oracle "
        f"{run.oracle_s:.2f}s)"]
    served = [r for r in run.wave2 if r.ok]
    down = [r for r in served if r.plan is not None and r.plan.downgraded]
    bars = [r.error_bar for r in served if r.error_bar is not None]
    lines.append(
        f"wave 2 (deadline {run.deadline_s * 1e3:.1f}ms): "
        f"{len(served)}/{len(run.wave2)} served, {len(down)} "
        f"downgraded to approx, {len(run.wave2) - len(served)} shed; "
        f"error bar mean {np.mean(bars) if bars else 0.0:.4f} "
        f"({sum(1 for b in bars if b == 0)}/{len(bars)} provably exact)")
    return lines


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--T", type=int, default=960)
    ap.add_argument("--L", type=int, default=10)
    ap.add_argument("--strength", type=float, default=0.7)
    ap.add_argument("--technique", default="ssax",
                    choices=["sax", "ssax", "tsax", "stsax"])
    ap.add_argument("--k", type=int, default=8)
    ap.add_argument("--clients", type=int, default=32,
                    help="concurrent client threads")
    ap.add_argument("--requests", type=int, default=4,
                    help="requests per client per wave")
    ap.add_argument("--window-ms", type=float, default=2.0,
                    help="coalescing window")
    ap.add_argument("--max-batch", type=int, default=64)
    ap.add_argument("--deadline-ms", type=float, default=5.0,
                    help="per-request budget for the deadline wave")
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--store", default="ssd",
                    choices=["hdd", "ssd", "hbm"])
    ap.add_argument("--verify", default="auto",
                    choices=["auto", "numpy", "kernel", "host", "device"])
    ap.add_argument("--leaf-fill", type=int, default=64)
    ap.add_argument("--spans", default=None, metavar="PATH",
                    help="write the session's program spans to PATH as "
                    "Chrome trace events")
    ap.add_argument("--explain", action="store_true",
                    help="render + validate one dispatch trace")
    ap.add_argument("--replicas", type=int, default=1,
                    help="engine replicas over the shared store")
    ap.add_argument("--ingest-while-serving", action="store_true",
                    help="append rows concurrently with wave 1; "
                         "answers stay exact at their pinned epochs")
    ap.add_argument("--device", default="cuda",
                    help="where encode, sweep and verification run")
    ap.add_argument("--dryrun", action="store_true",
                    help="seconds-scale smoke")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torch.distributed world even at one "
                    "rank (implied by WORLD_SIZE > 1)")
    ap.add_argument("--shards-per-rank", type=int, default=1,
                    help="shards of the mesh on each rank")
    args = ap.parse_args(argv)

    if args.dryrun:
        args.n = min(args.n, 256)
        args.T = min(args.T, 480)
        args.clients = min(args.clients, 8)
        args.requests = min(args.requests, 2)
        args.k = min(args.k, 4)
        args.batch = min(args.batch, 64)
        args.leaf_fill = min(args.leaf_fill, 16)

    import torch.distributed as dist
    from repro_torch.launch.match import join_world, world_mesh
    from repro_torch.service.world import WorldChannel

    group, device = join_world(args)
    try:
        follower = group is not None and dist.get_rank(group) > 0
        # the followers build the same engines silently and replay
        with (contextlib.redirect_stdout(io.StringIO()) if follower
              else contextlib.nullcontext()):
            engines, data = build(args, world_mesh(args, group, device))
        if group is None:
            print(f"[answers] sha256 {serve(args, engines, *data)}")
        elif follower:
            WorldChannel(engines, group).follow()
        else:
            lead(args, WorldChannel(engines, group), data)
    finally:
        if group is not None:
            dist.destroy_process_group()


def lead(args, channel, data):
    """Rank 0 of a world: serve through the channel's fronts, close it,
    and hold every rank's op hash and epochs against this rank's."""
    from repro_torch.service.world import ranks_agree
    try:
        digest = serve(args, channel.fronts, *data)
    finally:
        every = channel.close()
    s = channel.stats
    print(f"[world] {len(every)} ranks: {s['ops']} ops, {s['keepalives']} "
          f"keep-alives, {s['errors']} errors; broadcast "
          f"{s['broadcast_s']:.3f}s for {s['bytes']} bytes; queue wait "
          f"{s['wait_s']:.3f}s; "
          + "; ".join(f"{m}: {v['ops']} ops, broadcast "
                      f"{v['broadcast_s']:.3f}s" for m, v in
                      s["by_method"].items()))
    same = ranks_agree(every)
    print(f"[answers] sha256 {digest}; {len(every)} ranks: op hashes and "
          f"epochs equal on every rank {'yes' if same else 'NO'}")
    if not same:
        raise SystemExit("[world] a rank's results differ from rank 0's")


def build(args, mesh):
    """The engine over ``mesh`` with its index and the replicas (every
    rank builds them alike), and (queries, ingest rows)."""
    from repro_torch.core.distributed import make_engine_service
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.launch.match import launcher_technique
    from repro_torch.obs import REGISTRY

    n = args.n
    n_q = args.clients * args.requests
    n_ingest = max(n // 8, 1) if args.ingest_while_serving else 0
    X = season_corpus(n + n_q + n_ingest, args.T, args.L, args.strength,
                      per_series_strength=True, seed=11)
    Q, D = X[:n_q], X[n_q:n_q + n]
    tech = launcher_technique(args.technique, args.T, args.L, args.strength)

    print(f"[serve] {args.technique} over {n} x {args.T} on "
          f"{mesh.device} ({mesh.n_shards} shards over {mesh.world} "
          f"rank(s); verify={args.verify})")
    t0 = time.perf_counter()
    engine = make_engine_service(tech, D, mesh, batch_size=args.batch,
                                 media=args.store, verify=args.verify,
                                 pairwise=make_pairwise(tech),
                                 metrics=REGISTRY)
    engine.store.build_index(leaf_fill=args.leaf_fill)
    # replicas share the ONE store (dataset=None adopts it); each keeps
    # its own device mirrors, synced independently by store epoch
    replicas = [make_engine_service(tech, None, mesh, store=engine.store,
                                    batch_size=args.batch,
                                    media=args.store, verify=args.verify,
                                    pairwise=make_pairwise(tech))
                for _ in range(max(args.replicas, 1) - 1)]
    print(f"[serve] engine + index ready in "
          f"{time.perf_counter() - t0:.2f}s"
          + (f" ({args.replicas} replicas)" if replicas else ""))
    return [engine, *replicas], (Q, X[n_q + n:])


def serve(args, engines, Q, D_ingest) -> str:
    """Serve both waves through a ``MatchSession`` over ``engines`` (the
    primary, then its replicas), print the report and return wave 1's
    answer hash."""
    from repro_torch.launch.match import _explain, _print_metrics
    from repro_torch.obs import REGISTRY
    from repro_torch.service import MatchSession

    engine, n_q = engines[0], len(Q)
    session = MatchSession(engine, replicas=engines[1:], metrics=REGISTRY,
                           window_s=args.window_ms * 1e-3,
                           max_batch=args.max_batch,
                           max_queue=max(4 * n_q, 256),
                           span_log=SPAN_LOG if args.spans else 0).start()
    cal = session.calibrate(Q[:1], k=args.k)
    print("[serve] planner calibration: "
          + ", ".join(f"{t} {e['wall_s'] * 1e3:.1f}ms" for t, e in
                      cal.items()))

    # -- wave 1: concurrent exact serving, then the deadline wave ---------
    # (with --ingest-while-serving a writer appends rows throughout wave
    # 1; requests stay exact at their admission-pinned corpus epochs)
    def writer(stop):
        chunk = max(1, len(D_ingest) // 16)
        for lo in range(0, len(D_ingest), chunk):
            if stop.is_set():
                break
            engine.ingest(D_ingest[lo:lo + chunk])
            time.sleep(0.001)

    run = serve_waves(session, engine, Q, clients=args.clients,
                      requests=args.requests, k=args.k,
                      deadline_s=args.deadline_ms * 1e-3,
                      writer=writer if args.ingest_while_serving else None,
                      explain=args.explain)
    for line in report(run):
        print(f"[serve] {line}")
    if args.ingest_while_serving:
        print(f"[serve] ingested to {engine.store.n} rows during wave 1")
    if run.problems:
        session.close()
        raise SystemExit("[serve] " + "; ".join(run.problems))
    first = run.wave1[0]
    if args.explain and first.trace is not None:
        _explain(first.trace, device=args.verify == "device")

    session.close()
    if args.spans:
        with open(args.spans, "w") as f:
            json.dump(session.span_log.to_chrome(), f)
        print(f"[serve] {len(session.spans())} spans -> {args.spans}")
    _print_metrics(REGISTRY)
    print("[serve] planner estimates: "
          + ", ".join(f"{t} {e['wall_s'] * 1e3:.1f}ms (n={e['n_obs']})"
                      for t, e in session.planner.snapshot().items()))
    h = hashlib.sha256()
    for r in run.wave1:
        for a in (r.indices, r.distances):
            h.update(str((a.dtype, a.shape)).encode())
            h.update(np.ascontiguousarray(a).tobytes())
    return h.hexdigest()[:16]


if __name__ == "__main__":
    main()
