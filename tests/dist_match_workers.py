"""Rank functions for ``test_torch_dist_matching.py``: the port's
matching over a ``torch.distributed`` world of ranks on the CPU (gloo),
JAX-free, so the spawned ranks import only torch and the port.

Every case is a function of a mesh that returns plain numpy answers, so
the same function runs on ``make_mesh(S, "cpu")`` (one process, S
virtual shards) and the test holds the world's answers against it
bitwise.  :func:`start` starts one world; in it :func:`run_cases` runs
every case at 1 and 2 shards per rank, and rank 0 pickles the answers
(with every rank's hash of its own answers, the per-rank transfer
counts, and the same cases run in rank 0 alone) into ``out``."""

import hashlib
import os
import pickle
from datetime import timedelta

import numpy as np

T, L, NQ, N = 120, 10, 3, 101          # 101 rows: tails at S = 2, 4, 8
TECHS = ("sax", "ssax", "tsax", "stsax")
TECH_KW = {"sax": {}, "ssax": dict(r2_season=0.7), "tsax": {},
           "stsax": dict(r2_season=0.5)}
WIN = dict(rows=5, T=400, m=120, ks=5)  # rank 3 owns no row at S = 8
WINDOW_CASES = ((1, 0), (1, 60), (3, 0), (3, 60))   # (stride, exclusion)
SPR = (1, 2)                           # shards per rank
BATCH = 16


def enc(tech, t=T):
    from repro_torch.core import make_technique
    return make_technique(tech, T=t, W=t // 20, L=L, **TECH_KW[tech])


def season():
    from repro_torch.data.synthetic import season_dataset
    X = season_dataset(n=NQ + N, T=T, L=L, strength=0.7,
                       per_series_strength=True, seed=11)
    return X[:NQ], X[NQ:]


def windows():
    """(source rows, two snippet queries) of the window cases."""
    from repro_torch.data.synthetic import season_dataset
    X = season_dataset(n=WIN["rows"], T=WIN["T"], L=L, strength=0.7,
                       seed=7)
    rng = np.random.default_rng(0)
    m = WIN["m"]
    Q = np.stack([X[0, 37:37 + m],
                  X[3, 250:250 + m]
                  + 0.1 * rng.normal(size=m).astype(np.float32)])
    return X, Q


def topk_answer(r) -> dict:
    return dict(indices=r.indices, distances=r.distances,
                raw_accesses=r.raw_accesses,
                pruned_fraction=r.pruned_fraction, rounds=r.rounds,
                store_accesses=r.store_accesses,
                store_fetches=r.store_fetches)


def window_answer(r) -> dict:
    return dict(window_ids=r.window_ids, distances=r.distances,
                raw_accesses=r.raw_accesses, rounds=r.rounds,
                pruned_fraction=r.pruned_fraction)


def _pw(e):
    from repro_torch.kernels.ops import make_pairwise
    return make_pairwise(e)


# ---------------------------------------------------------------------------
# the cases: each maps a mesh (and a scratch directory) to numpy answers
# ---------------------------------------------------------------------------

def case_encode(mesh, tmp):
    from repro_torch.core.distributed import encode_sharded, rowwise_sharded
    from repro_torch.index.features import adapter_for
    _, D = season()
    out = {}
    for tech in TECHS:
        e = enc(tech)
        rep = encode_sharded(e, D, mesh)
        leaves = rep if isinstance(rep, tuple) else (rep,)
        out[tech] = [l.numpy() for l in leaves]
        feats = rowwise_sharded(adapter_for(e, "cpu"), "_device_features",
                                D, mesh)
        out[tech + "/features"] = [np.asarray(f) for f in
                                   (feats if isinstance(feats, (tuple, list))
                                    else (feats,))]
    return out


def case_repr_topk(mesh, tmp):
    import torch
    from repro_torch.core.distributed import (make_matching_service,
                                              repr_distances_sharded,
                                              repr_topk_sharded)
    Q, D = season()
    e = enc("ssax")
    rep, query = make_matching_service(e, D, mesh, k=16)
    rq = e.encode(torch.as_tensor(Q))
    d, i = repr_topk_sharded(e, rq, rep, mesh, k=16)
    d2, i2 = query(Q)
    return dict(d=d.numpy(), i=i.numpy(), d2=d2.numpy(), i2=i2.numpy(),
                full=repr_distances_sharded(e, rq, rep, mesh).numpy())


def _service(e, mesh, store, verify, **kw):
    from repro_torch.core.distributed import make_engine_service
    return make_engine_service(e, None, mesh, store=store, verify=verify,
                               batch_size=BATCH, pairwise=_pw(e), **kw)


def case_exact(mesh, tmp):
    """Exact and approximate top-k for every encoder and both
    verification routes, with the transfer counters."""
    from repro_torch.obs import MetricsRegistry
    from repro_torch.store import SymbolicStore
    Q, D = season()
    out = {}
    for tech in TECHS:
        e = enc(tech)
        store = SymbolicStore.from_rows(e, D, device="cpu")
        for verify in ("device", "host"):
            eng = _service(e, mesh, store, verify,
                           metrics=MetricsRegistry())
            key = f"{tech}/{verify}"
            out[key] = topk_answer(eng.topk(Q, k=5))
            out[key + "/k1"] = topk_answer(eng.topk(Q, k=1))
            out[key + "/approx"] = topk_answer(eng.topk(Q, k=5,
                                                        exact=False))
            c = eng.metrics.snapshot()["counters"]
            out[key + "/transfers"] = dict(
                h2d=eng.sweep.h2d_bytes,
                tail_h2d=eng.sweep.tail_h2d_bytes,
                host_order=c.get("match.host_order_bytes"),
                rows_to_host=c.get("match.rows_to_host"),
                head=eng.sweep._head)
    return out


def case_ingest(mesh, tmp):
    """Ingest while serving from a store of 3 rows (fewer than S at 4 and
    8 shards: whole ranks own no row), with tails shorter than S, an
    epoch pinned before the last ingest, and the appended queries found
    by exact and approximate top-k."""
    from repro_torch.core.distributed import make_engine_service
    from repro_torch.store import SymbolicStore
    Q, D = season()
    e = enc("ssax")
    out = {}
    for verify in ("device", "host"):
        eng = make_engine_service(e, D[:3], mesh, verify=verify,
                                  batch_size=BATCH, pairwise=_pw(e))
        calls = []
        orig = eng.sweep._encode_chunk
        eng.sweep._encode_chunk = \
            lambda rows: (calls.append(rows.shape[0]), orig(rows))[1]
        ans = [topk_answer(eng.topk(Q, k=5))]
        eng.ingest(D[3:40])                  # 37 rows
        ans.append(topk_answer(eng.topk(Q, k=5)))
        pin = eng.store.current_epoch()
        eng.ingest(D[40:])                   # 61 rows
        ans.append(topk_answer(eng.topk(Q, k=5)))
        ans.append(topk_answer(eng.topk(Q, k=5, epoch=pin)))
        ans.append(topk_answer(eng.topk(Q, k=5, exact=False)))
        ids = eng.ingest(Q)
        ans.append(topk_answer(eng.topk(Q, k=1)))
        ans.append(topk_answer(eng.topk(Q, k=4, exact=False)))
        frozen = _service(e, mesh, SymbolicStore.from_rows(
            e, D[:40], device="cpu"), verify)
        out[verify] = dict(answers=ans, ids=ids, encoded=list(calls),
                           pinned=ans[3],
                           frozen=topk_answer(frozen.topk(Q, k=5)),
                           rep=[np.asarray(l) for l in eng.store.rep_view()],
                           h2d=eng.sweep.h2d_bytes, n=eng.store.n)
    return out


def case_snapshot(mesh, tmp):
    """A store saved in contiguous row ranges (two hosts) reopens into
    each rank's round-robin mirrors."""
    import torch.distributed as dist
    from repro_torch.store import SymbolicStore
    Q, D = season()
    e = enc("ssax")
    path = os.path.join(tmp, f"snap-{mesh.world}-{mesh.n_shards}")
    if mesh.rank == 0:
        SymbolicStore.from_rows(e, D, device="cpu").save(path, n_hosts=2)
    if mesh.group is not None:
        dist.barrier(group=mesh.group)
    store = SymbolicStore.open(path, device="cpu")
    eng = _service(e, mesh, store, "device")
    return dict(answer=topk_answer(eng.topk(Q, k=5)),
                h2d=eng.sweep.h2d_bytes)


def case_index(mesh, tmp):
    """The sharded index build (features over the world) and indexed
    exact top-k verified on the devices, for every encoder."""
    from repro_torch.store import SymbolicStore
    Q, D = season()
    out = {}
    for tech in TECHS:
        e = enc(tech)
        store = SymbolicStore.from_rows(e, D, device="cpu")
        eng = _service(e, mesh, store, "device")
        idx = store.build_index(leaf_fill=12, max_bits=4, mesh=mesh)
        out[tech] = dict(
            nodes=idx.n_nodes, leaves=idx.tree.leaf_membership(),
            feats=np.asarray(idx.tree.feats),
            answer=topk_answer(eng.topk(Q, k=5, source="index")),
            approx=topk_answer(eng.topk_approx(Q, k=5)),
            host_order=eng.sweep.host_order_bytes)
    return out


def case_windows(mesh, tmp):
    """Window device verification (strides 1 and 3, exclusion 0 and
    60), an epoch-pinned window query, the window index with exclusion,
    and the transfer counters."""
    from repro_torch.subseq import SubseqEngine, WindowView
    X, Q = windows()
    e = enc("ssax", WIN["m"])
    out = {}
    for stride, excl in WINDOW_CASES:
        view = WindowView(e, X, stride=stride, device="cpu")
        eng = SubseqEngine(view, verify="device", mesh=mesh,
                           pairwise=_pw(e), batch_size=BATCH)
        rows0 = view.accesses
        r = eng.topk(Q, k=WIN["ks"], exclusion=excl, use_index=False)
        out[stride, excl] = dict(
            answer=window_answer(r), rows_to_host=view.accesses - rows0,
            host_order=eng._sweep.host_order_bytes)
    view = WindowView(e, X[:4], stride=3, device="cpu")
    eng = SubseqEngine(view, verify="device", mesh=mesh, pairwise=_pw(e),
                       batch_size=BATCH)
    pin = view.current_epoch()
    view.append(X[4:])
    out["pinned"] = window_answer(eng.topk(Q, k=WIN["ks"], epoch=pin))
    view.build_index(leaf_fill=16)
    out["indexed"] = window_answer(eng.topk(Q, k=3, exclusion=60))
    out["indexed/linear"] = window_answer(eng.topk(Q, k=3, exclusion=60,
                                                   use_index=False))
    return out


def case_selfjoin(mesh, tmp):
    """The self-join profile on the device stream route (trivial zone
    masked on each rank), verified on the devices, and its brute-force
    oracle."""
    from repro_torch.profile import SelfJoinEngine
    from repro_torch.subseq import WindowView
    X, _ = windows()
    e = enc("ssax", WIN["m"])
    view = WindowView(e, X[:3, :300], stride=4, device="cpu")
    out = {}
    for verify in ("device", "host"):
        sj = SelfJoinEngine(view, verify=verify, mesh=mesh, pairwise=_pw(e),
                            batch_size=BATCH)
        p = sj.profile()
        out[verify] = dict(distances=p.distances, neighbors=p.neighbors,
                           raw_accesses=p.raw_accesses, rounds=p.rounds,
                           source=p.source)
    p = sj.scan_profile()
    out["scan"] = dict(distances=p.distances, neighbors=p.neighbors)
    return out


def tied_bounds(seed: int = 0):
    """(4, 300) bounds rounded to a few values (many ties), with +inf
    stretches, an all-inf row and zeros."""
    rng = np.random.default_rng(seed)
    b = (rng.integers(0, 4, size=(4, 300)) / 2.0).astype(np.float32)
    b[0, rng.random(300) < 0.3] = np.inf
    b[1] = np.inf
    b[2, :40] = 0.0
    return b


def case_merge(mesh, tmp):
    """The world stream's merge on heavily tied bounds: each rank
    streams its own ids (round-robin over the shards), drained in
    batches of 7; the order must be numpy's stable argsort."""
    import torch
    from repro_torch.core.distributed import (WorldOrderedStream,
                                              _order_stream)
    b = tied_bounds()
    S, n = mesh.n_shards, b.shape[1]
    ids = np.array([i for i in range(n) if i % S in mesh.shards], np.int64)
    stream = (WorldOrderedStream.from_bounds(
        torch.as_tensor(b[:, ids]), torch.as_tensor(ids), mesh, n)
        if mesh.group is not None
        else _order_stream(torch.as_tensor(b), width=n))
    got = [[] for _ in range(b.shape[0])]
    while True:
        nxt = stream.peek()
        aq = np.nonzero(np.isfinite(nxt))[0]
        if not aq.size:
            break
        taken = stream.take(aq, 7)
        for r, qi in enumerate(aq):
            got[qi].extend(int(i) for i in taken[r] if i >= 0)
    return dict(order=got, n_finite=stream.n_finite)


def _refused(fn) -> str:
    try:
        fn()
        return "accepted"
    except (ValueError, RuntimeError) as err:
        return f"refused: {err}"


def case_service(mesh, tmp):
    """The service refuses a raw engine over a world of ranks (a world
    serves through ``service.world.WorldChannel``'s fronts); a world
    mesh refuses a CUDA device on a gloo group and a shard count that
    does not split over the ranks."""
    import torch.distributed as dist
    from repro_torch.core.distributed import make_mesh
    from repro_torch.service import MatchSession
    from repro_torch.store import SymbolicStore
    _, D = season()
    e = enc("ssax")
    eng = _service(e, mesh, SymbolicStore.from_rows(e, D[:20], device="cpu"),
                   "device")
    out = {"service": _refused(lambda: MatchSession(eng).close())}
    if mesh.group is not None:
        out["cuda_on_gloo"] = _refused(lambda: make_mesh(
            mesh.n_shards, "cuda", group=mesh.group))
        out["not_a_multiple"] = _refused(lambda: make_mesh(
            mesh.world + 1, "cpu", group=dist.group.WORLD))
    return out


CASES = {f.__name__[5:]: f for f in (
    case_encode, case_repr_topk, case_exact, case_ingest, case_snapshot,
    case_index, case_windows, case_selfjoin, case_merge, case_service)}


def answer_hash(obj) -> str:
    """sha256 of an answer tree (arrays by dtype, shape and bytes)."""
    h = hashlib.sha256()

    def walk(o):
        if isinstance(o, dict):
            for k in sorted(o, key=repr):
                h.update(repr(k).encode())
                walk(o[k])
        elif isinstance(o, (list, tuple)):
            for x in o:
                walk(x)
        elif isinstance(o, np.ndarray):
            h.update(str((o.dtype, o.shape)).encode())
            h.update(np.ascontiguousarray(o).tobytes())
        else:
            h.update(repr(o).encode())
    walk(obj)
    return h.hexdigest()


# ---------------------------------------------------------------------------
# the world
# ---------------------------------------------------------------------------

def start(world: int, out: str):
    """Start :func:`run_cases` on ``world`` gloo ranks that join through a
    file under ``out``, each with one intra-op thread; a collective that
    waits longer than 60 s fails the run instead of hanging it.  Returns
    the ranks' ``ProcessContext``: ``while not ctx.join(): pass`` waits
    for them and raises if one failed."""
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
    """Every case at each shard count per rank over the world; rank 0
    then runs each case again in this process alone on ``make_mesh(S,
    "cpu")`` (no group, no collective) and pickles both."""
    import torch.distributed as dist
    from repro_torch.core.distributed import make_mesh
    res = {}
    for spr in SPR:
        mesh = make_mesh(world * spr, "cpu", group=dist.group.WORLD)
        for name, fn in CASES.items():
            res[spr, name] = fn(mesh, out)
    # per-rank counts, and every rank's hash of its own answers
    every = [None] * world
    dist.all_gather_object(every, (answer_hash(_shared(res)),
                                   _rank_counts(res)))
    if rank == 0:
        single = {(spr, name): fn(make_mesh(world * spr, "cpu"), out)
                  for spr in SPR for name, fn in CASES.items()}
        with open(os.path.join(out, f"world-{world}.pkl"), "wb") as f:
            pickle.dump({"answers": res, "ranks": every, "single": single},
                        f)


def _rank_counts(res) -> dict:
    """What differs between ranks by design: each rank's uploads."""
    out = {}
    for (spr, name), r in res.items():
        if name == "exact":
            for k, v in r.items():
                if k.endswith("/transfers"):
                    out[spr, k] = (v["h2d"], v["tail_h2d"])
        elif name == "ingest":
            for k, v in r.items():
                out[spr, "ingest/" + k] = v["h2d"]
        elif name == "snapshot":
            out[spr, "snapshot"] = r["h2d"]
    return out


def _shared(res):
    """The answers without the per-rank counts (equal on every rank)."""
    out = {}
    for key, r in res.items():
        if key[1] == "exact":
            r = {k: ({kk: vv for kk, vv in v.items()
                      if kk not in ("h2d", "tail_h2d")}
                     if k.endswith("/transfers") else v)
                 for k, v in r.items()}
        elif key[1] == "ingest":
            r = {k: {kk: vv for kk, vv in v.items() if kk != "h2d"}
                 for k, v in r.items()}
        elif key[1] == "snapshot":
            r = r["answer"]
        out[key] = r
    return out
