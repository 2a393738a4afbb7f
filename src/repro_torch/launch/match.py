"""Matching launcher: encode a synthetic season corpus with SAX, sSAX,
tSAX or stSAX and serve batched exact and approximate top-k through the
port's sharded engine service (``core.distributed.make_engine_service``
over ``make_mesh(1)``), checked against a brute force.

    PYTHONPATH=src python -m repro_torch.launch.match \
        --n 40000 --strength 0.7 --technique ssax --queries 8 --k 32

Runs on the CUDA card by default (``--device cuda``): the encode goes
through the K4 PAA kernel, the SAX / sSAX sweep over the round-robin
device mirrors through the K3 / K2 kernels (``kernels.ops.make_pairwise``
on the ``pairwise=`` hook), the candidate order is sorted on the card,
and verification goes through the K1 euclid kernel (``--verify auto``).
``--verify device`` mirrors the raw rows on the card too and verifies
there, moving no raw row to the host; ``--verify host`` is its bitwise
twin (store fetch, then K1).  Both apply to ``--subseq``.
``--device cpu`` runs every kernel's plain version instead; without a
card the default raises rather than falling back.  The brute force each
exact answer is checked against is K1 over the whole corpus, so the
engine's exact top-k must equal it bitwise.

The corpus lives in a ``SymbolicStore``.  ``--index`` builds its
split-tree index and serves indexed exact top-k beside the linear sweep
(bitwise equal); ``--explain`` prints each call's per-query plan and
fails if a required span is missing; ``--ingest N --ingest-rows R``
appends N chunks through ``MatchEngine.append`` while serving (the index
is maintained, not rebuilt); ``--snapshot-dir`` saves the store, index
included, at the end:

    PYTHONPATH=src python -m repro_torch.launch.match \
        --n 20000 --index --explain --ingest 2 --snapshot-dir /tmp/snaps

``--subseq`` switches to subsequence matching: the corpus rows become
long series, every z-normalized window of length ``--window`` at
``--stride`` is encoded (``subseq.WindowView``), and snippet queries are
localized anywhere in the corpus through the pruned windowed scan
(``subseq.SubseqEngine``), checked against a K1 brute force over every
window and compared with the brute-force distance profile of the K5
windowed kernel (``SubseqEngine.scan_topk``).  With ``--index`` it
builds the split-tree window index (``WindowView.build_index``) and
serves indexed exact top-k, checked bitwise against the linear window
sweep; ``--explain`` prints each call's plan and the ``subseq.*``
metrics:

    PYTHONPATH=src python -m repro_torch.launch.match \
        --subseq --n 2048 --T 3600 --window 240 --stride 4 --k 8 \
        --index --explain

``--selfjoin`` computes the exact matrix profile of the same kind of
corpus (``profile.SelfJoinEngine``: every window's nearest non-trivial
neighbour), with a planted motif pair and discord, prints the top-k
motifs and discords and checks the profile bitwise against the brute
force ``scan_profile`` (K1 over every window pair); ``--verify device``
orders and verifies the candidates on ``make_mesh(1, --device)``:

    PYTHONPATH=src python -m repro_torch.launch.match \
        --selfjoin --n 16 --T 3600 --window 240 --stride 4 --k 3

Started under ``torch.distributed.run`` (``WORLD_SIZE`` > 1, or with
``--distributed``) each rank joins the process group — NCCL for
``--device cuda``, on the rank's own card ``cuda:LOCAL_RANK``, gloo for
``--device cpu`` — and the whole-series, ``--subseq`` and ``--selfjoin``
paths run over ``make_mesh(R * --shards-per-rank, device,
group=WORLD)``: each rank holds its own shards, and the collectives
merge the candidate order and the verification.  Rank 0 prints; every
rank hashes its answers and exits nonzero unless they equal rank 0's:

    PYTHONPATH=src python -m torch.distributed.run --standalone \
        --nproc-per-node 2 -m repro_torch.launch.match --device cpu --dryrun
"""

from __future__ import annotations

import argparse
import contextlib
import hashlib
import io
import os
import sys
import time

import numpy as np
import torch

#: the answers this process gave, hashed (held against rank 0's)
_ANSWERS = hashlib.sha256()


def _note(*arrays) -> None:
    """Add answer arrays to the hash the ranks compare."""
    for a in arrays:
        a = np.ascontiguousarray(a)
        _ANSWERS.update(str((a.dtype, a.shape)).encode())
        _ANSWERS.update(a.tobytes())


def _note_topk(res) -> None:
    _note(res.indices, res.distances, res.raw_accesses,
          np.asarray([res.rounds]))


def join_world(args):
    """(group, device): the process group and this rank's device when
    started under ``torch.distributed.run`` (``WORLD_SIZE`` > 1) or with
    ``--distributed`` — NCCL on ``cuda:LOCAL_RANK`` (set as the current
    device before anything is allocated there) or gloo on the CPU —
    else (None, the device)."""
    import torch.distributed as dist
    from repro_torch.core.engine import resolve_device
    dev = torch.device(args.device)
    if not (args.distributed or int(os.environ.get("WORLD_SIZE", 1)) > 1):
        return None, resolve_device(dev)
    if dev.type == "cuda":
        dev = resolve_device(torch.device(
            "cuda", int(os.environ.get("LOCAL_RANK", 0))))
        torch.cuda.set_device(dev)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    return dist.group.WORLD, dev


def world_mesh(args, group, device):
    """``make_mesh(R * --shards-per-rank, device, group)``."""
    from repro_torch.core.distributed import make_mesh
    import torch.distributed as dist
    world = 1 if group is None else dist.get_world_size(group)
    return make_mesh(world * args.shards_per_rank, device, group=group)


def check_world(group) -> None:
    """Print the answers' hash (rank 0); over a world, hold every rank's
    hash against rank 0's: any rank whose answers differ exits
    nonzero."""
    import torch.distributed as dist
    mine = _ANSWERS.hexdigest()
    if group is None:
        print(f"[answers] sha256 {mine[:16]}")
        return
    every = [None] * dist.get_world_size(group)
    dist.all_gather_object(every, mine, group=group)
    if dist.get_rank(group) == 0:
        same = all(h == mine for h in every)
        print(f"[answers] sha256 {mine[:16]}; {len(every)} ranks: equal on "
              f"every rank {'yes' if same else 'NO'}")
    if mine != every[0]:
        raise SystemExit(f"[world] rank {dist.get_rank(group)}: answers "
                         f"differ from rank 0's")


def launcher_technique(technique: str, T: int, L: int, strength: float):
    """The launcher's encoder: ``make_technique`` with W = 48."""
    from repro_torch.core.techniques import make_technique
    return make_technique(technique, T=T, W=48, L=L, r2_season=strength)


def make_engine(technique: str, D: np.ndarray, *, L: int = 10,
                strength: float = 0.7, batch: int = 256,
                store: str = "ssd", verify: str = "auto", rep=None,
                metrics=None, device="cuda", mesh=None):
    """The sharded engine service (``core.distributed.
    make_engine_service`` over ``mesh``, by default ``make_mesh(1,
    device)``) on a ``SymbolicStore`` holding ``D`` — encoded shard by
    shard unless ``rep``, the representation of ``D``, is given — with
    the launcher's encoder and the kernel sweep for SAX / sSAX.  Exact
    top-k orders its candidates on the device; the engine can ``ingest``
    / ``append``, and its store can build an index and be saved."""
    from repro_torch.core.distributed import make_engine_service, make_mesh
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.store import SymbolicStore
    tech = launcher_technique(technique, D.shape[1], L, strength)
    mesh = mesh if mesh is not None else make_mesh(1, device)
    sym = SymbolicStore(tech, media=store, device=mesh.device)
    if rep is not None:
        sym.append(D, rep=rep)
    return make_engine_service(tech, None if rep is not None else D, mesh,
                               store=sym, batch_size=batch, verify=verify,
                               pairwise=make_pairwise(tech),
                               metrics=metrics)


def _explain(trace, *, device: bool = False):
    """Print the per-query plan and fail on a broken trace (a missing
    required span, no verification round).  ``device=True`` also holds
    the device route's transfer invariants: ``host_order_bytes == 0``
    (the order stayed on the device) and ``rows_to_host == 0``."""
    from repro_torch.obs import check_trace, render_trace
    print(render_trace(trace))
    problems = check_trace(trace, device=device)
    if problems:
        raise SystemExit("[explain] trace check FAILED: "
                         + "; ".join(problems))


def _print_metrics(registry):
    """One-screen registry summary (counters + latency quantiles)."""
    snap = registry.snapshot()
    if snap["counters"]:
        kv = ", ".join(f"{k}={v:g}" for k, v in
                       sorted(snap["counters"].items()))
        print(f"[metrics] {kv}")
    for name in sorted(snap["histograms"]):
        hist = registry.histogram(name)
        if hist.count:
            print(f"[metrics] {name}: n={hist.count} "
                  f"p50<={hist.quantile(0.5):.3g}s "
                  f"p99<={hist.quantile(0.99):.3g}s")


BRUTEFORCE_ROWS = 1 << 18      # rows uploaded per brute-force step


def kernel_bruteforce(Q: np.ndarray, D: np.ndarray, k: int, device):
    """Exact top-k by K1 over every row of ``D`` (its plain version on a
    CPU device): (Q, k) ids and f32 distances, ties by smaller id.  K1's
    per-(query, row) reduction order is fixed, so this equals any exact
    engine answer that verifies through K1, bit for bit."""
    from repro_torch.kernels.ops import euclid_batch
    dev = torch.device(device)
    q = torch.as_tensor(np.asarray(Q, np.float32)).to(dev)
    d2 = np.empty((Q.shape[0], D.shape[0]), np.float32)
    for lo in range(0, D.shape[0], BRUTEFORCE_ROWS):
        hi = lo + BRUTEFORCE_ROWS
        x = torch.as_tensor(D[lo:hi]).to(dev)
        d2[:, lo:hi] = euclid_batch(x, q).cpu().numpy()
    dist = np.sqrt(np.maximum(d2, 0.0))
    idx = np.argsort(dist, axis=1, kind="stable")[:, :k]
    return idx.astype(np.int64), np.take_along_axis(dist, idx, axis=1)


def window_distances(data: np.ndarray, m: int, stride: int,
                     zq: np.ndarray, device) -> np.ndarray:
    """(Q, n_windows) f32 distances from z-normalized queries ``zq`` to
    every window of ``data`` (window ids row-major, as ``WindowView``
    numbers them), by K1 (its plain version on a CPU device).  The
    windows are z-normalized by ``znorm_windows`` a few rows at a time;
    a window's bits do not depend on its batch, and K1's per-(query,
    row) reduction order is fixed, so these equal the distances the
    engine verifies, bit for bit."""
    from repro_torch.kernels.ops import euclid_batch
    from repro_torch.kernels.windowed_euclid import n_windows
    from repro_torch.subseq.windows import znorm_windows
    dev = torch.device(device)
    nw = n_windows(data.shape[1], m, stride)
    step = max(1, BRUTEFORCE_ROWS // nw)
    q = torch.as_tensor(np.asarray(zq, np.float32)).to(dev)
    d2 = np.empty((zq.shape[0], data.shape[0] * nw), np.float32)
    for lo in range(0, data.shape[0], step):
        w = np.lib.stride_tricks.sliding_window_view(
            data[lo:lo + step], m, axis=1)[:, ::stride].reshape(-1, m)
        x = torch.as_tensor(znorm_windows(w)).to(dev)
        d2[:, lo * nw:lo * nw + x.shape[0]] = euclid_batch(x, q).cpu().numpy()
    return np.sqrt(np.maximum(d2, 0.0))


def greedy_nonoverlap(order: np.ndarray, nw: int, stride: int, k: int,
                      exclusion: int) -> np.ndarray:
    """The first ``k`` window ids of ``order`` (one query's ids, best
    first) that do not overlap an earlier pick: same row and starts
    fewer than ``exclusion`` samples apart.  -1 pads."""
    taken, out = [], np.full(k, -1, np.int64)
    for wid in order:
        r, s = divmod(int(wid), nw)
        if any(tr == r and abs(ts - s * stride) < exclusion
               for tr, ts in taken):
            continue
        out[len(taken)] = wid
        taken.append((r, s * stride))
        if len(taken) == k:
            break
    return out


def subseq_queries(D: np.ndarray, m: int, n_queries: int,
                   rng: np.random.Generator):
    """``n_queries`` snippets of ``m`` samples at random rows and offsets
    of ``D`` plus 0.05 Gaussian noise: (Q, m) f32, their rows, their
    offsets."""
    rows = rng.integers(0, D.shape[0], size=n_queries)
    offs = rng.integers(0, D.shape[1] - m + 1, size=n_queries)
    Q = np.stack([D[r, o:o + m] for r, o in zip(rows, offs)])
    Q = Q + 0.05 * rng.normal(size=Q.shape).astype(np.float32)
    return Q, rows, offs


def make_subseq_engine(technique: str, D: np.ndarray, *, m: int,
                       stride: int, L: int = 10, strength: float = 0.7,
                       batch: int = 256, store: str = "ssd",
                       verify: str = "auto", metrics=None, mesh=None,
                       device="cuda"):
    """A ``WindowView`` of ``D`` (window ``m``, W = m / L) and a
    ``SubseqEngine`` over it with the kernel sweep for SAX / sSAX,
    recording into ``metrics`` when one is given; ``mesh`` (a
    ``core.distributed.ShardMesh``) shards the window sweep and is
    needed for ``verify="device"``."""
    from repro_torch.core.techniques import make_technique
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.subseq import SubseqEngine, WindowView
    tech = make_technique(technique, T=m, W=m // L, L=L,
                          r2_season=strength)
    view = WindowView(tech, D, stride=stride, media=store, device=device)
    return view, SubseqEngine(view, batch_size=batch, verify=verify,
                              pairwise=make_pairwise(tech), metrics=metrics,
                              mesh=mesh)


def run_subseq(args, device, group=None):
    """Subsequence mode: encode every window of an (n, T) long-series
    corpus, localize snippet queries exactly, check them against a K1
    brute force over every window and the K5 brute-force scan; with
    ``--index``, serve from the window index and check it bitwise
    against the linear window sweep."""
    from repro_torch.data.synthetic import season_dataset
    from repro_torch.obs import REGISTRY
    m, s = args.window, args.stride
    if m % args.L:
        raise SystemExit(f"--window {m} must be a multiple of --L {args.L}")
    if m > args.T:
        raise SystemExit(f"--window {m} longer than --T {args.T}")
    mesh = None
    if args.verify == "device" or group is not None:
        mesh = world_mesh(args, group, device)
    if args.verify == "device":
        print(f"[subseq] device-resident verification on {device}")
    # the device route's transfer invariants hold where the order stays
    # on the device: suppression masks a host bound matrix
    gate = args.verify == "device" and args.exclusion <= 0
    rng = np.random.default_rng(7)
    D = season_dataset(args.n, args.T, args.L, args.strength,
                       per_series_strength=True, seed=7)
    Q, q_rows, offs = subseq_queries(D, m, args.queries, rng)

    t0 = time.perf_counter()
    view, engine = make_subseq_engine(
        args.technique, D, m=m, stride=s, L=args.L, strength=args.strength,
        batch=args.batch, store=args.store, verify=args.verify,
        metrics=REGISTRY, mesh=mesh, device=device)
    print(f"[subseq] {args.technique} over {args.n} x {args.T} "
          f"-> {view.n} windows (m={m}, stride={s}) on {device}; "
          f"encode {time.perf_counter() - t0:.2f}s")

    if args.index:
        t0 = time.perf_counter()
        view.build_index(leaf_fill=args.leaf_fill)
        print(f"[subseq] window index: {view.index.n_nodes} nodes over "
              f"{view.index.n} windows (leaf_fill {args.leaf_fill}) in "
              f"{time.perf_counter() - t0:.2f}s")

    view.reset()
    t0 = time.perf_counter()
    res = engine.topk(Q, k=args.k, exclusion=args.exclusion,
                      explain=args.explain)
    dt = time.perf_counter() - t0
    if args.explain:
        _explain(res.trace, device=gate)
    t0 = time.perf_counter()
    scan = engine.scan_topk(Q, k=args.k)
    dt_scan = time.perf_counter() - t0
    _note(res.window_ids, res.distances, res.raw_accesses, scan.window_ids)
    d = window_distances(D, m, s, engine.normalize_queries(Q), device)
    order = np.argsort(d, axis=1, kind="stable")
    nw = view.windows_per_row
    want = np.stack([greedy_nonoverlap(order[qi], nw, s, args.k,
                                       args.exclusion)
                     for qi in range(args.queries)])
    exact = sum(int(np.array_equal(res.window_ids[qi], want[qi]))
                for qi in range(args.queries))
    hits = sum(int(res.window_ids[qi, 0] == scan.window_ids[qi, 0])
               for qi in range(args.queries))
    loc = sum(int(res.rows[qi, 0] == q_rows[qi]
                  and abs(res.starts[qi, 0] - offs[qi]) < m)
              for qi in range(args.queries))
    print(f"[subseq] exact k={args.k}"
          + (f" excl={args.exclusion}" if args.exclusion else "")
          + f": {exact}/{args.queries} query frontiers == brute force; "
          f"top-1 == K5 scan {hits}/{args.queries}, snippet localized "
          f"{loc}/{args.queries}; windows/query "
          f"{res.raw_accesses.mean():.0f} "
          f"({1 - res.pruned_fraction.mean():.2%} of {view.n}); "
          f"rows read {res.store_accesses}/{view.n_rows}; modeled "
          f"{args.store} I/O {res.io_seconds * 1e3:.2f}ms vs scan "
          f"{scan.io_seconds * 1e3:.2f}ms; wall {dt:.2f}s "
          f"(scan {dt_scan:.2f}s)")

    if args.index:
        # cold-cache boundary: the indexed run above left its I/O counts
        # and a warm row buffer behind
        view.reset()
        lin = engine.topk(Q, k=args.k, exclusion=args.exclusion,
                          use_index=False, explain=args.explain)
        if args.explain:
            _explain(lin.trace, device=gate)
        _note(lin.window_ids, lin.distances)
        agree = (np.array_equal(res.window_ids, lin.window_ids)
                 and np.array_equal(res.distances, lin.distances))
        print(f"[subseq] index vs linear sweep: bitwise identical "
              f"{'yes' if agree else 'NO'}; windows examined/query "
              f"{res.raw_accesses.mean():.0f} (indexed) vs "
              f"{lin.raw_accesses.mean():.0f} (linear) of {view.n}")

    # streaming: new long series are searchable immediately (the window
    # index, when built, is maintained by the append)
    extra = season_dataset(2, args.T, args.L, args.strength, seed=8)
    t0 = time.perf_counter()
    view.append(extra)
    print(f"[subseq] append 2 rows (+{2 * nw} windows) in "
          f"{(time.perf_counter() - t0) * 1e3:.0f}ms; corpus "
          f"{view.n_rows} rows / {view.n} windows")
    o2 = min(100, args.T - m)
    res2 = engine.topk(extra[:1, o2:o2 + m], k=1)
    _note(res2.window_ids, res2.distances)
    print(f"[subseq] query of appended row -> row {res2.rows[0, 0]} "
          f"start {res2.starts[0, 0]} d={res2.distances[0, 0]:.4f}")
    if args.explain:
        _print_metrics(REGISTRY)


def run_selfjoin(args, device, group=None):
    """Self-join mode: compute the corpus matrix profile exactly
    (``profile.SelfJoinEngine``), report the top-k motifs and discords,
    and check the profile bitwise against the brute-force
    ``scan_profile`` (K1 over every window pair).  A motif pair and a
    discord are planted into the synthetic corpus so the answer is
    visibly right."""
    from repro_torch.core.techniques import make_technique
    from repro_torch.data.synthetic import season_dataset
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.obs import REGISTRY
    from repro_torch.profile import (SelfJoinEngine, topk_discords,
                                     topk_motifs)
    from repro_torch.subseq import WindowView
    m, s = args.window, args.stride
    if m % args.L:
        raise SystemExit(f"--window {m} must be a multiple of --L {args.L}")
    if m > args.T:
        raise SystemExit(f"--window {m} longer than --T {args.T}")
    tech = make_technique(args.technique, T=m, W=m // args.L, L=args.L,
                          r2_season=args.strength)
    mesh = None
    if args.verify == "device" or group is not None:
        mesh = world_mesh(args, group, device)
    if args.verify == "device":
        print(f"[selfjoin] device-resident verification on {device}")

    rng = np.random.default_rng(17)
    D = np.array(season_dataset(args.n, args.T, args.L, args.strength,
                                per_series_strength=True, seed=17))
    # plant a motif (one snippet duplicated across two rows) and a
    # discord (one burst unlike anything else) to make the self-join's
    # answer checkable by eye
    snippet = np.sin(np.linspace(0, 6 * np.pi, m)).astype(np.float32)
    o = (args.T - m) // 2
    D[0, o:o + m] = snippet + 0.01 * rng.normal(size=m)
    D[1, o:o + m] = snippet + 0.01 * rng.normal(size=m)
    D[2, o:o + m] += 6.0 * np.hanning(m).astype(np.float32)

    t0 = time.perf_counter()
    view = WindowView(tech, D, stride=s, media=args.store, device=device)
    print(f"[selfjoin] {args.technique} over {args.n} x {args.T} "
          f"-> {view.n} windows (m={m}, stride={s}) on {device}; "
          f"encode {time.perf_counter() - t0:.2f}s")
    if args.index:
        view.build_index(leaf_fill=args.leaf_fill)
        print(f"[selfjoin] window index: {view.index.n_nodes} nodes")
    excl = args.exclusion if args.exclusion > 0 else None
    engine = SelfJoinEngine(view, batch_size=args.batch, verify=args.verify,
                            pairwise=make_pairwise(tech), mesh=mesh,
                            exclusion=excl, metrics=REGISTRY)

    view.reset()
    t0 = time.perf_counter()
    prof = engine.profile(explain=args.explain)
    dt = time.perf_counter() - t0
    if args.explain:
        _explain(prof.trace, device=args.verify == "device")
    motifs = topk_motifs(prof, view.locate, args.k)
    discords = topk_discords(prof, view.locate, args.k)

    t0 = time.perf_counter()
    oracle = engine.scan_profile()
    dt_scan = time.perf_counter() - t0
    same = (np.array_equal(prof.distances, oracle.distances)
            and np.array_equal(prof.neighbors, oracle.neighbors))
    _note(prof.distances, prof.neighbors, prof.raw_accesses)
    print(f"[selfjoin] profile over {prof.n} windows "
          f"(exclusion {prof.exclusion} samples, source {prof.source}): "
          f"bitwise == oracle {'yes' if same else 'NO'}; "
          f"windows verified/query {prof.raw_accesses.mean():.0f} "
          f"({1 - prof.pruned_fraction.mean():.2%} of {prof.n}); modeled "
          f"{args.store} I/O {prof.io_seconds * 1e3:.2f}ms vs scan "
          f"{oracle.io_seconds * 1e3:.2f}ms; wall {dt:.2f}s "
          f"(scan {dt_scan:.2f}s)")
    if not same:
        raise SystemExit("[selfjoin] profile diverged from the "
                         "brute-force oracle")
    for i, (a, b, d) in enumerate(motifs):
        ra, sa = view.locate(np.asarray([a]))
        rb, sb = view.locate(np.asarray([b]))
        print(f"[selfjoin] motif {i + 1}: row {ra[0]}@{sa[0]} ~ "
              f"row {rb[0]}@{sb[0]} d={d:.4f}")
    for i, (w, d) in enumerate(discords):
        r, st = view.locate(np.asarray([w]))
        print(f"[selfjoin] discord {i + 1}: row {r[0]}@{st[0]} d={d:.4f}")
    if motifs:
        ra, _ = view.locate(np.asarray([motifs[0][0]]))
        rb, _ = view.locate(np.asarray([motifs[0][1]]))
        planted = {int(ra[0]), int(rb[0])} == {0, 1}
        print(f"[selfjoin] planted motif recovered: "
              f"{'yes' if planted else 'NO'}")
    if discords:
        r, _ = view.locate(np.asarray([discords[0][0]]))
        print(f"[selfjoin] planted discord recovered: "
              f"{'yes' if int(r[0]) == 2 else 'NO'}")
    if args.explain:
        _print_metrics(REGISTRY)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=20_000)
    ap.add_argument("--T", type=int, default=960)
    ap.add_argument("--L", type=int, default=10)
    ap.add_argument("--strength", type=float, default=0.7)
    ap.add_argument("--technique", default="ssax",
                    choices=["sax", "ssax", "tsax", "stsax"])
    ap.add_argument("--queries", type=int, default=8)
    ap.add_argument("--k", type=int, default=32)
    ap.add_argument("--batch", type=int, default=256,
                    help="verification batch per query per round")
    ap.add_argument("--store", default="ssd", choices=["hdd", "ssd", "hbm"])
    ap.add_argument("--verify", default="auto",
                    choices=["auto", "numpy", "kernel", "host", "device"],
                    help="raw verification path: 'auto' is the K1 kernel "
                    "on a card and numpy on the CPU; 'kernel' and 'host' "
                    "always verify through K1; 'device' mirrors the raw "
                    "rows on the device and verifies there through K1, "
                    "moving no raw row to the host (bitwise equal to "
                    "'host')")
    ap.add_argument("--device", default="cuda",
                    help="where encode, sweep and verification run")
    ap.add_argument("--subseq", action="store_true",
                    help="subsequence matching over long series")
    ap.add_argument("--selfjoin", action="store_true",
                    help="matrix-profile self-join: exact per-window "
                    "nearest non-trivial neighbours, top-k motifs and "
                    "discords, checked bitwise against the brute-force "
                    "profile")
    ap.add_argument("--window", type=int, default=240,
                    help="subsequence window length m (encoder T)")
    ap.add_argument("--stride", type=int, default=4,
                    help="window hop in samples")
    ap.add_argument("--exclusion", type=int, default=0,
                    help="non-overlap suppression distance (0: off)")
    ap.add_argument("--ingest", type=int, default=0,
                    help="chunks to append while serving")
    ap.add_argument("--ingest-rows", type=int, default=1024,
                    help="rows per ingest chunk")
    ap.add_argument("--snapshot-dir", default="",
                    help="save the store (raw + rep + index) after the run")
    ap.add_argument("--index", action=argparse.BooleanOptionalAction,
                    default=False,
                    help="build the split-tree index (over the windows "
                    "with --subseq) and serve indexed exact queries beside "
                    "the linear sweep (fewer rows verified; the tree walk "
                    "runs on the host)")
    ap.add_argument("--leaf-fill", type=int, default=64,
                    help="index leaf fill factor (split threshold)")
    ap.add_argument("--explain", action="store_true",
                    help="print a per-query plan (spans, candidates, "
                    "pruning, I/O, rounds) for every exact call and fail "
                    "if a required span is missing")
    ap.add_argument("--dryrun", action="store_true",
                    help="shrink every dimension to a seconds-scale smoke")
    ap.add_argument("--distributed", action="store_true",
                    help="join the torch.distributed world even at one "
                    "rank (implied by WORLD_SIZE > 1)")
    ap.add_argument("--shards-per-rank", type=int, default=1,
                    help="shards of the mesh on each rank")
    args = ap.parse_args(argv)

    windowed = args.subseq or args.selfjoin
    if args.dryrun:
        args.n = min(args.n, 12 if windowed else 256)
        args.T = min(args.T, 480)
        args.queries = min(args.queries, 4)
        args.k = min(args.k, 8)
        args.batch = min(args.batch, 64)
        args.ingest = min(args.ingest, 1)
        if windowed:
            args.window = min(args.window, 240)
            args.stride = max(args.stride, 8)

    if windowed and (args.ingest or args.snapshot_dir):
        raise SystemExit("--ingest and --snapshot-dir serve "
                         "whole-series matching only")
    group, device = join_world(args)
    rank = 0 if group is None else torch.distributed.get_rank(group)
    if args.explain:                 # the metrics printed are this run's
        from repro_torch.obs import REGISTRY
        REGISTRY.reset()
    global _ANSWERS
    _ANSWERS = hashlib.sha256()
    try:
        # rank 0 prints; the other ranks run the same calls silently
        with (contextlib.redirect_stdout(io.StringIO()) if rank
              else contextlib.nullcontext()):
            if args.selfjoin:
                args.k = min(args.k, 4)   # motif / discord count
                run_selfjoin(args, device, group)
            elif args.subseq:
                run_subseq(args, device, group)
            else:
                run_match(args, device, group)
        check_world(group)
    finally:
        if group is not None:
            torch.distributed.destroy_process_group()
    sys.stdout.flush()


def run_match(args, device, group=None):
    """Whole-series mode: exact, indexed and approximate top-k over the
    corpus, ingest while serving, and the snapshot."""
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.obs import REGISTRY
    n_ingest = args.ingest * args.ingest_rows
    X = season_corpus(args.n + args.queries + n_ingest, args.T, args.L,
                      args.strength, per_series_strength=True, seed=1)
    Q, D = X[:args.queries], X[args.queries:args.queries + args.n]
    ingest_pool = X[args.queries + args.n:]

    print(f"[match] {args.technique} over {args.n} x {args.T} on {device} "
          f"(verify={args.verify})")
    t0 = time.perf_counter()
    engine = make_engine(
        args.technique, D, L=args.L, strength=args.strength,
        batch=args.batch, store=args.store, verify=args.verify,
        metrics=REGISTRY if args.explain else None, device=device,
        mesh=world_mesh(args, group, device))
    store = engine.store                 # SymbolicStore: raw + live rep
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[match] encode: {time.perf_counter() - t0:.2f}s")

    true_i, true_d = kernel_bruteforce(Q, D, max(1, args.k), device)

    # exact top-k through the pruned batched scan
    for k in (1, args.k):
        store.reset()
        t0 = time.perf_counter()
        res = engine.topk(Q, k=k, explain=args.explain)
        dt = time.perf_counter() - t0
        if args.explain:
            _explain(res.trace, device=args.verify == "device")
        _note_topk(res)
        hits = sum(int(np.array_equal(res.indices[qi], true_i[qi, :k]))
                   for qi in range(args.queries))
        acc = res.raw_accesses.mean()
        print(f"[match] exact k={k}: {hits}/{args.queries} query frontiers "
              f"== brute force; raw rows/query {acc:.0f} "
              f"({acc / args.n:.2%} of dataset), {res.store_fetches} "
              f"batched fetches; modeled {args.store} I/O "
              f"{res.io_seconds:.3f}s; wall {dt:.2f}s")

    # indexed exact top-k: the split tree generates a compact
    # candidate set instead of the linear sweep — bit-identical results
    if args.index:
        t0 = time.perf_counter()
        store.build_index(leaf_fill=args.leaf_fill)
        t_build = time.perf_counter() - t0
        store.reset()
        res_lin = engine.topk(Q, k=args.k)
        lin_acc = res_lin.raw_accesses.mean()
        store.reset()
        t0 = time.perf_counter()
        res_idx = engine.topk(Q, k=args.k, source="index",
                              explain=args.explain)
        dt = time.perf_counter() - t0
        if args.explain:
            _explain(res_idx.trace, device=args.verify == "device")
        _note_topk(res_idx)
        agree = (np.array_equal(res_idx.indices, res_lin.indices)
                 and np.array_equal(res_idx.distances, res_lin.distances))
        print(f"[match] index: {store.index.n_nodes} nodes over "
              f"{store.index.n} rows (leaf_fill {args.leaf_fill}) in "
              f"{t_build:.2f}s; indexed k={args.k} bitwise==linear "
              f"{'yes' if agree else 'NO'}; candidates/query "
              f"{res_idx.raw_accesses.mean():.0f} (indexed) vs "
              f"{lin_acc:.0f} (linear) of {args.n}; {res_idx.rounds} "
              f"rounds; wall {dt:.2f}s")

    # approximate top-k from the sweep's candidate frontier
    store.reset()
    t0 = time.perf_counter()
    res = engine.topk(Q, k=args.k, exact=False, explain=args.explain)
    dt = time.perf_counter() - t0
    if args.explain:
        _explain(res.trace, device=args.verify == "device")
    _note_topk(res)
    hit1 = sum(int(res.indices[qi, 0] == true_i[qi, 0])
               for qi in range(args.queries))
    print(f"[match] approx k={args.k}: 1-NN hit {hit1}/{args.queries}; "
          f"raw rows/query {res.raw_accesses.mean():.0f}; modeled "
          f"{args.store} I/O {res.io_seconds:.3f}s; wall {dt:.2f}s")

    # ingest while serving: append chunks, answer queries between them —
    # only the new chunk is encoded (and indexed) each round
    for c in range(args.ingest):
        chunk = ingest_pool[c * args.ingest_rows:(c + 1) * args.ingest_rows]
        t0 = time.perf_counter()
        engine.ingest(chunk)
        t_ing = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = engine.topk(Q, k=args.k, exact=False)
        t_q = time.perf_counter() - t0
        _note_topk(res)
        print(f"[match] ingest {c + 1}/{args.ingest}: +{chunk.shape[0]} "
              f"rows in {t_ing * 1e3:.0f}ms "
              f"({chunk.shape[0] / max(t_ing, 1e-9):.0f} rows/s), corpus "
              f"{store.n}; query k={args.k} under ingest {t_q * 1e3:.0f}ms")

    # the index was maintained incrementally through every ingest —
    # indexed queries stay exact with no rebuild
    if args.index and args.ingest:
        if store.index is None or store.index.n != store.n:
            raise SystemExit("[match] the index lost coverage on ingest")
        res_idx = engine.topk(Q, k=args.k, source="index")
        res_lin = engine.topk(Q, k=args.k)
        _note_topk(res_idx)
        _note_topk(res_lin)
        agree = (np.array_equal(res_idx.indices, res_lin.indices)
                 and np.array_equal(res_idx.distances, res_lin.distances))
        print(f"[match] index after {args.ingest} ingests: covers "
              f"{store.index.n} rows without rebuild; bitwise==linear "
              f"{'yes' if agree else 'NO'}")

    if args.snapshot_dir and (group is None
                              or torch.distributed.get_rank(group) == 0):
        t0 = time.perf_counter()
        path = store.save(args.snapshot_dir)
        print(f"[match] snapshot: {store.n} rows + rep"
              + (" + index" if store.index is not None else "")
              + f" -> {path} ({time.perf_counter() - t0:.2f}s)")

    if args.explain:
        _print_metrics(REGISTRY)


if __name__ == "__main__":
    main()
