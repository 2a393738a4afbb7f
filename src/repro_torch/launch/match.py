"""Matching launcher: encode a synthetic season corpus with SAX, sSAX,
tSAX or stSAX and serve batched exact and approximate top-k through the
port's ``MatchEngine``, checked against a brute force.

    PYTHONPATH=src python -m repro_torch.launch.match \
        --n 40000 --strength 0.7 --technique ssax --queries 8 --k 32

Runs on the CUDA card by default (``--device cuda``): the encode goes
through the K4 PAA kernel, the SAX / sSAX sweep through the K3 / K2
kernels (``kernels.ops.make_pairwise`` on the engine's ``pairwise=``
hook), and verification through the K1 euclid kernel
(``--verify auto``).  ``--device cpu`` runs every kernel's plain version
instead; without a card the default raises rather than falling back.
The brute force each exact answer is checked against is K1 over the
whole corpus, so the engine's exact top-k must equal it bitwise.

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
windowed kernel (``SubseqEngine.scan_topk``):

    PYTHONPATH=src python -m repro_torch.launch.match \
        --subseq --n 2048 --T 3600 --window 240 --stride 4 --k 8
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def launcher_technique(technique: str, T: int, L: int, strength: float):
    """The launcher's encoder: ``make_technique`` with W = 48."""
    from repro_torch.core.techniques import make_technique
    return make_technique(technique, T=T, W=48, L=L, r2_season=strength)


def make_engine(technique: str, D: np.ndarray, *, L: int = 10,
                strength: float = 0.7, batch: int = 256,
                store: str = "ssd", verify: str = "auto", rep=None,
                metrics=None, device="cuda"):
    """A ``MatchEngine`` over a ``SymbolicStore`` holding ``D`` (encoded
    on ``device`` unless ``rep``, the representation of ``D``, is given)
    with the launcher's encoder and the kernel sweep for SAX / sSAX.  The
    engine can ``append``, and its store can build an index and be
    saved."""
    from repro_torch.core.engine import MatchEngine
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.store import SymbolicStore
    tech = launcher_technique(technique, D.shape[1], L, strength)
    sym = SymbolicStore(tech, media=store, device=device)
    sym.append(D, rep=rep)
    return MatchEngine(tech, sym, batch_size=batch, verify=verify,
                       pairwise=make_pairwise(tech), metrics=metrics,
                       device=device)


def _explain(trace):
    """Print the per-query plan and fail on a broken trace (a missing
    required span, no verification round)."""
    from repro_torch.obs import check_trace, render_trace
    print(render_trace(trace))
    problems = check_trace(trace)
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
                       verify: str = "auto", device="cuda"):
    """A ``WindowView`` of ``D`` (window ``m``, W = m / L) and a
    ``SubseqEngine`` over it with the kernel sweep for SAX / sSAX."""
    from repro_torch.core.techniques import make_technique
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.subseq import SubseqEngine, WindowView
    tech = make_technique(technique, T=m, W=m // L, L=L,
                          r2_season=strength)
    view = WindowView(tech, D, stride=stride, media=store, device=device)
    return view, SubseqEngine(view, batch_size=batch, verify=verify,
                              pairwise=make_pairwise(tech))


def run_subseq(args, device):
    """Subsequence mode: encode every window of an (n, T) long-series
    corpus, localize snippet queries exactly, check them against a K1
    brute force over every window and the K5 brute-force scan."""
    from repro_torch.data.synthetic import season_dataset
    m, s = args.window, args.stride
    if m % args.L:
        raise SystemExit(f"--window {m} must be a multiple of --L {args.L}")
    if m > args.T:
        raise SystemExit(f"--window {m} longer than --T {args.T}")
    rng = np.random.default_rng(7)
    D = season_dataset(args.n, args.T, args.L, args.strength,
                       per_series_strength=True, seed=7)
    Q, q_rows, offs = subseq_queries(D, m, args.queries, rng)

    t0 = time.perf_counter()
    view, engine = make_subseq_engine(
        args.technique, D, m=m, stride=s, L=args.L, strength=args.strength,
        batch=args.batch, store=args.store, verify=args.verify,
        device=device)
    print(f"[subseq] {args.technique} over {args.n} x {args.T} "
          f"-> {view.n} windows (m={m}, stride={s}) on {device}; "
          f"encode {time.perf_counter() - t0:.2f}s")

    view.reset()
    t0 = time.perf_counter()
    res = engine.topk(Q, k=args.k, exclusion=args.exclusion)
    dt = time.perf_counter() - t0
    t0 = time.perf_counter()
    scan = engine.scan_topk(Q, k=args.k)
    dt_scan = time.perf_counter() - t0
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

    # streaming: new long series are searchable immediately
    extra = season_dataset(2, args.T, args.L, args.strength, seed=8)
    t0 = time.perf_counter()
    view.append(extra)
    print(f"[subseq] append 2 rows (+{2 * nw} windows) in "
          f"{(time.perf_counter() - t0) * 1e3:.0f}ms; corpus "
          f"{view.n_rows} rows / {view.n} windows")
    o2 = min(100, args.T - m)
    res2 = engine.topk(extra[:1, o2:o2 + m], k=1)
    print(f"[subseq] query of appended row -> row {res2.rows[0, 0]} "
          f"start {res2.starts[0, 0]} d={res2.distances[0, 0]:.4f}")


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
                    choices=["auto", "numpy", "kernel", "host"],
                    help="raw verification path: 'auto' is the K1 kernel "
                    "on a card and numpy on the CPU; 'kernel' and 'host' "
                    "always verify through K1")
    ap.add_argument("--device", default="cuda",
                    help="where encode, sweep and verification run")
    ap.add_argument("--subseq", action="store_true",
                    help="subsequence matching over long series")
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
                    help="build the split-tree index and serve indexed "
                    "exact queries beside the linear sweep (fewer rows "
                    "verified; the tree's collect walk runs on the host, "
                    "so the call is not faster yet)")
    ap.add_argument("--leaf-fill", type=int, default=64,
                    help="index leaf fill factor (split threshold)")
    ap.add_argument("--explain", action="store_true",
                    help="print a per-query plan (spans, candidates, "
                    "pruning, I/O, rounds) for every whole-series call "
                    "and fail if a required span is missing")
    ap.add_argument("--dryrun", action="store_true",
                    help="shrink every dimension to a seconds-scale smoke")
    args = ap.parse_args(argv)

    if args.dryrun:
        args.n = min(args.n, 12 if args.subseq else 256)
        args.T = min(args.T, 480)
        args.queries = min(args.queries, 4)
        args.k = min(args.k, 8)
        args.batch = min(args.batch, 64)
        args.ingest = min(args.ingest, 1)
        if args.subseq:
            args.window = min(args.window, 240)
            args.stride = max(args.stride, 8)

    from repro_torch.core.engine import resolve_device
    from repro_torch.data.synthetic import season_corpus
    device = resolve_device(args.device)
    if args.subseq:
        if args.index or args.explain or args.ingest or args.snapshot_dir:
            raise SystemExit("--index, --explain, --ingest and "
                             "--snapshot-dir serve whole-series matching "
                             "only; the subsequence path has none of them "
                             "yet")
        return run_subseq(args, device)
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
        metrics=REGISTRY if args.explain else None, device=device)
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
            _explain(res.trace)
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
            _explain(res_idx.trace)
        agree = (np.array_equal(res_idx.indices, res_lin.indices)
                 and np.array_equal(res_idx.distances, res_lin.distances))
        print(f"[match] index: {store.index.n_nodes} nodes over "
              f"{store.index.n} rows (leaf_fill {args.leaf_fill}) in "
              f"{t_build:.2f}s; indexed k={args.k} bitwise==linear "
              f"{'yes' if agree else 'NO'}; candidates/query "
              f"{res_idx.raw_accesses.mean():.0f} (indexed) vs "
              f"{lin_acc:.0f} (linear) of {args.n}; {res_idx.rounds} "
              f"rounds; wall {dt:.2f}s")

    # approximate top-k from the representation frontier
    store.reset()
    t0 = time.perf_counter()
    res = engine.topk(Q, k=args.k, exact=False, explain=args.explain)
    dt = time.perf_counter() - t0
    if args.explain:
        _explain(res.trace)
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
        engine.append(chunk)
        t_ing = time.perf_counter() - t0
        t0 = time.perf_counter()
        res = engine.topk(Q, k=args.k, exact=False)
        t_q = time.perf_counter() - t0
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
        agree = (np.array_equal(res_idx.indices, res_lin.indices)
                 and np.array_equal(res_idx.distances, res_lin.distances))
        print(f"[match] index after {args.ingest} ingests: covers "
              f"{store.index.n} rows without rebuild; bitwise==linear "
              f"{'yes' if agree else 'NO'}")

    if args.snapshot_dir:
        t0 = time.perf_counter()
        path = store.save(args.snapshot_dir)
        print(f"[match] snapshot: {store.n} rows + rep"
              + (" + index" if store.index is not None else "")
              + f" -> {path} ({time.perf_counter() - t0:.2f}s)")

    if args.explain:
        _print_metrics(REGISTRY)


if __name__ == "__main__":
    main()
