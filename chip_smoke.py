#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py          # every phase, on one card
    python3 chip_smoke.py --k5     # build, then time K5 alone
    python3 chip_smoke.py --k2     # build, then time K2 alone (Q = 1..64)
    python3 chip_smoke.py --split  # build, then the main path's topk split

Phases, each failing loudly with a nonzero exit:

1. Build the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (nvcc, sm_90a) and print the build seconds.
2. Hold each kernel (K1 euclid, K2 ssax_dist, K3 sax_dist, K4 paa, K5
   windowed_euclid) against its plain PyTorch version on the card at
   both paths' shapes (whole series and windows) plus ragged ones;
   time the kernel, the plain version and, where one exists, a single
   PyTorch call computing the same function.  K2 runs one query and
   the path's 8 queries in one batched launch at both sweep shapes,
   every batched row bitwise equal to its one-query launch.  K1's gathered entry runs
   at the verification round shape (T = 960, 240, bf16, 961) and must
   equal its all-pairs entry bitwise; it is timed on the device (a
   CUDA graph, rows from HBM and rows in L2) and as one host-clock
   call.  K5 runs at strides 4 and 1 and at one ``scan_topk`` launch
   (38 rows), each timed launch checked on its first rows; K4 at the
   window shape.
3. Drive the main path through the launcher's ``make_engine`` and
   ``MatchEngine.topk``: sSAX and SAX exact top-k (k = 1, 32) over a
   1,000,000 x 960 season corpus, tSAX and stSAX over its first 65,536
   rows, ``verify="auto"``.  Every exact answer must equal a K1 brute
   force bitwise, and its ids a plain-version brute force away from
   near-ties.
4. Drive the index path through the launcher's ``make_engine``,
   ``SymbolicStore.build_index`` and ``MatchEngine.topk(source="index",
   explain=)`` on phase 3's corpus: the sSAX split-tree index over all
   1,000,000 rows (leaf_fill 64; build seconds and nodes printed),
   indexed k = 1 and 32 bitwise equal to phase 3's K1 brute force and
   to the linear answers (phase 3's and this store's), and traced
   (``explain=True``) indexed and linear calls bitwise equal to their
   untraced calls with the same launches, their traces clean under
   ``check_trace`` and rendered; SAX, tSAX and stSAX indexed over the
   first 65,536 rows, each bitwise equal to its linear answer; then a
   snapshot round trip of a 65,536-row sSAX store with its index (save,
   ``SymbolicStore.open(device="cuda")``, answers bitwise, 2 rows
   appended after reopening are indexed and found).  Every call's K1
   launches equal its rounds and its store fetches: the seed
   verification is one round (one fetch, one gathered K1 launch) and
   each scan round another.
5. Drive the subsequence path through the launcher's building blocks
   (``make_subseq_engine``, ``SubseqEngine.topk`` and ``scan_topk``):
   every z-normalized window (m = 240, stride 4) of a 2,048 x 3,600
   season corpus, 1,722,368 windows, sSAX (k = 1, 8, and 8 with
   exclusion 120) and SAX (k = 8), tSAX and stSAX (k = 8) over its
   first 256 rows.  Every answer must equal a K1 brute force over all
   windows bitwise (the exclusion answer its greedy non-overlap filter),
   the K5 scan must agree away from near-ties, a row appended later
   must be found, and a chunked window encode must equal a one-shot one
   on the card bitwise.
   Phases 3 and 5 print the split of one warm topk call (sweep, host
   argsort, verification loop) and fail unless every call's K1 launches
   equal its verification rounds (one gathered launch per round; on
   whole series every round is also one store fetch) and every sSAX
   sweep made one K2 launch (one batched sweep for all its queries).
6. Print each path's launch counts (each kernel of a path > 0) and the
   ``{"kernels": [...]}`` line with the launches of all three paths.
7. Print the card's name and power limit, then the result line.

It imports neither JAX nor the JAX package, needs the repository beside
it, and exits nonzero without printing a result when there is no card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

HBM_BYTES_PER_S = 3.35e12     # H100 SXM, NVIDIA data sheet
F32_FLOPS_PER_S = 67e12       # H100 SXM f32 outside the tensor cores
F32_ISSUE_PER_S = 132 * 128 * 1.98e9   # FP32 lane-instructions, boost clock

N_MAIN = 1_000_000            # corpus rows for sSAX / SAX
N_SMALL = 65_536              # corpus rows for tSAX / stSAX
T, W, L, STRENGTH = 960, 48, 10, 0.7
N_QUERIES, KS, BATCH = 8, (1, 32), 256
SUB_ROWS, SUB_SMALL, SUB_T = 2048, 256, 3600   # subsequence corpus
SUB_M, SUB_STRIDE, SUB_EXCL = 240, 4, 120      # window, hop, exclusion
SUB_CHUNK_ROWS = 38           # rows of one scan_topk launch (2.5e8 B chunk)
SUB_CALLS = {"ssax": ((1, 0), (8, 0), (8, SUB_EXCL)), "sax": ((8, 0),),
             "tsax": ((8, 0),), "stsax": ((8, 0),)}   # (k, exclusion)
LEAF_FILL = 64                # split-tree leaf fill factor of the index path
TOL = {"euclid": 1e-4, "euclid_bf16": 5e-2, "ssax_dist": 1e-4,
       "sax_dist": 1e-5, "paa": 1e-5, "paa_bf16": 2e-2,
       "windowed_euclid": 1e-3}
REPLACES = {
    "euclid": "src/repro/kernels/euclid.py:75",
    "ssax_dist": "src/repro/kernels/ssax_dist.py:58",
    "sax_dist": "src/repro/kernels/sax_dist.py:50",
    "paa": "src/repro/kernels/paa.py:42",
    "windowed_euclid": "src/repro/kernels/windowed_euclid.py:127",
}
MAIN_KERNELS = ("euclid", "ssax_dist", "sax_dist", "paa")


def fail(msg: str):
    print(f"[smoke] FAILED: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def say(msg: str):
    print(f"[smoke] {msg}", flush=True)


def time_ms(torch, fn, iters: int, warmup: int = 3) -> float:
    """Mean device time of ``fn()`` over ``iters`` calls (CUDA events)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(torch, fn, n: int = 100) -> float:
    """Device time of one ``fn()``: ``n`` calls captured in a CUDA graph,
    the graph replayed between two events, divided by ``n``.  No host
    cost of the calls is in it.  ``fn`` must launch without host work
    that a capture forbids (no synchronisation, no pageable copies)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(n):
            fn()
    graph.replay()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / n


def k5_shapes(torch, ops, ref, dev):
    """K5 at the scan shape at stride 4 and at stride 1, and at the shape
    of one ``scan_topk`` launch (38 rows at stride 4): device time (CUDA
    events, back to back; the chunk shape from a CUDA graph), time per
    window and bound.  The first 64 rows of each timed launch's output
    (all 38 of the chunk's) are held against the plain version on those
    rows.  Returns the rows, keyed by shape name."""
    g = torch.Generator(device=dev).manual_seed(5)
    x = torch.randn(SUB_ROWS, SUB_T, generator=g, device=dev)
    q = torch.randn(N_QUERIES, SUB_M, generator=g, device=dev)
    q = (q - q.mean(-1, keepdim=True)) / q.std(-1, keepdim=True,
                                               correction=0)
    out = {}
    for name, n_rows, stride in (("stride4", SUB_ROWS, SUB_STRIDE),
                                 ("stride1", SUB_ROWS, 1),
                                 ("chunk38", SUB_CHUNK_ROWS, SUB_STRIDE)):
        xs = x[:n_rows].contiguous()
        s = (SUB_T - SUB_M) // stride + 1
        n_chk = min(n_rows, 64)
        err = check(f"windowed_euclid {name} (first {n_chk} rows)",
                    ops.windowed_euclid(xs, q, stride)[:, :n_chk],
                    ref.windowed_euclid_ref(xs[:n_chk], q, stride),
                    TOL["windowed_euclid"])
        fn = (lambda xs=xs, stride=stride:
              ops.windowed_euclid(xs, q, stride))
        ms = (graph_ms(torch, fn) if n_rows < SUB_ROWS
              else time_ms(torch, fn, 20))
        b = bound_ms(n_rows * SUB_T * 4 + N_QUERIES * SUB_M * 4
                     + N_QUERIES * n_rows * s * 4,
                     2 * SUB_M * N_QUERIES * n_rows * s)
        out[name] = dict(ms=ms, windows=n_rows * s, max_abs_err=err,
                         ns_per_window=ms * 1e6 / (n_rows * s), bound=b,
                         shape=f"Q={N_QUERIES}, ({n_rows}, {SUB_T}), "
                               f"m={SUB_M}, stride {stride}, S={s}")
        say(f"K5 {name} [{out[name]['shape']}]: {ms:.5f} ms, "
            f"{out[name]['ns_per_window']:.5f} ns per window, bound "
            f"{b[0]:.5f} ms ({b[1]})")
    return out


def k2_shapes(torch, ops, ref, randint, randn):
    """K2 at the main path's sweep shape (1,000,000 x (L + W) = 10 + 48)
    and the subsequence path's (1,722,368 windows x (10 + 24)), with
    make_technique's alphabets (16 season, 32 residual symbols): one
    query (``ssax_dist``) and the path's 8 queries in one batched launch
    (``ssax_dist_batch``).  Each is held against the plain version, and
    every batched row bitwise against its one-query launch; then a
    ragged shape.  Times are device times (events, back to back), beside
    the bound as reckoned (symbol bytes once, tables and output, against
    Q x 6 operations per cell) and the issue floor (Q x 5 FP32
    instructions per cell over 132 SMs x 128 lanes at the data sheet's
    1.98 GHz).  Returns the report's row: the main path's 8-query
    launch."""
    n_win = (SUB_T - SUB_M) // SUB_STRIDE + 1
    a_s, a_r, tol, row, err = 16, 32, TOL["ssax_dist"], None, 0.0
    for name, n, w in (("main", N_MAIN, W),
                       ("subseq", SUB_ROWS * n_win, SUB_M // L)):
        seas, res = randint(a_s, (n, L)), randint(a_r, (n, w))
        tabs = (randn(N_QUERIES, L, a_s), randn(N_QUERIES, L, a_s),
                randn(N_QUERIES, w, a_r), randn(N_QUERIES, w, a_r))
        one = [t[0] for t in tabs]
        got = ops.ssax_dist_batch(seas, res, *tabs)
        err = max(err, check(f"ssax_dist {name} Q={N_QUERIES}", got,
                             ref.ssax_dist_batch_ref(seas, res, *tabs), tol))
        err = max(err, check(f"ssax_dist {name} Q=1",
                             ops.ssax_dist(seas, res, *one),
                             ref.ssax_dist_ref(seas, res, *one), tol))
        for q in range(N_QUERIES):
            if not torch.equal(got[q], ops.ssax_dist(
                    seas, res, *(t[q] for t in tabs))):
                fail(f"ssax_dist {name}: batched row {q} differs from its "
                     f"one-query launch")
        routes = {1: (lambda: ops.ssax_dist(seas, res, *one),
                      lambda: ref.ssax_dist_ref(seas, res, *one)),
                  N_QUERIES: (lambda: ops.ssax_dist_batch(seas, res, *tabs),
                              lambda: ref.ssax_dist_batch_ref(seas, res,
                                                              *tabs))}
        for nq, (fn, plain) in routes.items():
            cells = nq * n * L * w
            r = dict(ms=time_ms(torch, fn, 50 if nq == 1 else 20),
                     plain_ms=time_ms(torch, plain, 2, warmup=1),
                     library_ms=None,
                     bound=bound_ms(n * (L + w) * 4 + nq * n * 4
                                    + nq * 2 * (L * a_s + w * a_r) * 4,
                                    6 * cells),
                     floor_ms=5 * cells / F32_ISSUE_PER_S * 1e3,
                     shape=f"{name}: seas ({n}, {L}), res ({n}, {w}) i32, "
                           f"Q={nq}" + (" in one launch" if nq > 1 else ""))
            say(f"kernel ssax_dist [{r['shape']}]: {r['ms']:.5f} ms "
                f"(events, back to back), plain {r['plain_ms']:.4f} ms, "
                f"bound {r['bound'][0]:.5f} ms ({r['bound'][1]}), issue "
                f"floor {r['floor_ms']:.5f} ms (5 FP32 instructions per "
                f"cell)")
            if name == "main" and nq == N_QUERIES:
                row = r
        say(f"ssax_dist {name}: every row of the {N_QUERIES}-query launch == "
            f"its one-query launch, bitwise")
        del seas, res, got
    rag = (randint(a_s, (300, L)), randint(a_r, (300, 17)),
           randn(3, L, a_s), randn(3, L, a_s), randn(3, 17, a_r),
           randn(3, 17, a_r))
    err = max(err, check("ssax_dist ragged", ops.ssax_dist_batch(*rag),
                         ref.ssax_dist_batch_ref(*rag), tol))
    row["max_abs_err"] = err
    return row


def host_ms(torch, fn, iters: int = 200, warmup: int = 5) -> float:
    """Mean host-clock time of ``fn()`` followed by a synchronisation,
    as the verification loop pays it (it reads the result back)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        total += time.perf_counter() - t0
    return total / iters * 1e3


def k1_gathered(torch, ops, ref, dev):
    """K1's gathered entry at the verification round shape (Qa = 8 active
    queries, B = 256 candidates each, U = 2,048 rows) at T = 960 (whole
    series), T = 240 (windows), bf16 and the ragged T = 961.  As on the
    path, the rows are exactly the union of the candidates: the gather
    is a permutation of the U rows split across the queries, so every
    row is read once.  Each is held bitwise to the all-pairs entry on
    the gathered rows and to the plain version within tolerance.  At
    T = 960 f32: device time from a CUDA graph of 100 launches, cycling
    over 8 copies of the rows (63 MB, beyond the 50 MB L2, so each
    launch reads its rows from HBM) and, beside it, on one copy that
    stays in L2 across the replays; the host-clock time of one wrapper
    call (host gather checked and copied, one launch, synchronised)
    beside the per-query route the engine took before (eight gather
    copies, eight all-pairs launches, a stack); and the bound.  Returns
    the kernel row of the report."""
    import numpy as np
    from repro_torch.kernels import euclid as k1
    rng = np.random.default_rng(3)
    U, qa = 2 * 1024, N_QUERIES
    g_np = rng.permutation(U).reshape(qa, BATCH).astype(np.int64)
    g_dev = torch.from_numpy(g_np).to(dev)
    gen = torch.Generator(device=dev).manual_seed(3)
    err, row = 0.0, None
    for t_len, dtype in ((T, torch.float32), (SUB_M, torch.float32),
                         (T, torch.bfloat16), (961, torch.float32)):
        rows = torch.randn(U, t_len, generator=gen, device=dev).to(dtype)
        q = torch.randn(qa, t_len, generator=gen, device=dev).to(dtype)
        got = ops.euclid_gather(rows, q, g_np)
        per_q = torch.stack([ops.euclid_batch(rows[g_dev[a]].contiguous(),
                                              q[a]) for a in range(qa)])
        name = f"euclid gathered T={t_len} {str(dtype)[6:]}"
        if not torch.equal(got, per_q):
            fail(f"{name}: differs from the all-pairs kernel on the "
                 f"gathered rows")
        tol = TOL["euclid" if dtype == torch.float32 else "euclid_bf16"]
        err = max(err, check(name, got, ref.euclid_gather_ref(rows, q, g_dev),
                             tol))
        if row is not None:
            continue
        out = torch.empty(qa, BATCH, device=dev)
        esize = rows.element_size()
        copies = [rows] + [rows.clone() for _ in range(7)]
        turn = iter(range(1 << 30))

        def from_hbm():
            k1.launch_gather(copies[next(turn) % len(copies)], q, g_dev, out)
        row = dict(
            ms=graph_ms(torch, from_hbm),
            l2_ms=graph_ms(torch, lambda: k1.launch_gather(rows, q, g_dev,
                                                           out)),
            host_ms=host_ms(torch, lambda: ops.euclid_gather(rows, q, g_np)),
            per_query_host_ms=host_ms(torch, lambda: torch.stack(
                [ops.euclid_batch(rows[g_dev[a]], q[a])
                 for a in range(qa)])),
            plain_ms=time_ms(torch, lambda: ref.euclid_gather_ref(
                rows, q, g_dev), 50),
            library_ms=time_ms(torch, lambda: torch.cdist(
                q[:, None, :], rows[g_dev]).square(), 50),
            bound=bound_ms(U * t_len * esize + qa * t_len * esize
                           + qa * BATCH * 8 + qa * BATCH * 4,
                           3 * qa * BATCH * t_len),
            shape=f"gathered, rows ({U}, {t_len}) f32 all read, q ({qa}, "
                  f"{t_len}), gather ({qa}, {BATCH})")
        del copies
        say(f"kernel euclid [{row['shape']}]: device {row['ms']:.5f} ms "
            f"(CUDA graph of 100 over 8 copies of the rows, read from "
            f"HBM), {row['l2_ms']:.5f} ms with the rows in L2 (one copy); "
            f"one wrapper call {row['host_ms']:.5f} ms on the host clock "
            f"against {row['per_query_host_ms']:.5f} ms for the per-query "
            f"route, bound {row['bound'][0]:.6f} ms ({row['bound'][1]}); "
            f"library = cdist on the gathered rows (gather copy included) "
            f"{row['library_ms']:.5f} ms")
    row["max_abs_err"] = err
    say(f"euclid gathered == all pairs on the gathered rows, bitwise, at "
        f"T = {T}, {SUB_M}, {T} bf16 and 961")
    return row


def sync(torch, dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def bound_ms(n_bytes: float, n_ops: float):
    t_b = n_bytes / HBM_BYTES_PER_S * 1e3
    t_o = n_ops / F32_FLOPS_PER_S * 1e3
    return (t_b, "bytes") if t_b >= t_o else (t_o, "operations")


def check(name: str, got, want, tol: float) -> float:
    """Max abs error of ``got`` vs ``want``; fails beyond rtol = atol."""
    got, want = got.float(), want.float()
    if got.shape != want.shape:
        fail(f"{name}: shape {tuple(got.shape)} vs {tuple(want.shape)}")
    err = (got - want).abs()
    if not bool((err <= tol + tol * want.abs()).all()):
        fail(f"{name}: kernel disagrees with its plain version "
             f"(max abs err {float(err.max())}, tolerance {tol})")
    return float(err.max()) if err.numel() else 0.0


def random_makers(torch, dev, seed: int):
    """``randint(hi, shape)`` (int32) and ``randn(*shape)`` on ``dev``
    from one seeded generator."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)
    return randint, randn


def k2_scaling(torch, ops, dev):
    """``--k2``: K2's device time at the main path's sweep shape for Q =
    1 to 64 queries in one launch (events, back to back), per query and
    against the issue floor, to show where the time per query goes as
    the symbols' bytes are shared by more queries."""
    randint, randn = random_makers(torch, dev, 2)
    seas, res = randint(16, (N_MAIN, L)), randint(32, (N_MAIN, W))
    for nq in (1, 2, 4, 8, 16, 64):
        tabs = (randn(nq, L, 16), randn(nq, L, 16), randn(nq, W, 32),
                randn(nq, W, 32))
        ms = time_ms(torch, lambda: ops.ssax_dist_batch(seas, res, *tabs),
                     20)
        floor = 5 * nq * N_MAIN * L * W / F32_ISSUE_PER_S * 1e3
        say(f"K2 Q={nq} in one launch at ({N_MAIN}, {L} + {W}): {ms:.5f} "
            f"ms, {ms / nq:.5f} ms per query, issue floor {floor:.5f} ms "
            f"({floor / ms:.0%} of it)")


def kernel_phase(torch, ops, ref, dev):
    """Phase 2: every kernel against its plain version, with times."""
    randint, randn = random_makers(torch, dev, 0)
    rows = {}

    # K4 paa at the encode shape, a ragged shape and bf16
    x = randn(N_MAIN, T)
    err = check("paa", ops.paa_segments(x, W), ref.paa_ref(x, W), TOL["paa"])
    xr = randn(300, 480)
    err = max(err, check("paa ragged", ops.paa_segments(xr, 24),
                         ref.paa_ref(xr, 24), TOL["paa"]))
    xb = randn(4096, T).to(torch.bfloat16)
    err = max(err, check("paa bf16", ops.paa_segments(xb, W),
                         ref.paa_ref(xb, W), TOL["paa_bf16"]))
    rows["paa"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.paa_segments(x, W), 20),
        plain_ms=time_ms(torch, lambda: ref.paa_ref(x, W), 20),
        library_ms=time_ms(torch, lambda: x.view(N_MAIN, W, T // W).mean(-1),
                           20),
        bound=bound_ms(N_MAIN * T * 4 + N_MAIN * W * 4, N_MAIN * T),
        shape=f"x ({N_MAIN}, {T}) f32 -> ({N_MAIN}, {W})")
    del x

    # K3 sax_dist at the sweep shape (one query), ragged and a table
    # beyond shared memory (W=96, A=1024: 384 KB)
    A = 64
    sym, tab = randint(A, (N_MAIN, W)), randn(W, A).square()
    err = check("sax_dist", ops.sax_dist(sym, tab), ref.sax_dist_ref(sym, tab),
                TOL["sax_dist"])
    s2, t2 = randint(32, (300, 16)), randn(16, 32).square()
    err = max(err, check("sax_dist ragged", ops.sax_dist(s2, t2),
                         ref.sax_dist_ref(s2, t2), TOL["sax_dist"]))
    s3, t3 = randint(1024, (65_536, 96)), randn(96, 1024).square()
    err = max(err, check("sax_dist big table", ops.sax_dist(s3, t3),
                         ref.sax_dist_ref(s3, t3), TOL["sax_dist"]))
    rows["sax_dist"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.sax_dist(sym, tab), 50),
        plain_ms=time_ms(torch, lambda: ref.sax_dist_ref(sym, tab), 10),
        library_ms=None,
        bound=bound_ms(N_MAIN * W * 4 + W * A * 4 + N_MAIN * 4, N_MAIN * W),
        shape=f"sym ({N_MAIN}, {W}) i32, table ({W}, {A})")
    del sym

    # K2 ssax_dist at both paths' sweep shapes (one query, and the path's
    # 8 queries in one batched launch) and ragged
    rows["ssax_dist"] = k2_shapes(torch, ops, ref, randint, randn)

    # K1 euclid at the verification shape (one query against one batch),
    # a query batch, a ragged shape and bf16
    xv, qv = randn(BATCH, T), randn(1, T)

    def plain_euclid(x, q):
        return torch.stack([ref.euclid_ref(x, qi) for qi in q])
    err = check("euclid", ops.euclid_batch(xv, qv), plain_euclid(xv, qv),
                TOL["euclid"])
    xq, qq = randn(65_536, T), randn(N_QUERIES, T)
    err = max(err, check("euclid queries", ops.euclid_batch(xq, qq),
                         plain_euclid(xq, qq), TOL["euclid"]))
    xr, qr = randn(37, 961), randn(3, 961)
    err = max(err, check("euclid ragged", ops.euclid_batch(xr, qr),
                         plain_euclid(xr, qr), TOL["euclid"]))
    xb, qb = xq[:4096].to(torch.bfloat16), qq.to(torch.bfloat16)
    err = max(err, check("euclid bf16", ops.euclid_batch(xb, qb),
                         plain_euclid(xb, qb), TOL["euclid_bf16"]))
    single = dict(
        ms=time_ms(torch, lambda: ops.euclid_batch(xv, qv), 200),
        plain_ms=time_ms(torch, lambda: plain_euclid(xv, qv), 200),
        library_ms=time_ms(torch, lambda: torch.cdist(qv, xv) ** 2, 200),
        bound=bound_ms(BATCH * T * 4 + T * 4 + BATCH * 4, 3 * BATCH * T),
        shape=f"all pairs, x ({BATCH}, {T}) f32, q (1, {T})")
    rows["euclid"] = k1_gathered(torch, ops, ref, dev)
    rows["euclid"]["max_abs_err"] = max(err, rows["euclid"]["max_abs_err"])
    say(f"kernel euclid [{single['shape']}]: {single['ms']:.5f} ms (events, "
        f"back to back), plain {single['plain_ms']:.5f} ms, library "
        f"{single['library_ms']:.5f} ms, bound {single['bound'][0]:.6f} ms")

    # K5 windowed_euclid at the reference's test shapes, the scan shape
    # on its first 64 rows (the plain version materializes (Q, N, S, m)),
    # constant rows (every distance is sum q^2; the plain version is not
    # asked, as torch's mean on the card need not return the constant
    # exactly, and znormalize then divides the difference by eps) and
    # rows offset by 1000
    def zq(nq, m):
        q = randn(nq, m)
        return (q - q.mean(-1, keepdim=True)) / q.std(-1, keepdim=True,
                                                      correction=0)
    tol, err = TOL["windowed_euclid"], 0.0
    for nq, n, t, m, st in [(1, 4, 256, 64, 1), (3, 5, 300, 32, 3),
                            (2, 9, 1111, 64, 7), (2, 2, 100, 100, 1),
                            (4, 24, 960, 120, 5)]:
        x, q = randn(n, t), zq(nq, m)
        err = max(err, check(f"windowed_euclid {(nq, n, t, m, st)}",
                             ops.windowed_euclid(x, q, st),
                             ref.windowed_euclid_ref(x, q, st), tol))
    xs, qs = randn(SUB_ROWS, SUB_T), zq(N_QUERIES, SUB_M)
    x64 = xs[:64]
    err = max(err, check("windowed_euclid scan shape",
                         ops.windowed_euclid(x64, qs, SUB_STRIDE),
                         ref.windowed_euclid_ref(x64, qs, SUB_STRIDE), tol))
    xc = torch.full((3, 1000), 2.5, device=dev)
    got = ops.windowed_euclid(xc, qs, SUB_STRIDE)
    err = max(err, check("windowed_euclid constant", got,
                         qs.square().sum(-1)[:, None, None].expand_as(got),
                         tol))
    xo = x64[:16] + 1000.0
    err = max(err, check("windowed_euclid offset",
                         ops.windowed_euclid(xo, qs, SUB_STRIDE),
                         ref.windowed_euclid_ref(xo, qs, SUB_STRIDE), tol))
    n_win = (SUB_T - SUB_M) // SUB_STRIDE + 1
    rows["windowed_euclid"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.windowed_euclid(xs, qs, SUB_STRIDE),
                   20),
        plain_ms=time_ms(torch, lambda: ref.windowed_euclid_ref(
            x64, qs, SUB_STRIDE), 5),
        library_ms=None,
        bound=bound_ms(SUB_ROWS * SUB_T * 4 + N_QUERIES * SUB_M * 4
                       + N_QUERIES * SUB_ROWS * n_win * 4,
                       2 * SUB_M * N_QUERIES * SUB_ROWS * n_win),
        shape=f"x ({SUB_ROWS}, {SUB_T}) f32, q ({N_QUERIES}, {SUB_M}), "
              f"stride {SUB_STRIDE}; plain on the first 64 rows")
    del xs, x64
    for r in k5_shapes(torch, ops, ref, dev).values():
        rows["windowed_euclid"]["max_abs_err"] = max(
            rows["windowed_euclid"]["max_abs_err"], r["max_abs_err"])

    # K1-K4 at the subsequence path's shapes: windows of m = 240 encoded
    # with W = 24 (K4 on one row's 841 windows; K2 and K3 over all
    # 1,722,368 windows with make_technique's alphabets, as above),
    # verified 256 windows at a time against one query (K1) and
    # brute-forced 65,536 windows at a time against all 8 queries
    n_sub, w_sub = SUB_ROWS * n_win, SUB_M // L
    sub = {}
    xw = randn(n_win, SUB_M)
    sub["paa"] = check("paa subseq", ops.paa_segments(xw, w_sub),
                       ref.paa_ref(xw, w_sub), TOL["paa"])
    b = bound_ms(n_win * SUB_M * 4 + n_win * w_sub * 4, n_win * SUB_M)
    say(f"kernel paa [x ({n_win}, {SUB_M}) f32 -> ({n_win}, {w_sub}), one "
        f"window-encode launch]: device "
        f"{graph_ms(torch, lambda: ops.paa_segments(xw, w_sub)):.5f} ms "
        f"(CUDA graph of 100), plain "
        f"{graph_ms(torch, lambda: ref.paa_ref(xw, w_sub)):.5f} ms, library "
        f"{graph_ms(torch, lambda: xw.view(n_win, w_sub, SUB_M // w_sub).mean(-1)):.5f} "
        f"ms, bound {b[0]:.6f} ms ({b[1]})")
    sym, tab = randint(A, (n_sub, w_sub)), randn(w_sub, A).square()
    sub["sax_dist"] = check("sax_dist subseq", ops.sax_dist(sym, tab),
                            ref.sax_dist_ref(sym, tab), TOL["sax_dist"])
    del sym
    xv, qv = randn(BATCH, SUB_M), randn(1, SUB_M)
    sub["euclid"] = check("euclid subseq verify", ops.euclid_batch(xv, qv),
                          plain_euclid(xv, qv), TOL["euclid"])
    xq, qq = randn(65_536, SUB_M), randn(N_QUERIES, SUB_M)
    sub["euclid"] = max(sub["euclid"], check(
        "euclid subseq brute force", ops.euclid_batch(xq, qq),
        plain_euclid(xq, qq), TOL["euclid"]))
    del xq
    for name, e in sub.items():
        rows[name]["max_abs_err"] = max(rows[name]["max_abs_err"], e)
    say(f"kernels at the subsequence shapes agree with their plain "
        f"versions: paa ({n_win}, {SUB_M}) -> {w_sub}; sax_dist over "
        f"{n_sub} windows at W={w_sub} (ssax_dist above); euclid ({BATCH}, "
        f"{SUB_M}) x 1 and (65536, {SUB_M}) x {N_QUERIES}; max abs err "
        f"{sub}")
    for name, r in rows.items():
        say(f"kernel {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max abs err "
            f"{r['max_abs_err']:.3g}")
    return rows


def split(torch, np, dev, engines, Q):
    """Where one warm 8-query topk call's wall time goes, for sSAX and
    SAX at k = 32 (host clock): the sweep (query encode, one K2 launch
    for all queries or one K3 launch per query, bounds to the host), the host's stable argsort of the
    (Q, N) bounds, and the verification loop (fetch, K1, merge) that is
    the rest."""
    for tech in ("ssax", "sax"):
        engine, k = engines[tech], max(KS)
        sync(torch, dev)
        t0 = time.perf_counter()
        rd = engine.repr_distances(Q)
        t_sweep = time.perf_counter() - t0
        t0 = time.perf_counter()
        np.argsort(rd, axis=1, kind="stable")
        t_sort = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.topk(Q, k=k)
        t_all = time.perf_counter() - t0
        say(f"breakdown {tech} N={N_MAIN} k={k}: topk {t_all:.3f} s = sweep "
            f"{t_sweep:.3f} s + host argsort {t_sort:.3f} s + verification "
            f"loop {t_all - t_sweep - t_sort:.3f} s")


def split_only(torch, np, dev):
    """``--split``: the main path's corpus and its sSAX and SAX engines,
    one warm-up topk each, then :func:`split`.  It calls only entry
    points every slice of the port has, so the same script can time an
    earlier tree's ``src`` beside this one."""
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.launch.match import make_engine
    X = season_corpus(N_MAIN + N_QUERIES, T, L, STRENGTH,
                      per_series_strength=True, seed=1)
    Q, D = X[:N_QUERIES], X[N_QUERIES:]
    engines = {tech: make_engine(tech, D, L=L, strength=STRENGTH,
                                 batch=BATCH, verify="auto", device=dev)
               for tech in ("ssax", "sax")}
    for engine in engines.values():
        engine.topk(Q, k=max(KS))
    split(torch, np, dev, engines, Q)


def main_path(torch, np, dev):
    """Phase 3: the port's main path, then its checks.  Returns the
    kernels' launch counts during the path alone and what the index
    path reuses: the queries, the corpus, the sSAX representation on
    the host, the K1 brute force per technique and the answers."""
    from repro_torch.data.synthetic import season_corpus
    from repro_torch.kernels import launch_counts, ref, reset_launch_counts
    from repro_torch.launch.match import kernel_bruteforce, make_engine

    t0 = time.perf_counter()
    X = season_corpus(N_MAIN + N_QUERIES, T, L, STRENGTH,
                      per_series_strength=True, seed=1)
    Q, D = X[:N_QUERIES], X[N_QUERIES:]
    say(f"corpus {D.shape} f32 ({D.nbytes / 1e9:.2f} GB) + {N_QUERIES} "
        f"queries generated in {time.perf_counter() - t0:.1f} s")

    plan = [("ssax", D), ("sax", D), ("tsax", D[:N_SMALL]),
            ("stsax", D[:N_SMALL])]
    results, engines = {}, {}
    reset_launch_counts()
    for tech, data in plan:
        sync(torch, dev)
        t0 = time.perf_counter()
        engine = engines[tech] = make_engine(
            tech, data, L=L, strength=STRENGTH, batch=BATCH, verify="auto",
            device=dev)
        sync(torch, dev)
        t_enc = time.perf_counter() - t0
        for k in KS:
            engine.store.reset()
            before = launch_counts()
            t0 = time.perf_counter()
            res = engine.topk(Q, k=k)
            wall = time.perf_counter() - t0
            calls = {n: c - before[n] for n, c in launch_counts().items()}
            results[tech, k] = (res, wall, calls)
        say(f"{tech} N={data.shape[0]}: engine built (encode) in "
            f"{t_enc:.2f} s")
    counts = launch_counts()
    say(f"main path launches: {counts}")
    rounds_check("main path", results.values(), exact_fetch=True)
    sweep_check("main path", [c for (tech, _), (_, _, c) in results.items()
                              if tech == "ssax"])

    split(torch, np, dev, engines, Q)
    rep_ssax = tuple(t.cpu().numpy() for t in engines["ssax"].rep)
    engines.clear()
    brute = {}

    for tech, data in plan:
        n = data.shape[0]
        bf_i, bf_d = brute[tech] = kernel_bruteforce(Q, data, max(KS) + 1,
                                                     dev)
        pl_d = plain_bruteforce(torch, np, ref, Q, data, dev)
        pl_o = np.argsort(pl_d, axis=1, kind="stable")
        for k in KS:
            res, wall, calls = results[tech, k]
            if res.indices.shape != (N_QUERIES, k) or \
                    not np.isfinite(res.distances).all() or \
                    (res.indices < 0).any() or (res.indices >= n).any():
                fail(f"{tech} k={k}: malformed result")
            if not (np.array_equal(res.indices, bf_i[:, :k]) and
                    np.array_equal(res.distances,
                                   bf_d[:, :k].astype(np.float64))):
                fail(f"{tech} k={k}: exact top-k differs from the K1 "
                     f"brute force")
            compared = 0
            for qi in range(N_QUERIES):
                dk, dk1 = pl_d[qi, pl_o[qi, k - 1]], pl_d[qi, pl_o[qi, k]]
                if dk1 - dk <= 1e-5 * dk:
                    continue                  # near-tie at the k boundary
                compared += 1
                if set(res.indices[qi]) != set(pl_o[qi, :k]):
                    fail(f"{tech} k={k} query {qi}: ids differ from the "
                         f"plain brute force")
            acc = res.raw_accesses.mean()
            say(f"{tech} N={n} k={k}: exact == K1 brute force bitwise; ids "
                f"== plain brute force on {compared}/{N_QUERIES} queries "
                f"(others near-tied); raw rows/query {acc:.1f}, pruned "
                f"fraction {res.pruned_fraction.mean():.6f}, "
                f"{res.rounds} rounds, {res.store_fetches} fetches; topk "
                f"wall {wall:.3f} s; "
                f"launches {calls}")
    return counts, dict(Q=Q, D=D, rep_ssax=rep_ssax, brute=brute,
                        results=results)


def same_answer(np, a, b) -> bool:
    """Two ``TopKResult``s agree bitwise: ids and distances."""
    return (np.array_equal(a.indices, b.indices)
            and np.array_equal(a.distances, b.distances))


def index_path(torch, np, dev, main):
    """Phase 4: the index path on phase 3's corpus, then its checks.
    Returns the kernels' launch counts during the path alone."""
    import tempfile
    from repro_torch.core.engine import MatchEngine
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.kernels.ops import make_pairwise
    from repro_torch.launch.match import make_engine
    from repro_torch.obs import check_trace, render_trace
    from repro_torch.store import SymbolicStore
    Q, D, brute, linear = main["Q"], main["D"], main["brute"], \
        main["results"]
    reset_launch_counts()

    def build(tech, data, rep=None):
        sync(torch, dev)
        t0 = time.perf_counter()
        engine = make_engine(tech, data, L=L, strength=STRENGTH,
                             batch=BATCH, verify="auto", rep=rep, device=dev)
        t_store = time.perf_counter() - t0
        t0 = time.perf_counter()
        engine.store.build_index(leaf_fill=LEAF_FILL)
        sync(torch, dev)
        return engine, t_store, time.perf_counter() - t0

    def call(engine, queries=Q, **kw):
        engine.store.reset()
        before = launch_counts()
        t0 = time.perf_counter()
        res = engine.topk(queries, **kw)
        wall = time.perf_counter() - t0
        return res, wall, {n: c - before[n] for n, c in
                           launch_counts().items()}

    engine, t_store, t_build = build("ssax", D, rep=main["rep_ssax"])
    idx = engine.store.index
    say(f"ssax index over {idx.n} rows: {idx.n_nodes} nodes (leaf_fill "
        f"{LEAF_FILL}) built in {t_build:.2f} s (features through K4 in "
        f"chunks of 8,192 rows, the tree on the host); store from phase "
        f"3's representation in {t_store:.2f} s")
    runs = {}
    for k in KS:
        runs["index", k] = call(engine, k=k, source="index")
        runs["linear", k] = call(engine, k=k)
    for src, source in (("index", "index"), ("linear", None)):
        runs[src + " traced", max(KS)] = call(engine, k=max(KS),
                                              source=source, explain=True)
    all_calls = list(runs.values())

    for (name, k), (res, wall, calls) in runs.items():
        bf_i, bf_d = brute["ssax"]
        if not (np.array_equal(res.indices, bf_i[:, :k]) and np.array_equal(
                res.distances, bf_d[:, :k].astype(np.float64))):
            fail(f"ssax {name} k={k}: differs from the K1 brute force")
        if not same_answer(np, res, linear["ssax", k][0]):
            fail(f"ssax {name} k={k}: differs from phase 3's linear answer")
    for src in ("index", "linear"):
        base, traced = runs[src, max(KS)], runs[src + " traced", max(KS)]
        (b, _, bc), (t, _, tc) = base, traced
        if not (same_answer(np, b, t) and bc == tc
                and np.array_equal(b.raw_accesses, t.raw_accesses)
                and (b.rounds, b.store_fetches, b.store_accesses)
                == (t.rounds, t.store_fetches, t.store_accesses)):
            fail(f"ssax {src} k={max(KS)}: the traced call differs from "
                 f"the untraced one ({tc} vs {bc} launches)")
        problems = check_trace(t.trace)
        if problems:
            fail(f"ssax {src} trace: {problems}")
        for line in render_trace(t.trace).splitlines():
            say(f"explain {src}: {line}")
    for k in KS:
        (ri, wi, ci), (rl, wl, cl) = runs["index", k], runs["linear", k]
        say(f"ssax N={idx.n} k={k}: indexed == linear == K1 brute force "
            f"bitwise; rows verified per query {ri.raw_accesses.mean():.1f}"
            f" indexed vs {rl.raw_accesses.mean():.1f} linear; rounds "
            f"{ri.rounds} vs {rl.rounds}; K1 launches {ci['euclid']} vs "
            f"{cl['euclid']}; topk wall {wi:.3f} s vs {wl:.3f} s; "
            f"launches {ci} vs {cl}")
    for src in ("index", "linear"):
        res, wall, calls = runs[src + " traced", max(KS)]
        tr = res.trace
        say(f"ssax {src} k={max(KS)} traced: topk wall {wall:.3f} s = "
            f"order {tr.span_seconds('order'):.3f} s (of which seed "
            f"{tr.span_seconds('seed'):.3f} s) + verify "
            f"{tr.span_seconds('verify'):.3f} s; equal to its untraced "
            f"call bitwise with the same launches {calls}; check_trace "
            f"clean")
    del engine

    # the other encoders, indexed over the first N_SMALL rows
    for tech in ("sax", "tsax", "stsax"):
        engine, _, t_build = build(tech, D[:N_SMALL])
        res = call(engine, k=max(KS), source="index")
        lin = call(engine, k=max(KS))
        all_calls += [res, lin]
        if not same_answer(np, res[0], lin[0]):
            fail(f"{tech} N={N_SMALL}: indexed differs from linear")
        if tech != "sax" and not same_answer(np, lin[0],
                                             linear[tech, max(KS)][0]):
            fail(f"{tech} N={N_SMALL}: linear differs from phase 3's")
        say(f"{tech} N={N_SMALL} k={max(KS)}: index of "
            f"{engine.store.index.n_nodes} nodes built in {t_build:.2f} s; "
            f"indexed == linear bitwise; rows verified per query "
            f"{res[0].raw_accesses.mean():.1f} vs "
            f"{lin[0].raw_accesses.mean():.1f}; rounds {res[0].rounds} vs "
            f"{lin[0].rounds}; topk wall {res[1]:.3f} s vs {lin[1]:.3f} s")
        del engine

    # a snapshot of an indexed sSAX store, reopened on the card
    engine, _, _ = build("ssax", D[:N_SMALL])
    store = engine.store
    want = [call(engine, k=max(KS), source=src)
            for src in ("index", None)]
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        path = store.save(tmp)
        t_save = time.perf_counter() - t0
        n_bytes = sum(f.stat().st_size for f in Path(path).iterdir())
        t0 = time.perf_counter()
        back = SymbolicStore.open(tmp, device=dev)
        t_open = time.perf_counter() - t0
    if back.device != store.device or not np.array_equal(back.data,
                                                          store.data):
        fail("snapshot: reopened raw rows differ")
    for a, b in zip(back.rep_view(), store.rep_view()):
        if not np.array_equal(a, b):
            fail("snapshot: reopened representation differs")
    (ma, xa), (mb, xb) = back.index.to_snapshot(), store.index.to_snapshot()
    if ma != mb or any(not np.array_equal(xa[k], xb[k]) for k in xb):
        fail("snapshot: reopened index differs")
    reopened = MatchEngine(back.encoder, back, batch_size=BATCH,
                           verify=engine.verify_mode,
                           pairwise=make_pairwise(back.encoder), device=dev)
    got = [call(reopened, k=max(KS), source=src) for src in ("index", None)]
    all_calls += want + got
    for (w, _, _), (g, _, _) in zip(want, got):
        if not (same_answer(np, w, g)
                and np.array_equal(w.raw_accesses, g.raw_accesses)):
            fail("snapshot: the reopened store answers differently")
    new_rows = D[N_SMALL:N_SMALL + 2]
    ids = reopened.append(new_rows)
    found = call(reopened, new_rows, k=1, source="index")
    all_calls.append(found)
    found = found[0]
    if back.index.n != back.n or list(found.indices[:, 0]) != list(ids):
        fail(f"snapshot: appended rows {list(ids)} were not indexed and "
             f"found ({list(found.indices[:, 0])})")
    say(f"snapshot of {store.n} ssax rows + index ({store.index.n_nodes} "
        f"nodes): {n_bytes} bytes saved in {t_save:.2f} s, opened on "
        f"{back.device} in {t_open:.2f} s; indexed and linear k={max(KS)} "
        f"answers bitwise equal after reopening; 2 rows appended after "
        f"reopening indexed ({back.index.n} of {back.n}) and found as "
        f"their own nearest neighbours")
    del engine, reopened, back, store

    counts = launch_counts()
    say(f"index path launches: {counts}")
    rounds_check("index path", all_calls, exact_fetch=True)
    sweep_check("index path", [c for (src, _), (_, _, c) in runs.items()
                               if src.startswith("linear")])
    return counts


def subseq_path(torch, np, dev):
    """Phase 5: the subsequence path, then its checks.  Returns the
    kernels' launch counts during the path alone."""
    from repro_torch.data.synthetic import season_dataset
    from repro_torch.kernels import launch_counts, reset_launch_counts
    from repro_torch.launch.match import (
        greedy_nonoverlap, make_subseq_engine, subseq_queries,
        window_distances)
    from repro_torch.subseq import WindowView

    t0 = time.perf_counter()
    D = season_dataset(SUB_ROWS, SUB_T, L, STRENGTH,
                       per_series_strength=True, seed=7)
    Q, q_rows, offs = subseq_queries(D, SUB_M, N_QUERIES,
                                     np.random.default_rng(7))
    extra = season_dataset(2, SUB_T, L, STRENGTH, seed=8)
    say(f"subsequence corpus {D.shape} f32 + {N_QUERIES} snippet queries "
        f"(m={SUB_M}) generated in {time.perf_counter() - t0:.1f} s")

    n_rows = {"ssax": SUB_ROWS, "sax": SUB_ROWS, "tsax": SUB_SMALL,
              "stsax": SUB_SMALL}
    results, scans, views, engines = {}, {}, {}, {}
    reset_launch_counts()
    for tech, n in n_rows.items():
        sync(torch, dev)
        t0 = time.perf_counter()
        view, engine = views[tech], engines[tech] = make_subseq_engine(
            tech, D[:n], m=SUB_M, stride=SUB_STRIDE, L=L, strength=STRENGTH,
            batch=BATCH, verify="auto", device=dev)
        sync(torch, dev)
        t_enc = time.perf_counter() - t0
        for k, excl in SUB_CALLS[tech]:
            view.reset()
            before = launch_counts()
            t0 = time.perf_counter()
            res = engine.topk(Q, k=k, exclusion=excl)
            wall = time.perf_counter() - t0
            calls = {c: v - before[c] for c, v in launch_counts().items()}
            results[tech, k, excl] = (res, wall, calls)
        before = launch_counts()
        t0 = time.perf_counter()
        scan = engine.scan_topk(Q, k=8)
        wall = time.perf_counter() - t0
        scans[tech] = (scan, wall, launch_counts()["windowed_euclid"]
                       - before["windowed_euclid"])
        say(f"{tech} subsequence view: {view.n} windows of {n} rows "
            f"encoded in {t_enc:.2f} s")
    # streaming: rows appended to the sSAX view are searchable at once
    t0 = time.perf_counter()
    views["ssax"].append(extra)
    t_app = time.perf_counter() - t0
    before = launch_counts()
    t0 = time.perf_counter()
    res_app = engines["ssax"].topk(extra[:1, 100:100 + SUB_M], k=1)
    t_app_q = time.perf_counter() - t0
    counts = launch_counts()
    say(f"subsequence path launches: {counts}")
    app_calls = {c: v - before[c] for c, v in counts.items()}
    rounds_check("subsequence path", [*results.values(), (
        res_app, None, app_calls)], exact_fetch=False)
    sweep_check("subsequence path", [
        c for (tech, _, _), (_, _, c) in results.items() if tech == "ssax"]
        + [app_calls])

    # where one sSAX k = 8 call's wall time goes (host clock, after the
    # counted run): the sweep, the host's stable argsort of the (Q,
    # n_windows) bounds, and the verification loop that is the rest
    engine = engines["ssax"]
    zq = engine.normalize_queries(Q)
    engine.topk(Q, k=8)                  # the appended rep is on the card
    sync(torch, dev)
    t0 = time.perf_counter()
    rd = engine.repr_distances(zq)
    t_sweep = time.perf_counter() - t0
    t0 = time.perf_counter()
    np.argsort(rd, axis=1, kind="stable")
    t_sort = time.perf_counter() - t0
    t0 = time.perf_counter()
    engine.topk(Q, k=8)
    t_all = time.perf_counter() - t0
    say(f"breakdown ssax {rd.shape[1]} windows k=8: topk {t_all:.3f} s = "
        f"sweep {t_sweep:.3f} s + host argsort {t_sort:.3f} s + "
        f"verification loop {t_all - t_sweep - t_sort:.3f} s")

    t0 = time.perf_counter()
    dist = window_distances(D, SUB_M, SUB_STRIDE, zq, dev)
    say(f"K1 brute force over {dist.shape[1]} windows in "
        f"{time.perf_counter() - t0:.1f} s")
    nw = views["ssax"].windows_per_row
    orders = {}
    for (tech, k, excl), (res, wall, calls) in results.items():
        nwin = n_rows[tech] * nw
        d = dist[:, :nwin]
        if nwin not in orders:
            orders[nwin] = np.argsort(d, axis=1, kind="stable")
        order = orders[nwin]
        if res.window_ids.shape != (N_QUERIES, k) or \
                not np.isfinite(res.distances).all() or \
                (res.window_ids < 0).any() or (res.window_ids >= nwin).any():
            fail(f"subseq {tech} k={k}: malformed result")
        want = np.stack([greedy_nonoverlap(order[qi], nw, SUB_STRIDE, k,
                                           excl) if excl else order[qi, :k]
                         for qi in range(N_QUERIES)])
        if not (np.array_equal(res.window_ids, want) and np.array_equal(
                res.distances, np.take_along_axis(d, want, 1).astype(
                    np.float64))):
            fail(f"subseq {tech} k={k} exclusion={excl}: exact top-k "
                 f"differs from the K1 brute force over all windows")
        loc = sum(int(res.rows[qi, 0] == q_rows[qi]
                      and abs(res.starts[qi, 0] - offs[qi]) < SUB_M)
                  for qi in range(N_QUERIES))
        say(f"subseq {tech} {nwin} windows k={k}"
            + (f" exclusion={excl}" if excl else "")
            + f": exact == K1 brute force bitwise; snippet localized "
            f"{loc}/{N_QUERIES}; windows/query verified "
            f"{res.raw_accesses.mean():.1f}, pruned fraction "
            f"{res.pruned_fraction.mean():.6f}, {res.rounds} rounds, rows "
            f"read "
            f"{res.store_accesses}/{n_rows[tech]}, modeled ssd I/O "
            f"{res.io_seconds * 1e3:.3f} ms; topk wall {wall:.3f} s; "
            f"launches {calls}")
    for tech, (scan, wall, n_launch) in scans.items():
        res = results[tech, 8, 0][0]
        d = dist[:, :n_rows[tech] * nw]
        order = orders[d.shape[1]]
        compared = 0
        for qi in range(N_QUERIES):
            dk, dk1 = d[qi, order[qi, 7]], d[qi, order[qi, 8]]
            if dk1 - dk <= 1e-3 * dk:
                continue                      # near-tie at the k boundary
            compared += 1
            if set(scan.window_ids[qi]) != set(res.window_ids[qi]):
                fail(f"subseq {tech} query {qi}: K5 scan ids differ from "
                     f"the exact top-k")
        check(f"subseq {tech} K5 scan distances^2",
              torch.as_tensor(scan.distances ** 2),
              torch.as_tensor(res.distances ** 2), TOL["windowed_euclid"])
        say(f"subseq {tech} K5 scan_topk k=8: ids == exact on {compared}/"
            f"{N_QUERIES} queries (others near-tied), d^2 within 1e-3; "
            f"{n_launch} K5 launches; scan wall {wall:.3f} s; modeled ssd "
            f"I/O {scan.io_seconds * 1e3:.3f} ms")
    if res_app.rows[0, 0] != SUB_ROWS:
        fail(f"subseq: a snippet of appended row {SUB_ROWS} was found in "
             f"row {res_app.rows[0, 0]}")
    say(f"subseq append: 2 rows (+{2 * nw} windows) in {t_app:.2f} s; a "
        f"snippet of row {SUB_ROWS} found there at start "
        f"{res_app.starts[0, 0]} (d={res_app.distances[0, 0]:.3g}) in "
        f"{t_app_q:.2f} s")

    # incremental == one-shot window encoding on the card, bitwise
    enc = views["ssax"].encoder
    one = WindowView(enc, D[:10], stride=SUB_STRIDE, device=dev)
    inc = WindowView(enc, stride=SUB_STRIDE, encode_chunk=57, device=dev)
    for lo, hi in ((0, 3), (3, 7), (7, 10)):
        inc.append(D[lo:hi])
    big = [a[:one.n] for a in views["ssax"].rep_view()]
    for a, b, c in zip(inc.rep_view(), one.rep_view(), big):
        if not (np.array_equal(a, b) and np.array_equal(a, c)):
            fail("subseq: chunked window encoding differs from one-shot")
    say(f"subseq incremental == one-shot window reps on the card "
        f"({one.n} windows; chunks of 3/4/3 rows, encode_chunk 57)")
    return counts


def rounds_check(path: str, calls, exact_fetch: bool):
    """One gathered K1 launch per verification round: every topk call's
    K1 launches must equal its rounds.  On whole series every round is
    one store fetch; over windows a round whose rows all sit in the row
    buffer bills none, so there fetches <= rounds."""
    launches = fetches = rounds = 0
    for res, _, c in calls:
        launches += c["euclid"]
        fetches += res.store_fetches
        rounds += res.rounds
        if c["euclid"] != res.rounds or res.store_fetches > res.rounds or (
                exact_fetch and res.store_fetches != res.rounds):
            fail(f"{path}: a topk call made {c['euclid']} K1 launches in "
                 f"{res.rounds} verification rounds with "
                 f"{res.store_fetches} store fetches")
    say(f"{path}: K1 launches {launches} == verification rounds {rounds}; "
        f"store fetches {fetches}")


def sweep_check(path: str, calls):
    """One batched K2 launch per sSAX sweep: every sSAX topk call sweeps
    all its queries once, so it must make exactly one K2 launch."""
    launches = [c["ssax_dist"] for c in calls]
    if any(n != 1 for n in launches):
        fail(f"{path}: sSAX topk calls made {launches} K2 launches, not one "
             f"each")
    say(f"{path}: K2 launches {sum(launches)} == sSAX sweep calls "
        f"{len(launches)}")


def plain_bruteforce(torch, np, ref, Q, D, dev):
    """(Q, N) f32 distances through the plain version of K1."""
    step = 1 << 18
    q = torch.as_tensor(Q).to(dev)
    out = np.empty((Q.shape[0], D.shape[0]), np.float32)
    for lo in range(0, D.shape[0], step):
        x = torch.as_tensor(D[lo:lo + step]).to(dev)
        d2 = torch.stack([ref.euclid_ref(x, qi) for qi in q])
        out[:, lo:lo + step] = d2.cpu().numpy()
    return np.sqrt(np.maximum(out, 0.0))


def card_label() -> str:
    """The card's name and power limit, as nvidia-smi gives them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main():
    root = Path(__file__).resolve().parent
    if not (root / "src" / "repro_torch" / "kernels" / "csrc").is_dir():
        fail("the repository's src/repro_torch is not beside this script")
    sys.path.insert(0, str(root / "src"))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        fail("no CUDA card is available")
    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_all = time.perf_counter()

    from repro_torch.kernels import _lib, ops, ref
    say(f"torch {torch.__version__} (CUDA {torch.version.cuda}) on "
        f"{torch.cuda.get_device_name(0)}; every time below is on this "
        f"card: {card_label()}")
    _lib.load()
    say(f"phase 1: kernels built from {_lib.CSRC.relative_to(root)} in "
        f"{_lib.build_seconds():.1f} s -> {_lib.library_path().parent}")
    if sys.argv[1:] in (["--k5"], ["--k2"], ["--split"]):
        if sys.argv[1] == "--k5":
            k5_shapes(torch, ops, ref, dev)
        elif sys.argv[1] == "--k2":
            k2_shapes(torch, ops, ref, *random_makers(torch, dev, 0))
            k2_scaling(torch, ops, dev)
        else:
            split_only(torch, np, dev)
        return

    t0 = time.perf_counter()
    rows = kernel_phase(torch, ops, ref, dev)
    say(f"phase 2: kernels agree with their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    counts, main = main_path(torch, np, dev)
    say(f"phase 3: main path exact ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    idx_counts = index_path(torch, np, dev, main)
    del main
    say(f"phase 4: index path exact ({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    sub_counts = subseq_path(torch, np, dev)
    say(f"phase 5: subsequence path exact ({time.perf_counter() - t0:.1f} "
        f"s)")

    for path, c, names in (("main", counts, MAIN_KERNELS),
                           ("index", idx_counts, MAIN_KERNELS),
                           ("subsequence", sub_counts, tuple(sub_counts))):
        missing = [n for n in names if c[n] <= 0]
        if missing:
            fail(f"kernels never launched on the {path} path: {missing}")
    kernels = []
    for name in (*MAIN_KERNELS, "windowed_euclid"):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name],
            "launches": counts[name] + idx_counts[name] + sub_counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    say(f"phase 6: every kernel launched on its paths; total "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)

    print(card_label(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
