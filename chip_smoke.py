#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one card.

    python3 chip_smoke.py

Phases, each failing loudly with a nonzero exit:

1. Build the hand-written CUDA kernels from ``src/repro_torch/kernels/
   csrc`` (nvcc, sm_90a) and print the build seconds.
2. Hold each kernel (K1 euclid, K2 ssax_dist, K3 sax_dist, K4 paa)
   against its plain PyTorch version on the card at the main path's
   shapes plus a ragged one; time the kernel, the plain version and,
   where one exists, a single PyTorch call computing the same function.
3. Drive the main path through the launcher's ``make_engine`` and
   ``MatchEngine.topk``: sSAX and SAX exact top-k (k = 1, 32) over a
   1,000,000 x 960 season corpus, tSAX and stSAX over its first 65,536
   rows, ``verify="auto"``.  Every exact answer must equal a K1 brute
   force bitwise, and its ids a plain-version brute force away from
   near-ties.
4. Print the launch count of every kernel during phase 3 (each > 0) in
   the ``{"kernels": [...]}`` line.
5. Print the card's name and power limit, then the result line.

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

N_MAIN = 1_000_000            # corpus rows for sSAX / SAX
N_SMALL = 65_536              # corpus rows for tSAX / stSAX
T, W, L, STRENGTH = 960, 48, 10, 0.7
N_QUERIES, KS, BATCH = 8, (1, 32), 256
TOL = {"euclid": 1e-4, "euclid_bf16": 5e-2, "ssax_dist": 1e-4,
       "sax_dist": 1e-5, "paa": 1e-5, "paa_bf16": 2e-2}
REPLACES = {
    "euclid": "src/repro/kernels/euclid.py:75",
    "ssax_dist": "src/repro/kernels/ssax_dist.py:58",
    "sax_dist": "src/repro/kernels/sax_dist.py:50",
    "paa": "src/repro/kernels/paa.py:42",
}


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


def kernel_phase(torch, ops, ref, dev):
    """Phase 2: every kernel against its plain version, with times."""
    g = torch.Generator(device=dev).manual_seed(0)
    rows = {}

    def randint(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=dev,
                             dtype=torch.int32)

    def randn(*shape):
        return torch.randn(*shape, generator=g, device=dev)

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

    # K2 ssax_dist at the sweep shape (one query) and ragged
    As, Ar = 16, 32
    args = (randint(As, (N_MAIN, L)), randint(Ar, (N_MAIN, W)),
            randn(L, As), randn(L, As), randn(W, Ar), randn(W, Ar))
    err = check("ssax_dist", ops.ssax_dist(*args), ref.ssax_dist_ref(*args),
                TOL["ssax_dist"])
    rag = (randint(As, (300, L)), randint(Ar, (300, 17)), randn(L, As),
           randn(L, As), randn(17, Ar), randn(17, Ar))
    err = max(err, check("ssax_dist ragged", ops.ssax_dist(*rag),
                         ref.ssax_dist_ref(*rag), TOL["ssax_dist"]))
    rows["ssax_dist"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.ssax_dist(*args), 50),
        plain_ms=time_ms(torch, lambda: ref.ssax_dist_ref(*args), 5),
        library_ms=None,
        bound=bound_ms(N_MAIN * (L + W) * 4 + 2 * (L * As + W * Ar) * 4
                       + N_MAIN * 4, 6 * N_MAIN * L * W),
        shape=f"seas ({N_MAIN}, {L}), res ({N_MAIN}, {W}) i32")
    del args

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
    rows["euclid"] = dict(
        max_abs_err=err,
        ms=time_ms(torch, lambda: ops.euclid_batch(xv, qv), 200),
        plain_ms=time_ms(torch, lambda: plain_euclid(xv, qv), 200),
        library_ms=time_ms(torch, lambda: torch.cdist(qv, xv) ** 2, 200),
        bound=bound_ms(BATCH * T * 4 + T * 4 + BATCH * 4, 3 * BATCH * T),
        shape=f"x ({BATCH}, {T}) f32, q (1, {T})")
    for name, r in rows.items():
        say(f"kernel {name} [{r['shape']}]: {r['ms']:.4f} ms, plain "
            f"{r['plain_ms']:.4f} ms, library {r['library_ms']}, bound "
            f"{r['bound'][0]:.4f} ms ({r['bound'][1]}), max abs err "
            f"{r['max_abs_err']:.3g}")
    return rows


def main_path(torch, np, dev):
    """Phase 3: the port's main path, then its checks.  Returns the
    kernels' launch counts during the path alone."""
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

    # where one topk call's wall time goes (host clock; after the counted
    # run): the sweep (query encode, one K2/K3 launch per query, bounds to
    # the host), the host's stable argsort of the (Q, N) bounds, and the
    # verification loop (fetch, K1, merge) that is the rest
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
    engines.clear()

    for tech, data in plan:
        n = data.shape[0]
        bf_i, bf_d = kernel_bruteforce(Q, data, max(KS) + 1, dev)
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
                f"{res.store_fetches} fetches; topk wall {wall:.3f} s; "
                f"launches {calls}")
    return counts


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
        f"{torch.cuda.get_device_name(0)}")
    _lib.load()
    say(f"phase 1: kernels built from {_lib.CSRC.relative_to(root)} in "
        f"{_lib.build_seconds():.1f} s -> {_lib.library_path().parent}")

    t0 = time.perf_counter()
    rows = kernel_phase(torch, ops, ref, dev)
    say(f"phase 2: kernels agree with their plain versions "
        f"({time.perf_counter() - t0:.1f} s)")

    t0 = time.perf_counter()
    counts = main_path(torch, np, dev)
    say(f"phase 3: main path exact ({time.perf_counter() - t0:.1f} s)")

    missing = [n for n, c in counts.items() if c <= 0]
    if missing:
        fail(f"kernels never launched on the main path: {missing}")
    kernels = []
    for name in ("euclid", "ssax_dist", "sax_dist", "paa"):
        r = rows[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{name}.cu",
            "replaces": REPLACES[name], "launches": counts[name],
            "max_abs_err": r["max_abs_err"], "ms": r["ms"],
            "plain_ms": r["plain_ms"], "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r["library_ms"]})
    say(f"phase 4: every kernel launched on the main path; total "
        f"{time.perf_counter() - t_all:.1f} s")
    print(json.dumps({"kernels": kernels}), flush=True)

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode or not smi.stdout.strip():
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
