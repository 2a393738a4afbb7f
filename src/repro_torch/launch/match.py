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
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch


def make_engine(technique: str, D: np.ndarray, *, L: int = 10,
                strength: float = 0.7, batch: int = 256,
                store: str = "ssd", verify: str = "auto", device="cuda"):
    """A ``MatchEngine`` over a ``RawStore`` of ``D`` with the launcher's
    encoder (W=48) and the kernel sweep for SAX / sSAX."""
    from repro_torch.core.engine import MatchEngine
    from repro_torch.core.matching import MEDIA, RawStore
    from repro_torch.core.techniques import make_technique
    from repro_torch.kernels.ops import make_pairwise
    tech = make_technique(technique, T=D.shape[1], W=48, L=L,
                          r2_season=strength)
    return MatchEngine(tech, RawStore(D, *MEDIA[store]), batch_size=batch,
                       verify=verify, pairwise=make_pairwise(tech),
                       device=device)


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
    ap.add_argument("--dryrun", action="store_true",
                    help="shrink every dimension to a seconds-scale smoke")
    args = ap.parse_args(argv)

    if args.dryrun:
        args.n = min(args.n, 256)
        args.T = min(args.T, 480)
        args.queries = min(args.queries, 4)
        args.k = min(args.k, 8)
        args.batch = min(args.batch, 64)

    from repro_torch.core.engine import resolve_device
    from repro_torch.data.synthetic import season_corpus
    device = resolve_device(args.device)
    X = season_corpus(args.n + args.queries, args.T, args.L, args.strength,
                      per_series_strength=True, seed=1)
    Q, D = X[:args.queries], X[args.queries:]

    print(f"[match] {args.technique} over {args.n} x {args.T} on {device} "
          f"(verify={args.verify})")
    t0 = time.perf_counter()
    engine = make_engine(args.technique, D, L=args.L,
                         strength=args.strength, batch=args.batch,
                         store=args.store, verify=args.verify,
                         device=device)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"[match] encode: {time.perf_counter() - t0:.2f}s")

    true_i, true_d = kernel_bruteforce(Q, D, max(1, args.k), device)

    # exact top-k through the pruned batched scan
    for k in (1, args.k):
        engine.store.reset()
        t0 = time.perf_counter()
        res = engine.topk(Q, k=k)
        dt = time.perf_counter() - t0
        hits = sum(int(np.array_equal(res.indices[qi], true_i[qi, :k]))
                   for qi in range(args.queries))
        acc = res.raw_accesses.mean()
        print(f"[match] exact k={k}: {hits}/{args.queries} query frontiers "
              f"== brute force; raw rows/query {acc:.0f} "
              f"({acc / args.n:.2%} of dataset), {res.store_fetches} "
              f"batched fetches; modeled {args.store} I/O "
              f"{res.io_seconds:.3f}s; wall {dt:.2f}s")

    # approximate top-k from the representation frontier
    engine.store.reset()
    t0 = time.perf_counter()
    res = engine.topk(Q, k=args.k, exact=False)
    dt = time.perf_counter() - t0
    hit1 = sum(int(res.indices[qi, 0] == true_i[qi, 0])
               for qi in range(args.queries))
    print(f"[match] approx k={args.k}: 1-NN hit {hit1}/{args.queries}; "
          f"raw rows/query {res.raw_accesses.mean():.0f}; modeled "
          f"{args.store} I/O {res.io_seconds:.3f}s; wall {dt:.2f}s")


if __name__ == "__main__":
    main()
