"""Plain reference of exact k-NN under Euclidean distance, and the
comparison that decides ``correct``.

The reference is a brute force over every corpus row in float64, fed the
benchmark's own corpus chunk by chunk (made again from the seed) and the
benchmark's own queries: nothing the program made.  It imports neither
JAX nor anything of the program.

``judge`` holds the served answers to it.  The number compared is
``nn_err``: for each answer and each rank j of its k, how far the served
distance, or the served row's true distance, lies from the true j-th
nearest distance, relative to that distance; the largest over every
answer compared.  A row id outside the corpus, or an id served twice in
one answer, reads infinite.  ``unserved`` counts the requests that never
came back or came back with an error.

``control_answers`` is the control: the same brute force in TF32 (each
input rounded to TF32's 10-bit mantissa, as the tensor cores take it,
products accumulated in float32), one precision below the float32 that
the configurations state.
"""

from __future__ import annotations

import math

import numpy as np
import torch

Q_BLOCK = 512            # queries per block of the brute force


def to_tf32(x: torch.Tensor) -> torch.Tensor:
    """Round f32 values to TF32 (10 mantissa bits), nearest even."""
    bits = x.contiguous().view(torch.int32)
    lsb = (bits >> 13) & 1
    bits = (bits + 0x0FFF + lsb) & ~0x1FFF
    return bits.view(torch.float32)


class Scan:
    """One pass over the corpus chunks for a fixed set of queries.

    ``best`` / ``best_id``: the running k nearest squared distances and
    rows per query, ascending, in float64 (in TF32 for the control).
    ``pair_d2``: the float64 squared distance of given (query, row id)
    pairs, taken as their chunk passes."""

    def __init__(self, queries: np.ndarray, k: int, device, *,
                 tf32: bool = False, pairs=None):
        self.device = torch.device(device)
        self.tf32 = tf32
        q = torch.as_tensor(np.asarray(queries, np.float32),
                            device=self.device)
        self.q = to_tf32(q) if tf32 else q.double()
        self.q_sq = self.q.square().sum(1)
        n_q = q.shape[0]
        self.best = torch.full((n_q, k), math.inf, dtype=torch.float64,
                               device=self.device)
        self.best_id = torch.full((n_q, k), -1, dtype=torch.int64,
                                  device=self.device)
        self.offset = 0
        self.pair_q = None
        if pairs is not None:
            qi, ids = (np.asarray(a, np.int64) for a in pairs)
            self.pair_q = torch.as_tensor(qi, device=self.device)
            self.pair_id = torch.as_tensor(ids, device=self.device)
            self.pair_d2 = torch.full((len(qi),), math.nan,
                                      dtype=torch.float64,
                                      device=self.device)

    def feed(self, chunk: torch.Tensor) -> None:
        """Rows ``offset .. offset + len(chunk)`` of the corpus."""
        x = chunk.to(self.device)
        m, k = x.shape[0], self.best.shape[1]
        x = to_tf32(x) if self.tf32 else x.double()
        x_sq = x.square().sum(1)
        for lo in range(0, self.q.shape[0], Q_BLOCK):
            hi = lo + Q_BLOCK
            q = self.q[lo:hi]
            if self.tf32:
                with _tf32_matmul():
                    dot = x @ q.T
            else:
                dot = x @ q.T
            d2 = x_sq[:, None] + self.q_sq[None, lo:hi] - 2.0 * dot
            val, arg = d2.topk(min(k, m), dim=0, largest=False)
            val = torch.cat([self.best[lo:hi], val.T.double()], 1)
            ids = torch.cat([self.best_id[lo:hi], arg.T + self.offset], 1)
            val, pick = val.topk(k, dim=1, largest=False)
            self.best[lo:hi] = val
            self.best_id[lo:hi] = ids.gather(1, pick)
        if self.pair_q is not None:
            here = (self.pair_id >= self.offset) & \
                (self.pair_id < self.offset + m)
            if bool(here.any()):
                sel = here.nonzero()[:, 0]
                rows = chunk.to(self.device)[self.pair_id[sel]
                                             - self.offset].double()
                qs = self.q[self.pair_q[sel]].double()
                self.pair_d2[sel] = (rows - qs).square().sum(1)
        self.offset += m


class _tf32_matmul:
    """Let float32 matrix products run on TF32 tensor cores (the card)."""

    def __enter__(self):
        self.old = torch.backends.cuda.matmul.allow_tf32
        torch.backends.cuda.matmul.allow_tf32 = True

    def __exit__(self, *exc):
        torch.backends.cuda.matmul.allow_tf32 = self.old


def reference(chunks, queries: np.ndarray, served_ids: np.ndarray, device):
    """Brute force: per query (row of ``served_ids``, (Q, k)) the true k
    nearest distances, and the true distance of each row served for it
    (NaN for an id outside the corpus).  ``chunks`` yields the corpus in
    row order.  Returns (best (Q, k), served (Q, k), rows seen)."""
    ids = np.asarray(served_ids, np.int64)
    q_n, k = ids.shape
    scan = Scan(queries, k, device,
                pairs=(np.repeat(np.arange(q_n), k), ids.reshape(-1)))
    for c in chunks:
        scan.feed(c)
    best = scan.best.clamp_min(0).sqrt().cpu().numpy()
    served = scan.pair_d2.clamp_min(0).sqrt().cpu().numpy().reshape(q_n, k)
    return best, served, scan.offset


def control_answers(chunks, queries: np.ndarray, k: int, device):
    """The control in the program's place: k-NN ids and distances, (Q,
    k) each, of the brute force in TF32."""
    scan = Scan(queries, k, device, tf32=True)
    for c in chunks:
        scan.feed(c)
    return (scan.best_id.cpu().numpy(),
            scan.best.clamp_min(0).sqrt().cpu().numpy())


def nn_err(ids, dists, best, served_true, n_rows: int) -> np.ndarray:
    """Per answer, (N, k) each: the largest over ranks j of max(|served
    distance - true distance of its row|, true distance of its row - true
    j-th nearest distance) / true j-th nearest distance; +inf for an id
    outside the corpus or served twice in one answer."""
    ids = np.asarray(ids, np.int64)
    dists = np.asarray(dists, np.float64)
    best = np.asarray(best, np.float64)
    served_true = np.asarray(served_true, np.float64)
    srt = np.sort(ids, axis=1)
    twice = (srt[:, 1:] == srt[:, :-1]).any(axis=1)
    bad = ((ids < 0) | (ids >= n_rows) | ~np.isfinite(dists)
           | ~np.isfinite(served_true)).any(axis=1) | twice
    err = np.maximum(np.abs(dists - served_true), served_true - best)
    err = (err / np.maximum(best, np.finfo(np.float64).tiny)).max(axis=1)
    return np.where(bad, np.inf, err)


def judge(answers, attempted: int, chunks, queries: np.ndarray, limits,
          n_rows: int, device) -> dict:
    """``answers``: (query row, ids (k,), distances (k,)) of every request
    that came back served; ``attempted``: requests that were due.
    Returns the numbers compared, each with its limit, and ``correct``."""
    worst = math.inf
    if answers:
        qi = np.asarray([a[0] for a in answers], np.int64)
        ids = np.stack([np.asarray(a[1], np.int64) for a in answers])
        dists = np.stack([np.asarray(a[2], np.float64) for a in answers])
        # one brute force per distinct (query, served ids)
        uniq, inv = np.unique(np.concatenate([qi[:, None], ids], 1),
                              axis=0, return_inverse=True)
        inv = np.asarray(inv).reshape(-1)
        best, served, seen = reference(chunks, queries[uniq[:, 0]],
                                       uniq[:, 1:], device)
        if seen != n_rows:
            raise RuntimeError(f"reference saw {seen} rows, corpus has "
                               f"{n_rows}")
        worst = float(nn_err(ids, dists, best[inv], served[inv],
                             n_rows).max())
    checks = {
        "nn_err": {"value": worst, "limit": float(limits["nn_err"])},
        "unserved": {"value": int(attempted - len(answers)), "limit": 0},
    }
    correct = (worst <= checks["nn_err"]["limit"]
               and checks["unserved"]["value"] <= 0)
    return {"correct": bool(correct), "checks": checks}
