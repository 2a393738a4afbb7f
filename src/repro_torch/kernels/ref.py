"""Plain PyTorch versions of the five kernels, K1 and K2 with both their
entries (the allclose ground truth), and the explicit-window sliding dot
product the FFT path of ``kernels.fft_dot`` is held against.

Each mirrors its counterpart in the JAX package's ``kernels/ref.py``.
A wrapper runs these for CPU tensors; the CPU tests hold them against
the JAX package, and ``chip_smoke.py`` holds each CUDA kernel against
them on the card.  Nothing on the main path calls them when a card is
present."""

from __future__ import annotations

import torch


def sax_dist_ref(symbols, query_table):
    """SAX MINDIST^2 sweep.

    symbols: (N, W) int dataset symbols; query_table: (W, A) f32 with
    query_table[w, a] = cell(q_w, a)^2 (query-conditioned squared cells).
    Returns (N,) f32 = sum_w query_table[w, symbols[:, w]].
    """
    w_idx = torch.arange(symbols.shape[1], device=symbols.device)[None, :]
    return query_table[w_idx, symbols.long()].sum(-1)


def ssax_dist_ref(seas_syms, res_syms, t1, t2, u1, u2):
    """sSAX cell^2 sweep (Eq. 20 collapsed to max form).

    seas_syms: (N, L) int; res_syms: (N, W) int.
    t1/t2: (L, A_seas) query-conditioned season terms
        t1[l, a] = lower(q_l) - upper(a),  t2[l, a] = lower(a) - upper(q_l)
    u1/u2: (W, A_res) residual terms, same construction.
    Returns (N,) f32 = sum_{l,w} max(0, c1_l + d1_w, c2_l + d2_w)^2.
    """
    l_idx = torch.arange(t1.shape[0], device=seas_syms.device)[None, :]
    w_idx = torch.arange(u1.shape[0], device=res_syms.device)[None, :]
    s, r = seas_syms.long(), res_syms.long()
    c1, c2 = t1[l_idx, s], t2[l_idx, s]              # (N, L)
    d1, d2 = u1[w_idx, r], u2[w_idx, r]              # (N, W)
    cell = torch.clamp_min(torch.maximum(c1[:, :, None] + d1[:, None, :],
                                         c2[:, :, None] + d2[:, None, :]),
                           0.0)
    return cell.square().sum(dim=(1, 2))


def ssax_dist_batch_ref(seas_syms, res_syms, t1, t2, u1, u2):
    """:func:`ssax_dist_ref` for Q queries: (Q, L, A_seas) ``t1``/``t2``
    and (Q, W, A_res) ``u1``/``u2`` -> (Q, N) f32, each row that query's
    :func:`ssax_dist_ref`."""
    if not t1.shape[0]:
        return torch.empty((0, seas_syms.shape[0]), dtype=torch.float32,
                           device=seas_syms.device)
    return torch.stack([ssax_dist_ref(seas_syms, res_syms, *tabs)
                        for tabs in zip(t1, t2, u1, u2)])


def paa_ref(x, n_segments: int):
    """(N, T) -> (N, W) f32 segment means."""
    N, T = x.shape
    return x.reshape(N, n_segments, T // n_segments).to(
        torch.float32).mean(-1)


def euclid_ref(x, q):
    """(N, T) vs (T,) -> (N,) f32 squared Euclidean distances."""
    d = x.to(torch.float32) - q.to(torch.float32)[None, :]
    return d.square().sum(-1)


def euclid_gather_ref(rows, q, gather):
    """(U, T) rows, (Qa, T) queries, (Qa, B) int64 gather -> (Qa, B) f32:
    each query's :func:`euclid_ref` over its own gathered rows."""
    if not q.shape[0]:
        return torch.empty(tuple(gather.shape), dtype=torch.float32)
    return torch.stack([euclid_ref(rows[g], qi)
                        for g, qi in zip(gather, q)])


def sliding_dot_ref(x, q, stride: int = 1):
    """(N, T) rows vs (Q, m) queries -> (Q, N, S) f32 sliding dot
    products ``sum_i x[n, s*stride + i] * q[qi, i]``, windows
    materialized explicitly — the ground truth for both dot-product
    paths of ``kernels.fft_dot``."""
    m = q.shape[-1]
    w = x.to(torch.float32).unfold(1, m, stride)              # (N, S, m)
    return torch.einsum("nsm,qm->qns", w, q.to(torch.float32))


def windowed_euclid_ref(x, q, stride: int = 1):
    """(N, T) raw rows vs (Q, m) z-normalized queries -> (Q, N, S)
    squared distances to every z-normalized length-m window at
    ``stride`` (S = (T - m) // stride + 1), windows materialized
    explicitly as (Q, N, S, m)."""
    from repro_torch.core.normalize import znormalize
    m = q.shape[-1]
    w = znormalize(x.to(torch.float32).unfold(1, m, stride))  # (N, S, m)
    d = w[None] - q.to(torch.float32)[:, None, None, :]
    return d.square().sum(-1)
