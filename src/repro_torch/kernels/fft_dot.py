"""MASS-style FFT sliding dot product + windowed distance expansion.

``kernels/windowed_euclid.py`` (K5) computes the sliding dot product of
a z-normalized query against every corpus window in ``m`` accumulation
steps inside the kernel — O(T * m) per row.  This module is the other
half of MASS (Mueen et al.): the same dot products through one
rfft/irfft convolution — O(T log T) per row, independent of ``m``.  It
is not a hand-written kernel: the transform is ``torch.fft`` (cuFFT on
a card) on the caller's device, and the dot products feed the same
rolling-statistics distance expansion as the kernel (one cumulative sum
-> window sum / sum-of-squares, the ``EPS``-clamped sigma of
``core.normalize.znormalize``, the zero-variance guard, the final clamp
at 0) — only the dot-product computation differs between the two
paths.

Tolerance contract
------------------
The FFT path is NOT bitwise-identical to the m-step accumulation: an
f32 length-``nfft`` transform reorders the reduction and carries
rounding of order ``eps * log(nfft)`` relative to the operand scale.
Against the accumulation paths (K5, its plain version
``kernels.ref.windowed_euclid_ref``, and the JAX package's FFT path),
squared distances agree within

    allclose(rtol=FFT_RTOL, atol=FFT_ATOL_PER_M * m)

(:func:`fft_tolerance`) — the absolute tolerance scales with ``m``
because z-normalized squared distances live in [0, ~4m].  Exact top-k
verification never consumes FFT distances: the engines verify through
K1.
"""

from __future__ import annotations

import torch

from repro_torch.kernels.windowed_euclid import EPS, n_windows

#: Documented agreement of the FFT distance path vs the m-step
#: accumulation (see module docstring).
FFT_RTOL = 1e-3
FFT_ATOL_PER_M = 1e-4


def fft_tolerance(m: int) -> dict:
    """``np.allclose`` kwargs of the documented FFT-vs-accumulation
    contract for window length ``m``."""
    return dict(rtol=FFT_RTOL, atol=FFT_ATOL_PER_M * float(m))


def _next_pow2(n: int) -> int:
    return 1 << (int(n) - 1).bit_length()


def _operands(x, q):
    """f32 tensors on ``x``'s device (numpy inputs land on the CPU)."""
    x = torch.as_tensor(x, dtype=torch.float32)
    return x, torch.as_tensor(q, dtype=torch.float32, device=x.device)


def sliding_dot_fft(x, q, stride: int = 1):
    """(N, T) rows x (Q, m) queries -> (Q, N, S) sliding dot products
    ``dot[qi, n, s] = sum_i x[n, s*stride + i] * q[qi, i]`` via one
    rfft/irfft linear correlation per (query, row) pair."""
    x, q = _operands(x, q)
    T, m = x.shape[-1], q.shape[-1]
    S = n_windows(T, m, stride)
    # linear (non-circular) correlation needs T + m - 1 samples; a power
    # of two keeps the transform on cuFFT's fastest plans
    nfft = _next_pow2(T + m - 1)
    fx = torch.fft.rfft(x, n=nfft, dim=-1)                  # (N, F)
    fq = torch.fft.rfft(q.flip(-1), n=nfft, dim=-1)         # (Q, F)
    conv = torch.fft.irfft(fq[:, None, :] * fx[None, :, :], n=nfft,
                           dim=-1)                          # (Q, N, nfft)
    # full convolution with the reversed query: the correlation at
    # window start s sits at output position m - 1 + s
    starts = m - 1 + torch.arange(S, device=x.device) * stride
    return conv[..., starts]


def sliding_dot_accum(x, q, stride: int = 1):
    """The m-step accumulation twin of :func:`sliding_dot_fft`: K5's
    inner loop as a plain loop of tensor ops (O(T * m) per row)."""
    x, q = _operands(x, q)
    N, T = x.shape
    Q, m = q.shape
    S = n_windows(T, m, stride)
    span = (S - 1) * stride + 1          # span - 1 + m <= T: no padding
    acc = torch.zeros((Q, N, S), dtype=torch.float32, device=x.device)
    for i in range(m):
        acc = acc + q[:, i][:, None, None] * x[None, :, i:i + span:stride]
    return acc


def _window_stats(x, m: int, stride: int, S: int):
    """Rolling per-window sum / sum-of-squares via one cumulative sum
    each — the same O(1)-per-window statistics the kernel computes from
    its slab."""
    zero = torch.zeros((x.shape[0], 1), dtype=torch.float32, device=x.device)
    cs1 = torch.cat([zero, torch.cumsum(x, dim=1)], dim=1)
    cs2 = torch.cat([zero, torch.cumsum(x * x, dim=1)], dim=1)
    lo = torch.arange(S, device=x.device) * stride
    s1 = cs1[:, lo + m] - cs1[:, lo]                        # (N, S)
    s2 = cs2[:, lo + m] - cs2[:, lo]
    return s1, s2


def _expand_distance(dot, s1, s2, q, m: int):
    """The windowed kernel's distance expansion applied to externally
    computed sliding dot products: with window mean mu and EPS-clamped
    sigma,

        d2 = sum(q^2) + (s2 - m*mu^2)/sig^2 - 2*(dot - mu*sum(q))/sig

    zero-variance windows z-normalize to the zero vector, so their
    distance is exactly ``sum(q^2)``; the result clamps at 0."""
    mu = s1 / m
    var = s2 / m - mu * mu
    sig = torch.clamp_min(torch.sqrt(torch.clamp_min(var, 0.0)), EPS)
    q_sum = q.sum(dim=1)[:, None, None]                     # (Q, 1, 1)
    q_ss = (q * q).sum(dim=1)[:, None, None]
    norm2 = torch.clamp_min(s2 - m * mu * mu, 0.0) / (sig * sig)
    d2 = q_ss + norm2[None] - 2.0 * (dot - mu[None] * q_sum) / sig[None]
    d2 = torch.where(var[None] > 0.0, d2, q_ss)
    return torch.clamp_min(d2, 0.0)


def windowed_euclid_fft(x, q, stride: int = 1):
    """FFT twin of K5 (``kernels.windowed_euclid``): (N, T) raw rows vs
    (Q, m) z-normalized queries -> (Q, N, S) squared z-normalized window
    distances, dot products via :func:`sliding_dot_fft`, the rest of the
    expansion the kernel's.  Agreement with the accumulation paths is
    governed by :func:`fft_tolerance`."""
    x, q = _operands(x, q)
    m = q.shape[-1]
    S = n_windows(x.shape[-1], m, stride)
    s1, s2 = _window_stats(x, m, stride, S)
    dot = sliding_dot_fft(x, q, stride=stride)
    return _expand_distance(dot, s1, s2, q, m)
