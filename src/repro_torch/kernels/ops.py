"""Dispatchers for the five kernels, the query-table builders, the
sweep the engine's ``pairwise=`` hook takes, and the FFT twin of the
distance profile.

Each dispatcher is the kernel's wrapper: a CUDA tensor launches the
hand-written kernel, a CPU tensor runs the plain version in ``ref.py``.
The kernels mask ragged edges themselves, so no caller pads.
"""

from __future__ import annotations

import math

import torch

from repro_torch.core.breakpoints import lower_bounds, upper_bounds
from repro_torch.core.sax import SAX, cell_table
from repro_torch.core.ssax import SSAX
from repro_torch.kernels.euclid import (  # noqa: F401
    euclid_batch, euclid_gather)
from repro_torch.kernels.paa import paa_segments  # noqa: F401
from repro_torch.kernels.sax_dist import sax_dist
from repro_torch.kernels.ssax_dist import (  # noqa: F401
    ssax_dist, ssax_dist_batch)
from repro_torch.kernels import windowed_euclid as _windowed

# -inf - -inf would poison the kernel max; clamp to a huge negative
_BIG = -3.4e38 / 4


# -- query-table builders ---------------------------------------------------

def make_sax_query_table(query_syms, breakpoints):
    """(W,) query symbols -> (W, A) f32 table of squared cell distances."""
    tab = cell_table(breakpoints.to(query_syms.device))     # (A, A)
    return tab[query_syms.long()].square().contiguous()     # (W, A)


def make_ssax_query_tables(q_seas, q_res, b_seas, b_res):
    """Query-conditioned (t1, t2, u1, u2) term tables for the sSAX kernel,
    f32, with infinities clamped to -+3.4e38/4: (L,)/(W,) query symbols
    give (L, A_seas)/(W, A_res) tables, and a (Q, L)/(Q, W) batch the
    (Q, L, A_seas)/(Q, W, A_res) tables, each query's equal to its own
    tables bitwise."""
    dev = q_seas.device
    lo_s, hi_s = lower_bounds(b_seas.to(dev)), upper_bounds(b_seas.to(dev))
    lo_r, hi_r = lower_bounds(b_res.to(dev)), upper_bounds(b_res.to(dev))
    qs, qr = q_seas.long(), q_res.long()
    t1 = lo_s[qs][..., None] - hi_s                  # ([Q,] L, A_seas)
    t2 = lo_s - hi_s[qs][..., None]
    u1 = lo_r[qr][..., None] - hi_r                  # ([Q,] W, A_res)
    u2 = lo_r - hi_r[qr][..., None]
    return tuple(torch.nan_to_num(t.to(torch.float32), nan=0.0, neginf=_BIG,
                                  posinf=-_BIG).contiguous()
                 for t in (t1, t2, u1, u2))


# -- the sweep through the kernels ------------------------------------------

def make_pairwise(encoder):
    """``(rq, rx) -> (Q, N)`` lower bounds for ``MatchEngine(pairwise=)``.

    SAX sweeps through K3, one launch per query, and sSAX through K2, one
    launch for all queries, with the encoder's scale and square root
    applied after; tSAX and stSAX have no sweep kernel and keep their
    plain ``pairwise_distance``."""
    if isinstance(encoder, SAX):
        scale = math.sqrt(encoder.T / encoder.W)

        def sax_pairwise(rq, rx):
            bp = encoder.breakpoints
            d2 = torch.stack([sax_dist(rx, make_sax_query_table(q, bp))
                              for q in rq])
            return scale * torch.sqrt(d2)
        return sax_pairwise
    if isinstance(encoder, SSAX):
        scale = math.sqrt(encoder.T / (encoder.W * encoder.L))

        def ssax_pairwise(rq, rx):
            (sq, wq), (sx, wx) = rq, rx
            tabs = make_ssax_query_tables(sq, wq, encoder.b_seas,
                                          encoder.b_res)
            return scale * torch.sqrt(ssax_dist_batch(sx, wx, *tabs))
        return ssax_pairwise
    return encoder.pairwise_distance


# -- the distance profile ---------------------------------------------------

def windowed_euclid(x, q, stride: int = 1, method: str = "accum"):
    """(N, T) raw rows vs (m,) or (Q, m) z-normalized queries -> (N, S)
    or (Q, N, S) squared z-normalized window distances (the MASS-style
    distance profile).

    ``method`` picks the sliding-dot-product formulation: ``"accum"``
    (default) is the m-step accumulation — K5 for CUDA tensors, its
    plain version for CPU tensors — and the only path exact verification
    consumes; ``"fft"`` is the MASS rfft/irfft path
    (``kernels.fft_dot.windowed_euclid_fft``, ``torch.fft`` on the
    caller's device, O(T log T) per row), which agrees with the
    accumulation within ``fft_dot.fft_tolerance(m)``, never bitwise."""
    if method == "fft":
        from repro_torch.kernels.fft_dot import windowed_euclid_fft
        if q.ndim == 1:
            return windowed_euclid_fft(x, q[None], stride=stride)[0]
        return windowed_euclid_fft(x, q, stride=stride)
    if method != "accum":
        raise ValueError(f"unknown windowed_euclid method: {method!r}")
    return _windowed.windowed_euclid(x, q, stride)


def sliding_dot(x, q, stride: int = 1, method: str = "fft"):
    """(N, T) rows vs (m,) or (Q, m) queries -> (N, S) or (Q, N, S)
    sliding dot products.  ``method="fft"`` (default) is the MASS
    rfft/irfft correlation, ``"accum"`` the m-step accumulation twin —
    both from ``kernels.fft_dot``, held against
    ``ref.sliding_dot_ref``."""
    from repro_torch.kernels.fft_dot import sliding_dot_accum, sliding_dot_fft
    if method == "fft":
        fn = sliding_dot_fft
    elif method == "accum":
        fn = sliding_dot_accum
    else:
        raise ValueError(f"unknown sliding_dot method: {method!r}")
    if q.ndim == 1:
        return fn(x, q[None], stride=stride)[0]
    return fn(x, q, stride=stride)
