"""Mamba (selective SSM) block — Jamba-style, plain PyTorch.

Training/prefill runs a chunked scan: the sequence is cut into
``chunk``-sized pieces; an outer loop carries the (B, d_inner, N) state
across chunks, and within a chunk the recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t

is evaluated as the JAX package does, as a scan of the affine maps
(dA_t, dBx_t) from a zero state plus the chunk's decay product times the
carried state.  PyTorch has no ``associative_scan``; the port composes
the maps with a doubling (Hillis-Steele) scan, log2(chunk) vectorized
steps.  It groups the products in another order than XLA's scan, so the
two agree to f32 rounding, not bitwise (the tests hold them to rtol
1e-4).  Where autograd records, each chunk step is checkpointed
(recomputed in backward), as the JAX package's ``jax.checkpoint``.

Decode is a single recurrence step on carried (conv window, ssm state).
Sharding is not part of this port yet: no sharding rules are taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import remat

F32 = torch.float32


def _doubling_scan(a, b):
    """Inclusive scan of the affine maps h -> a_t * h + b_t along axis 1:
    returns (prod_{s<=t} a_s, h_t from a zero state)."""
    n = a.shape[1]
    off = 1
    while off < n:
        a_prev, b_prev = a[:, :-off], b[:, :-off]
        b = torch.cat([b[:, :off], a[:, off:] * b_prev + b[:, off:]], dim=1)
        a = torch.cat([a[:, :off], a[:, off:] * a_prev], dim=1)
        off *= 2
    return a, b


def _ssm_scan_chunk(h0, dA, dBx):
    """Scan within one chunk.

    h0: (B, D, N); dA, dBx: (B, c, D, N).  Returns (h_all (B,c,D,N), h_last).
    """
    aA, aB = _doubling_scan(dA, dBx)
    h_all = aA * h0[:, None] + aB
    return h_all, h_all[:, -1]


def _chunk_step(h, dA, dBx, Cm):
    """One chunk of the training scan: (h_last, y (B, c, D))."""
    h_all, h_last = _ssm_scan_chunk(h, dA, dBx)
    return h_last, torch.einsum("bcdn,bcn->bcd", h_all, Cm)


def mamba_mixer(p, x, cfg, *, state=None, chunk: int = 256,
                collect_state: bool = False):
    """x: (B, S, d) -> (B, S, d).

    state: None for train/prefill-from-scratch, else dict(conv, ssm) for
    decode (S == 1).  Returns (y, new_state); new_state is None in train
    unless ``collect_state`` (prefill) is set.
    """
    B, S, d = x.shape
    D, N, R = cfg.d_inner, cfg.mamba_d_state, cfg.dt_rank
    KC = cfg.mamba_d_conv
    dt_ = x.dtype

    xz = x @ p["in_proj"].to(dt_)                     # (B, S, 2D)
    x_in, z = xz.chunk(2, dim=-1)

    # -- causal depthwise conv ----------------------------------------
    w = p["conv_w"].to(dt_)                           # (D, KC)
    if state is None:
        pad = torch.zeros((B, KC - 1, D), dtype=dt_, device=x.device)
        xp = torch.cat([pad, x_in], dim=1)            # (B, S+KC-1, D)
        new_conv = None
    else:
        xp = torch.cat([state["conv"].to(dt_), x_in], dim=1)
        new_conv = xp[:, 1:]                          # keep last KC-1
    x_c = sum(xp[:, i:i + S] * w[None, None, :, i] for i in range(KC))
    x_c = x_c + p["conv_b"].to(dt_)
    x_c = F.silu(x_c.float()).to(dt_)

    # -- input-dependent dt, B, C --------------------------------------
    dbc = x_c @ p["x_proj"].to(dt_)                   # (B, S, R + 2N)
    dt_r = dbc[..., :R]
    Bm = dbc[..., R:R + N].float()                    # (B, S, N)
    Cm = dbc[..., R + N:].float()
    dt_full = dt_r @ p["dt_proj"].to(dt_) + p["dt_bias"].to(dt_)
    delta = F.softplus(dt_full.float())               # (B, S, D)
    A = -torch.exp(p["A_log"].float())                # (D, N)

    dA = torch.exp(delta[..., None] * A[None, None])          # (B, S, D, N)
    dBx = (delta * x_c.float())[..., None] * Bm[:, :, None, :]

    if state is not None:                              # decode: one step
        h = dA[:, 0] * state["ssm"] + dBx[:, 0]        # (B, D, N)
        y = torch.einsum("bdn,bn->bd", h, Cm[:, 0])[:, None]  # (B, 1, D)
        new_state = {"conv": new_conv, "ssm": h}
    else:
        c = min(chunk, S)
        assert S % c == 0
        h = torch.zeros((B, D, N), dtype=F32, device=x.device)
        ys = []
        for lo in range(0, S, c):         # each chunk recomputed in backward
            h, y_c = remat(_chunk_step, h, dA[:, lo:lo + c],
                           dBx[:, lo:lo + c], Cm[:, lo:lo + c])
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
        new_state = None
        if collect_state:                      # prefill: decode-ready state
            conv_tail = xp[:, S:] if KC > 1 else \
                torch.zeros((B, 0, D), dtype=dt_, device=x.device)
            new_state = {"conv": conv_tail, "ssm": h}

    y = y + x_c.float() * p["D_skip"].float()[None, None]
    y = y.to(dt_) * F.silu(z.float()).to(dt_)
    return y @ p["out_proj"].to(dt_), new_state


def init_mamba_state(cfg, batch: int, dtype=torch.bfloat16, device="cpu"):
    return {
        "conv": torch.zeros((batch, cfg.mamba_d_conv - 1, cfg.d_inner),
                            dtype=dtype, device=device),
        "ssm": torch.zeros((batch, cfg.d_inner, cfg.mamba_d_state),
                           dtype=F32, device=device),
    }
