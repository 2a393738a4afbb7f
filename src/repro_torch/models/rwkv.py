"""RWKV-6 (Finch) block: token-shift mixing, data-dependent decay time mix,
squared-ReLU channel mix — plain PyTorch.

The WKV recurrence per head (hd = head dim):

    S_t = diag(w_t) @ S_{t-1} + k_t^T v_t          S: (hd, hd)
    y_t = r_t @ (S_{t-1} + diag(u) k_t^T v_t)

with w_t in (0,1) the *data-dependent* per-channel decay (the paper's Finch
contribution) and u the learned "bonus" for the current token.  Like the
mamba block, train/prefill runs an outer chunk loop with a sequential
inner loop over the chunk's steps (the JAX package's ``lax.scan``),
each chunk checkpointed where autograd records, as there; decode is a
single step on the carried (shift, wkv-state).  Sharding is not part of
this port yet: no sharding rules are taken.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.layers import remat

F32 = torch.float32


def _token_shift(x, last):
    """Shift sequence right by one; ``last`` (B, 1, d) fills position 0."""
    return torch.cat([last, x[:, :-1]], dim=1)


def _lora(x, A, B_, dt):
    return torch.tanh(x @ A.to(dt)) @ B_.to(dt)


def _wkv_chunk_scan(s0, r, k, v, w, u):
    """Sequential WKV scan over one chunk.

    s0: (B, H, K, V); r,k,v: (B, c, H, hd); w: (B, c, H, hd) decay in (0,1).
    Returns y: (B, c, H, hd), s_last.
    """
    s = s0
    ys = []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]   # (B, H, hd)
        kv = kt[..., :, None] * vt[..., None, :]              # (B, H, K, V)
        bonus = (u[None] * kt)[..., :, None] * vt[..., None, :]
        ys.append(torch.einsum("bhk,bhkv->bhv", rt, s + bonus))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def rwkv_time_mix(p, x, cfg, *, state=None, chunk: int = 256,
                  collect_state: bool = False):
    B, S, d = x.shape
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    dt = x.dtype

    last = state["shift_tm"].to(dt) if state is not None else \
        torch.zeros((B, 1, d), dtype=dt, device=x.device)
    xs = _token_shift(x, last)
    diff = xs - x

    # data-dependent lerp coefficients (one shared + five per-stream loras)
    xxx = x + diff * p["mu_x"].to(dt)
    mix = torch.tanh(xxx @ p["lora_mix_A"].to(dt))         # (B, S, 5*r)
    mix = mix.reshape(B, S, 5, -1)
    streams = torch.einsum("bsfr,frd->bsfd", mix, p["lora_mix_B"].to(dt))
    mus = p["mu_rkvwg"].to(dt)                              # (5, d)
    xr, xk, xv, xw, xg = [
        x + diff * (mus[i] + streams[:, :, i]) for i in range(5)]

    r = (xr @ p["Wr"].to(dt)).reshape(B, S, H, hd)
    k = (xk @ p["Wk"].to(dt)).reshape(B, S, H, hd)
    v = (xv @ p["Wv"].to(dt)).reshape(B, S, H, hd)
    g = F.silu((xg @ p["Wg"].to(dt)).float()).to(dt)

    w_raw = p["w_base"].float() + \
        _lora(xw, p["lora_w_A"], p["lora_w_B"], dt).float()
    w = torch.exp(-torch.exp(w_raw)).reshape(B, S, H, hd)   # decay in (0,1)
    u = p["u_bonus"].float().reshape(H, hd)

    rf, kf, vf = (t.float() for t in (r, k, v))
    if state is not None:                                   # decode
        y, s_new = _wkv_chunk_scan(state["wkv"], rf, kf, vf, w, u)
        new_state = {"shift_tm": x[:, -1:], "wkv": s_new}
    else:
        c = min(chunk, S)
        assert S % c == 0
        s = torch.zeros((B, H, hd, hd), dtype=F32, device=x.device)
        ys = []
        for lo in range(0, S, c):         # each chunk recomputed in backward
            sl = slice(lo, lo + c)
            y_c, s = remat(_wkv_chunk_scan, s, rf[:, sl], kf[:, sl],
                           vf[:, sl], w[:, sl], u)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)
        new_state = None
        if collect_state:
            new_state = {"shift_tm": x[:, -1:], "wkv": s}

    # per-head group norm, then gate
    mean = y.mean(-1, keepdim=True)
    var = y.var(-1, keepdim=True, correction=0)
    y = (y - mean) * torch.rsqrt(var + 64e-5)
    y = y * p["ln_w"].float().reshape(H, hd) + \
        p["ln_b"].float().reshape(H, hd)
    y = y.reshape(B, S, d).to(dt) * g
    out = y @ p["Wo"].to(dt)
    return out, new_state


def rwkv_channel_mix(p, x, cfg, *, state=None,
                     collect_state: bool = False):
    B, S, d = x.shape
    dt = x.dtype
    last = state["shift_cm"].to(dt) if state is not None else \
        torch.zeros((B, 1, d), dtype=dt, device=x.device)
    xs = _token_shift(x, last)
    diff = xs - x
    xk = x + diff * p["mu_k"].to(dt)
    xr = x + diff * p["mu_r"].to(dt)
    k = torch.square(torch.relu((xk @ p["Wk"].to(dt)).float()))
    kv = k.to(dt) @ p["Wv"].to(dt)
    out = torch.sigmoid((xr @ p["Wr"].to(dt)).float()).to(dt) * kv
    new_state = {"shift_cm": x[:, -1:]} \
        if (state is not None or collect_state) else None
    return out, new_state


def init_rwkv_state(cfg, batch: int, dtype=torch.bfloat16, device="cpu"):
    """Time-mix state only; the channel-mix shift lives in the block's
    "mlp" cache slot (structure must match the decode-step output)."""
    H, hd = cfg.n_rwkv_heads, cfg.rwkv_head_dim
    return {
        "shift_tm": torch.zeros((batch, 1, cfg.d_model), dtype=dtype,
                                device=device),
        "wkv": torch.zeros((batch, H, hd, hd), dtype=F32, device=device),
    }
