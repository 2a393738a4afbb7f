"""Mixture-of-Experts MLP with top-k routing and capacity-bounded
scatter/gather dispatch (no (T,E,C) one-hot einsum — dispatch moves
T·k·d bytes instead of burning T·E·C·d FLOPs, so compute stays
proportional to *active* parameters).

Routing follows the JAX package exactly: top-k picks the lower expert id
first on equal probabilities (a stable descending sort, since
``torch.topk`` promises no order among ties); a token's k-th choice ranks
after every token's (k-1)-th choice for capacity; rows past capacity go
to a spare expert row ``E`` and are dropped.  Only the ungrouped
dispatch is ported: the JAX package's group-local dispatch is reached
only through sharding rules, which this port does not take yet.
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F

F32 = torch.float32


def capacity(n_tokens: int, n_experts: int, top_k: int,
             capacity_factor: float) -> int:
    c = math.ceil(top_k * n_tokens / n_experts * capacity_factor)
    return max(8, ((c + 7) // 8) * 8)       # pad for lane alignment


def _swiglu(x, w_gate, w_up, w_down, dt, eq_in: str, eq_out: str):
    g = torch.einsum(eq_in, x, w_gate.to(dt))
    u = torch.einsum(eq_in, x, w_up.to(dt))
    h = F.silu(g.float()).to(dt) * u
    return torch.einsum(eq_out, h, w_down.to(dt))


def moe_mlp(p, x, cfg, *, aux: Optional[dict] = None):
    """x: (B, S, d) -> (B, S, d).  Router stats go into ``aux`` if given."""
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    dev = x.device
    xt = x.reshape(T, d)

    logits = (xt @ p["router"].to(dt)).float()               # (T, E)
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[:, :K]                          # (T, K)
    expert_idx = order.indices[:, :K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)

    # ---- capacity-bounded positions ---------------------------------
    C = capacity(T, E, K, cfg.capacity_factor)
    onehot = F.one_hot(expert_idx, E)                        # (T, K, E)
    # priority: kth choices ranked after (k-1)th across all tokens
    flat = onehot.transpose(0, 1).reshape(K * T, E)          # (K*T, E)
    pos_in_expert = torch.cumsum(flat, dim=0) - flat         # (K*T, E)
    pos = (pos_in_expert * flat).sum(-1).reshape(K, T).T     # (T, K)
    fits = pos < C
    gate_vals = torch.where(fits, gate_vals, 0.0)

    # ---- scatter tokens into (E, C, d) buffers ----------------------
    tok_idx = torch.arange(T, device=dev).repeat_interleave(K)
    e_idx = expert_idx.reshape(-1)
    c_idx = pos.reshape(-1)
    keep = fits.reshape(-1)
    e_idx = torch.where(keep, e_idx, E)     # dropped rows go to spare row E
    buf = torch.zeros((E + 1, C, d), dtype=dt, device=dev)
    buf.index_put_((e_idx, torch.where(keep, c_idx, 0)),
                   xt[tok_idx] * keep[:, None].to(dt), accumulate=True)
    xe = buf[:E]                             # (E, C, d)

    # ---- expert SwiGLU ----------------------------------------------
    ye = _swiglu(xe, p["w_gate"], p["w_up"], p["w_down"], dt,
                 "ecd,edf->ecf", "ecf,efd->ecd")             # (E, C, d)

    # ---- gather back + combine --------------------------------------
    # a dropped row's position may pass capacity: clamped, as JAX's gather
    # clamps it, and zeroed by its gate below
    gathered = ye[torch.where(keep, e_idx, 0),
                  c_idx.clamp(max=C - 1)]                    # (T*K, d)
    gathered = gathered * (gate_vals.reshape(-1) * keep)[:, None].to(dt)
    y = torch.zeros((T, d), dtype=dt, device=dev).index_add_(
        0, tok_idx, gathered)

    if cfg.n_shared_experts:
        y = y + _swiglu(xt, p["shared_w_gate"], p["shared_w_up"],
                        p["shared_w_down"], dt, "td,df->tf", "tf,fd->td")

    if aux is not None:
        # Switch-style load-balance loss + router z-loss
        me = probs.mean(0)                                    # (E,)
        frac = torch.bincount(expert_idx.reshape(-1),
                              minlength=E).float() / (T * K)
        aux["load_balance"] = aux.get("load_balance", 0.0) + \
            E * (frac * me).sum()
        aux["router_z"] = aux.get("router_z", 0.0) + \
            torch.logsumexp(logits, dim=-1).square().mean()
        aux["dropped_frac"] = aux.get("dropped_frac", 0.0) + \
            (1.0 - fits.float()).mean()
    return y.reshape(B, S, d)
