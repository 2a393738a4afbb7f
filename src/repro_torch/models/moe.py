"""Mixture-of-Experts MLP with top-k routing and capacity-bounded
scatter/gather dispatch (no (T,E,C) one-hot einsum — dispatch moves
T·k·d bytes instead of burning T·E·C·d FLOPs, so compute stays
proportional to *active* parameters).

Routing follows the JAX package exactly: top-k picks the lower expert id
first on equal probabilities (a stable descending sort, since
``torch.topk`` promises no order among ties); a token's k-th choice ranks
after every token's (k-1)-th choice for capacity; rows past capacity go
to a spare expert row ``E`` and are dropped.

With sharding rules whose ``moe_groups`` G > 1 divides the token count,
dispatch is group-local (:func:`_moe_mlp_grouped`, the JAX package's):
tokens split into G groups, capacity and positions counted within a
group, and the combine made as K indexed adds in the order k = 0..K-1.

Under the sharded train step each rank holds a slice of the batch, and
``rules.batch`` (``sharding.collectives.BatchGroup``) names the ranks:
capacity, positions and the aux terms are then the global batch's, as
when one device holds it.  The ungrouped dispatch offsets each rank's
positions by the choices of the ranks before it (an all-gather of the
(K, E) counts) and fills a buffer of its own kept rows; a group never
straddles two ranks, so grouped positions need nothing; the aux terms
sum over the ranks.
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


def _route(xt, router, K: int):
    """(logits f32, probs, gate values renormalized over the top K, expert
    ids) of tokens ``xt`` (..., d); ties go to the lower expert id."""
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    order = torch.sort(probs, dim=-1, descending=True, stable=True)
    gate_vals = order.values[..., :K]
    expert_idx = order.indices[..., :K]
    gate_vals = gate_vals / torch.clamp_min(
        gate_vals.sum(-1, keepdim=True), 1e-9)
    return logits, probs, gate_vals, expert_idx


def _add_aux(aux, logits, probs, counts, fits, E: int, n: int,
             batch=None):
    """Switch-style load-balance loss, router z-loss and the dropped
    fraction, added into ``aux``; ``counts`` (E,) are the routed choices
    per expert, ``n`` their total.  With ``batch`` (a ``BatchGroup``)
    each mean is over the whole batch's tokens."""
    probs = probs.reshape(-1, E)
    z2 = torch.logsumexp(logits, dim=-1).square()
    drop = 1.0 - fits.float()
    if batch is None:
        me, frac = probs.mean(0), counts.float() / n           # (E,)
        z, dropped = z2.mean(), drop.mean()
    else:
        k = batch.n
        me = batch.total(probs.sum(0)) / (k * probs.shape[0])
        frac = batch.sum(counts.float()) / (k * n)
        z = batch.total(z2.sum()) / (k * z2.numel())
        dropped = batch.sum(drop.sum()) / (k * drop.numel())
    aux["load_balance"] = aux.get("load_balance", 0.0) + \
        E * (frac * me).sum()
    aux["router_z"] = aux.get("router_z", 0.0) + z
    aux["dropped_frac"] = aux.get("dropped_frac", 0.0) + dropped


def moe_mlp(p, x, cfg, *, rules=None, aux: Optional[dict] = None):
    """x: (B, S, d) -> (B, S, d).  Router stats go into ``aux`` if given.
    ``rules`` with ``moe_groups`` > 1 dividing B·S (the whole batch's,
    with ``rules.batch``) take the group-local dispatch."""
    G = getattr(rules, "moe_groups", 0) or 1
    batch = getattr(rules, "batch", None)
    n = 1 if batch is None else batch.n     # G groups of n ranks' slices
    if G > 1 and (x.shape[0] * x.shape[1] * n) % G == 0:
        return _moe_mlp_grouped(p, x, cfg, G // n, aux=aux, batch=batch)
    B, S, d = x.shape
    T = B * S
    E, K = cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    dev = x.device
    xt = x.reshape(T, d)

    logits, probs, gate_vals, expert_idx = _route(xt, p["router"], K)

    # ---- capacity-bounded positions ---------------------------------
    onehot = F.one_hot(expert_idx, E)                        # (T, K, E)
    # priority: kth choices ranked after (k-1)th across all tokens
    flat = onehot.transpose(0, 1).reshape(K * T, E)          # (K*T, E)
    if batch is None:
        C = capacity(T, E, K, cfg.capacity_factor)
        pos_in_expert = torch.cumsum(flat, dim=0) - flat     # (K*T, E)
        pos = (pos_in_expert * flat).sum(-1).reshape(K, T).T  # (T, K)
        fits = pos < C
        slot, Cb = pos, C
    else:
        # this slice's rows in the global order: every rank's choices of
        # a lower k first, then the ranks before this one at the same k
        C = capacity(T * batch.n, E, K, cfg.capacity_factor)
        every = batch.gather(onehot.sum(0))                  # (n, K, E)
        per_k = every.sum(0)
        before = per_k.cumsum(0) - per_k + every[:batch.rank].sum(0)
        within = torch.cumsum(onehot, dim=0) - onehot        # (T, K, E)
        pos = ((within + before) * onehot).sum(-1)           # (T, K)
        fits = pos < C
        # the kept rows fill this rank's buffer in the same order; an
        # expert takes each token at most once
        kept = flat * fits.T.reshape(K * T, 1)
        slot = ((torch.cumsum(kept, dim=0) - kept) * kept).sum(-1) \
            .reshape(K, T).T
        Cb = min(C, T)
    gate_vals = torch.where(fits, gate_vals, 0.0)

    # ---- scatter tokens into (E, C, d) buffers ----------------------
    tok_idx = torch.arange(T, device=dev).repeat_interleave(K)
    e_idx = expert_idx.reshape(-1)
    c_idx = slot.reshape(-1)
    keep = fits.reshape(-1)
    e_idx = torch.where(keep, e_idx, E)     # dropped rows go to spare row E
    buf = torch.zeros((E + 1, Cb, d), dtype=dt, device=dev)
    buf.index_put_((e_idx, torch.where(keep, c_idx, 0)),
                   xt[tok_idx] * keep[:, None].to(dt), accumulate=True)
    xe = buf[:E]                             # (E, Cb, d)

    # ---- expert SwiGLU ----------------------------------------------
    ye = _swiglu(xe, p["w_gate"], p["w_up"], p["w_down"], dt,
                 "ecd,edf->ecf", "ecf,efd->ecd")             # (E, Cb, d)

    # ---- gather back + combine --------------------------------------
    # a dropped row's position may pass capacity: clamped, as JAX's gather
    # clamps it, and zeroed by its gate below
    gathered = ye[torch.where(keep, e_idx, 0),
                  c_idx.clamp(max=Cb - 1)]                   # (T*K, d)
    gathered = gathered * (gate_vals.reshape(-1) * keep)[:, None].to(dt)
    y = torch.zeros((T, d), dtype=dt, device=dev).index_add_(
        0, tok_idx, gathered)

    if cfg.n_shared_experts:
        y = y + _swiglu(xt, p["shared_w_gate"], p["shared_w_up"],
                        p["shared_w_down"], dt, "td,df->tf", "tf,fd->td")

    if aux is not None:
        # the one-hot's sums are the JAX package's bincount, exactly
        _add_aux(aux, logits, probs, onehot.sum((0, 1)), fits, E, T * K,
                 batch)
    return y.reshape(B, S, d)


def _moe_mlp_grouped(p, x, cfg, G: int, *, aux=None, batch=None):
    """Group-local capacity dispatch: the JAX package's
    ``_moe_mlp_grouped``, its per-group ``vmap`` as one batched scatter
    and gather over the leading G axis."""
    B, S, d = x.shape
    T = B * S
    Tg = T // G
    E, K = cfg.n_experts, cfg.moe_top_k
    dt = x.dtype
    dev = x.device
    xg = x.reshape(G, Tg, d)

    logits, probs, gate_vals, expert_idx = _route(
        xg, p["router"], K)                                  # (G, Tg, K)

    C = capacity(Tg, E, K, cfg.capacity_factor)
    onehot = F.one_hot(expert_idx, E)                        # (G, Tg, K, E)
    flat = onehot.permute(0, 2, 1, 3).reshape(G, K * Tg, E)
    pos_in_e = torch.cumsum(flat, dim=1) - flat              # group-local
    pos = (pos_in_e * flat).sum(-1).reshape(G, K, Tg) \
        .permute(0, 2, 1)                                    # (G, Tg, K)
    fits = pos < C
    gate_vals = torch.where(fits, gate_vals, 0.0)

    tok_idx = torch.arange(Tg, device=dev).repeat_interleave(K)
    e_idx = torch.where(fits, expert_idx, E).reshape(G, -1)  # (G, Tg*K)
    c_idx = torch.where(fits, pos, 0).reshape(G, -1)
    keep = fits.reshape(G, -1)
    g_idx = torch.arange(G, device=dev)[:, None].expand(G, Tg * K)

    # dropped rows go to each group's spare row E
    buf = torch.zeros((G, E + 1, C, d), dtype=dt, device=dev)
    buf.index_put_((g_idx, e_idx, c_idx),
                   xg[:, tok_idx] * keep[..., None].to(dt), accumulate=True)
    xe = buf[:, :E]                                          # (G, E, C, d)

    ye = _swiglu(xe, p["w_gate"], p["w_up"], p["w_down"], dt,
                 "gecd,edf->gecf", "gecf,efd->gecd")         # (G, E, C, d)

    gv = (gate_vals.reshape(G, -1) * keep).to(dt)            # (G, Tg*K)
    e2 = torch.where(e_idx < E, e_idx, 0).reshape(G, Tg, K)
    c2 = c_idx.reshape(G, Tg, K)
    g2 = gv.reshape(G, Tg, K)
    g_ar = torch.arange(G, device=dev)[:, None]
    # the combine as K indexed adds, k = 0..K-1 in order, from zero
    y = torch.zeros((G, Tg, d), dtype=dt, device=dev)
    for k in range(K):
        y = y + ye[g_ar, e2[..., k], c2[..., k]] * g2[..., k, None]
    y = y.reshape(T, d)

    if cfg.n_shared_experts:
        y = y + _swiglu(x.reshape(T, d), p["shared_w_gate"],
                        p["shared_w_up"], p["shared_w_down"], dt,
                        "td,df->tf", "tf,fd->td")

    if aux is not None:
        _add_aux(aux, logits, probs, onehot.sum((0, 1, 2)), fits, E, T * K,
                 batch)
    return y.reshape(B, S, d)
