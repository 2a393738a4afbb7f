"""Core transformer layers: norms, positions, attention (flash + decode),
SwiGLU — pure functions over param trees of torch tensors.

Attention supports GQA (grouped einsums, no kv replication), optional
qk-norm, sliding windows, prefix-LM masking, cross-attention and three
execution modes:

* ``flash_attention`` — chunked online-softmax attention used for train and
  prefill; memory is bounded by (q_chunk x kv_chunk) score blocks, with
  f32 running max, sum and accumulator, in the JAX package's chunking.
* ``decode_attention`` — single-query attention against a KV cache (dense
  over the cache; per-step cost is O(S·d)).
* ring-buffer caches for sliding-window layers: the cache holds only
  ``window`` slots, which is what makes gemma3-style local layers O(1)
  memory at long context.

Products that the JAX package runs with ``preferred_element_type=f32``
run here on f32 copies of their operands: a product of two bf16 values
is exact in f32, so both accumulate the same terms in f32.  Sharding is
not part of this port yet: these functions take no sharding rules (the
JAX package's ``constrain`` is a no-op without them).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import (
    CheckpointPolicy, checkpoint, create_selective_checkpoint_contexts)

F32 = torch.float32


# ---------------------------------------------------------------------------
# Activation checkpointing
# ---------------------------------------------------------------------------

# plain matrix products (no batch dims: ``x @ W`` folds to ``mm``); the
# batched ones (attention's einsums, per-expert products) run as ``bmm``
_DOTS = frozenset({torch.ops.aten.mm.default, torch.ops.aten.addmm.default})


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def remat(fn, *args, dots: bool = False):
    """``fn(*args)``, under activation checkpointing where autograd
    records: the forward keeps ``args`` (and with ``dots`` the outputs of
    plain matrix products, the JAX package's
    ``dots_with_no_batch_dims_saveable``) and the backward recomputes the
    rest.  The recompute runs the same operations on the same values, so
    it changes no value.  With autograd off (``torch.no_grad``, serving)
    it is a plain call and costs nothing."""
    if not torch.is_grad_enabled():
        return fn(*args)
    ctx = {}
    if dots:
        ctx["context_fn"] = lambda: create_selective_checkpoint_contexts(
            _save_dots)
    return checkpoint(fn, *args, use_reentrant=False,
                      preserve_rng_state=False, **ctx)


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps: float = 1e-6):
    dt = x.dtype
    x = x.float()
    var = x.square().mean(-1, keepdim=True)
    x = x * torch.rsqrt(var + eps)
    return (x * (1.0 + scale.float())).to(dt)


# ---------------------------------------------------------------------------
# Positions
# ---------------------------------------------------------------------------

def rope_tables(positions, head_dim: int, base: float):
    """cos/sin tables for rotary embedding. positions: (...,) int."""
    half = head_dim // 2
    freqs = torch.exp(-math.log(base) * torch.arange(
        half, dtype=F32, device=positions.device) / half)
    angles = positions.float()[..., None] * freqs          # (..., half)
    return torch.cos(angles), torch.sin(angles)


def apply_rope(x, cos, sin):
    """x: (B, S, ..., Dh); cos/sin: (S, Dh/2) from ``rope_tables``."""
    half = x.shape[-1] // 2
    x1, x2 = x[..., :half], x[..., half:]
    shape = (1, cos.shape[0]) + (1,) * (x.ndim - 3) + (half,)
    cos = cos.reshape(shape)
    sin = sin.reshape(shape)
    x1f, x2f = x1.float(), x2.float()
    out = torch.cat([x1f * cos - x2f * sin, x2f * cos + x1f * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_embedding(positions, d_model: int):
    half = d_model // 2
    freqs = torch.exp(-math.log(10_000.0) * torch.arange(
        half, dtype=F32, device=positions.device) / half)
    ang = positions.float()[..., None] * freqs
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


# ---------------------------------------------------------------------------
# Masking
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MaskSpec:
    causal: bool = True
    window: Optional[int] = None
    prefix_len: int = 0               # bidirectional over [0, prefix_len)

    def allowed(self, q_pos, k_pos):
        """Boolean mask (broadcast over q_pos x k_pos grids)."""
        q = q_pos[..., :, None]
        k = k_pos[..., None, :]
        ok = torch.ones(torch.broadcast_shapes(q.shape, k.shape),
                        dtype=torch.bool, device=q.device)
        if self.causal:
            ok = k <= q
            if self.prefix_len:
                ok = ok | (k < self.prefix_len)
        if self.window is not None:
            ok = ok & (q - k < self.window)
        return ok


# ---------------------------------------------------------------------------
# Flash attention (train / prefill)
# ---------------------------------------------------------------------------

def _kv_block_range(i: int, q_chunk: int, kv_chunk: int, nk: int,
                    mask: MaskSpec, causal_skip: bool):
    """The kv blocks q chunk ``i`` visits: all of them, or with
    ``causal_skip`` only the causally visible (and, for windowed layers,
    window-reachable) ones."""
    if not (causal_skip and mask.causal):
        return 0, nk
    hi = -(-((i + 1) * q_chunk) // kv_chunk)                  # ceil
    lo = 0
    if mask.window is not None and not mask.prefix_len:
        lo = max(0, (i * q_chunk - mask.window + 1) // kv_chunk)
    return lo, hi


def flash_attention(q, k, v, mask: MaskSpec, *, q_positions=None,
                    kv_positions=None, q_chunk: int = 512,
                    kv_chunk: int = 1024, causal_skip: bool = False):
    """Chunked online-softmax attention.

    q: (B, S, Hkv, G, Dh); k, v: (B, T, Hkv, Dh).  Returns (B, S, Hkv, G, Dh).

    Each q chunk runs an online softmax over the kv chunks in order, with
    f32 running max ``m``, sum ``l`` and accumulator ``acc``.
    ``causal_skip`` bounds each q chunk's kv range to the causally
    visible (and, for windowed layers, window-reachable) blocks.
    """
    B, S, K, G, Dh = q.shape
    T = k.shape[1]
    q_chunk = min(q_chunk, S)
    kv_chunk = min(kv_chunk, T)
    assert S % q_chunk == 0 and T % kv_chunk == 0, (S, q_chunk, T, kv_chunk)
    nq, nk = S // q_chunk, T // kv_chunk
    dev = q.device
    if q_positions is None:
        q_positions = torch.arange(S, device=dev)
    if kv_positions is None:
        kv_positions = torch.arange(T, device=dev)
    scale = 1.0 / math.sqrt(Dh)

    outs = []
    for i in range(nq):
        qi = q[:, i * q_chunk:(i + 1) * q_chunk]
        qf = qi.float()
        qp = q_positions[i * q_chunk:(i + 1) * q_chunk]
        m = torch.full((B, K, G, q_chunk), -torch.inf, dtype=F32, device=dev)
        l = torch.zeros((B, K, G, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((B, K, G, q_chunk, Dh), dtype=F32, device=dev)
        lo, hi = _kv_block_range(i, q_chunk, kv_chunk, nk, mask, causal_skip)
        for j in range(lo, hi):
            sl = slice(j * kv_chunk, (j + 1) * kv_chunk)
            s = torch.einsum("bqkgd,btkd->bkgqt", qf, k[:, sl].float()) * scale
            ok = mask.allowed(qp, kv_positions[sl])[None, None, None]
            s = torch.where(ok, s, -torch.inf)
            m_new = torch.maximum(m, s.amax(-1))
            # guard fully-masked rows (m_new == -inf)
            m_safe = torch.where(torch.isfinite(m_new), m_new, 0.0)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(ok, p, 0.0)
            corr = torch.where(torch.isfinite(m), torch.exp(m - m_safe), 0.0)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bkgqt,btkd->bkgqd", p.to(qi.dtype).float(),
                              v[:, sl].float())
            acc = acc * corr[..., None] + pv
            m = m_new
        out = acc / torch.clamp_min(l[..., None], 1e-30)
        outs.append(out.permute(0, 3, 1, 2, 4))          # (B, qc, K, G, Dh)
    return torch.cat(outs, dim=1).to(q.dtype)


def decode_attention(q, k_cache, v_cache, kv_mask):
    """Single-position attention against a cache.

    q: (B, 1, K, G, Dh); caches: (B, T, K, Dh); kv_mask: (B, T) bool.
    """
    Dh = q.shape[-1]
    scale = 1.0 / math.sqrt(Dh)
    s = torch.einsum("bqkgd,btkd->bkgqt", q.float(), k_cache.float()) * scale
    s = torch.where(kv_mask[:, None, None, None, :], s, -torch.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgqt,btkd->bqkgd", p.to(q.dtype).float(),
                       v_cache.float())
    return out.to(q.dtype)


# ---------------------------------------------------------------------------
# Attention layer (projections + core) and its cache
# ---------------------------------------------------------------------------

def attention_layer(p, x, cfg, spec, *, positions, kv_x=None,
                    cache=None, pos=None, q_chunk=512, kv_chunk=1024,
                    collect_kv=False, causal=True, is_cross=False,
                    pad_to=0, causal_skip=False):
    """Full attention layer.  Returns (out, cache_out).

    Modes (x: (B, S, d)):
      * train / encoder : cache=None, collect_kv=False -> (out, None)
      * prefill         : cache=None, collect_kv=True  -> (out, {"k","v"})
        (ring-layout tail for windowed layers, ready for decode)
      * decode (S == 1) : cache={"k","v"}, pos = int absolute position.
        Self-attention writes the step into the cache's tensors at pos
        (in place) and returns the cache; with ``is_cross`` the cache
        holds precomputed encoder k/v and is read untouched.
    kv_x: encoder states for cross-attention (train/prefill).
    """
    B, S, d = x.shape
    K, G, Dh = cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim
    dt = x.dtype

    q = (x @ p["wq"].to(dt)).reshape(B, S, K, G, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)

    if kv_x is not None:                       # cross-attn with encoder states
        k = (kv_x @ p["wk"].to(dt)).reshape(B, -1, K, Dh)
        v = (kv_x @ p["wv"].to(dt)).reshape(B, -1, K, Dh)
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        out = flash_attention(q, k, v, MaskSpec(causal=False),
                              q_chunk=q_chunk,
                              kv_chunk=pick_divisor(k.shape[1], kv_chunk))
        cache_out = {"k": k, "v": v} if collect_kv else None
    elif is_cross:                             # cross-attn decode from cache
        assert cache is not None
        kv_mask = torch.ones((B, cache["k"].shape[1]), dtype=torch.bool,
                             device=x.device)
        out = decode_attention(q, cache["k"].to(dt), cache["v"].to(dt),
                               kv_mask)
        cache_out = cache
    else:                                      # self-attention
        k = (x @ p["wk"].to(dt)).reshape(B, S, K, Dh)
        v = (x @ p["wv"].to(dt)).reshape(B, S, K, Dh)
        if cfg.qk_norm:
            k = rms_norm(k, p["k_norm"], cfg.norm_eps)
        if cfg.use_rope:
            cos, sin = rope_tables(positions, Dh, cfg.rope_base)
            q = apply_rope(q, cos, sin)
            k = apply_rope(k, cos, sin)
        if cache is not None:                  # decode
            cache_out, k_all, v_all, kv_mask = _cache_update(
                cache, k, v, spec.window, pos)
            out = decode_attention(q, k_all, v_all, kv_mask)
        else:
            mask = MaskSpec(
                causal=causal, window=spec.window,
                prefix_len=cfg.prefix_len if cfg.prefix_lm else 0)
            out = flash_attention(q, k, v, mask, q_chunk=q_chunk,
                                  kv_chunk=pick_divisor(S, kv_chunk),
                                  causal_skip=causal_skip)
            cache_out = None
            if collect_kv:
                cache_out = prefill_attn_cache(spec, k, v, S, pad_to=pad_to)

    out = out.reshape(B, S, K * G * Dh)
    out = out @ p["wo"].to(dt)
    return out, cache_out


def pick_divisor(n: int, target: int) -> int:
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def init_attn_cache(cfg, spec, batch: int, max_len: int,
                    dtype=torch.bfloat16, device="cpu"):
    """Cache tensors for one self-attention layer (ring buffer if windowed)."""
    slots = max_len if spec.window is None else min(spec.window, max_len)
    K, Dh = cfg.n_kv_heads, cfg.head_dim
    return {
        "k": torch.zeros((batch, slots, K, Dh), dtype=dtype, device=device),
        "v": torch.zeros((batch, slots, K, Dh), dtype=dtype, device=device),
    }


def _cache_update(cache, k_new, v_new, window, pos: int):
    """Write one step at absolute position ``pos`` into a (ring) cache, in
    place.  As the JAX package's ``dynamic_update_slice``, a global
    cache clamps a position past its end to the last slot."""
    slots = cache["k"].shape[1]
    slot = pos % slots if window is not None else pos
    slot = min(max(slot, 0), slots - k_new.shape[1])
    cache["k"][:, slot:slot + k_new.shape[1]] = k_new.to(cache["k"].dtype)
    cache["v"][:, slot:slot + v_new.shape[1]] = v_new.to(cache["v"].dtype)
    idx = torch.arange(slots, device=k_new.device)
    if window is None:
        valid = idx <= pos
    else:
        valid = (idx <= pos) | (pos >= slots)    # ring full => all valid
    B = cache["k"].shape[0]
    kv_mask = valid[None, :].expand(B, slots)
    return cache, cache["k"], cache["v"], kv_mask


def prefill_attn_cache(spec, k, v, seq_len: int, dtype=None,
                       pad_to: int = 0):
    """Build a decode-ready cache from prefill k/v: (B, S, K, Dh).

    For windowed layers only the last ``window`` positions are kept, rolled
    so that position p sits at slot p % window (ring-consistent with
    ``_cache_update``).  ``pad_to`` reserves decode headroom: global caches
    are zero-padded to ``pad_to`` slots, windowed caches to the window (a
    ring never needs more).  dtype defaults to the compute dtype of k/v.
    """
    dtype = dtype or k.dtype
    if spec.window is not None and seq_len > spec.window:
        w = spec.window
        start = seq_len - w
        roll = start % w
        tail_k = torch.roll(k[:, start:start + w], roll, dims=1)
        tail_v = torch.roll(v[:, start:start + w], roll, dims=1)
        return {"k": tail_k.to(dtype), "v": tail_v.to(dtype)}
    slots = seq_len
    if spec.window is not None:
        slots = min(spec.window, max(pad_to, seq_len))
    elif pad_to:
        slots = max(pad_to, seq_len)
    if slots > seq_len:
        pad = (0, 0, 0, 0, 0, slots - seq_len)     # axis 1 of (B, S, K, Dh)
        k = F.pad(k, pad)
        v = F.pad(v, pad)
    return {"k": k.to(dtype), "v": v.to(dtype)}


# ---------------------------------------------------------------------------
# SwiGLU MLP
# ---------------------------------------------------------------------------

def swiglu_mlp(p, x):
    dt = x.dtype
    g = x @ p["w_gate"].to(dt)
    u = x @ p["w_up"].to(dt)
    h = F.silu(g.float()).to(dt) * u
    return h @ p["w_down"].to(dt)
