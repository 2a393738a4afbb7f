"""Gradient compression for cross-pod data parallelism, as the JAX
package's ``optim/compression.py``.

``int8`` block-quantized compression (symmetric, per 256-value block,
rounding half to even as ``jnp.round`` does) is a drop-in transform on
the gradient tree; the error-feedback variant carries the residual in
the training loop.  On one card there is no all-reduce to shrink: the
step applies the quantize / dequantize math so the loss of precision,
and its ``compress_rel_err`` metric, are the ones a compressed
reduction would give.  Leaves with ``ndim < 2`` stay exact.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models.transformer import tree_map

F32 = torch.float32


def _quant_int8(g, block: int = 256):
    """Block-wise symmetric int8 quantization of the flattened tensor."""
    flat = g.reshape(-1)
    pad = (-flat.numel()) % block
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, block)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    scale = torch.clamp_min(scale, 1e-12)
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale, tuple(g.shape), pad


def _dequant_int8(q, scale, shape, pad):
    out = (q.to(F32) * scale).reshape(-1)
    if pad:
        out = out[:-pad]
    return out.reshape(shape)


def quantize_dequantize(g, block: int = 256):
    return _dequant_int8(*_quant_int8(g.float(), block))


def compress_grads(grads, method: str = "int8", block: int = 256):
    """Simulate the compressed all-reduce: q->dq on every gradient leaf.

    Returns (grads, metrics); the metrics report the compression error
    so the training loop can monitor drift.
    """
    if method == "none":
        return grads, {}
    if method != "int8":
        raise ValueError(f"unknown compression {method!r}")

    num, den = [], []

    def one(g):
        if g.ndim < 2:                      # tiny tensors stay exact
            return g
        dq = quantize_dequantize(g, block)
        num.append((g.float() - dq).square().sum())
        den.append(g.float().square().sum())
        return dq.to(g.dtype)

    out = tree_map(one, grads)
    # 0.0 + t0 + t1 + ..., left to right, as the JAX package's loop sums
    err_num, err_den = sum(num, 0.0), sum(den, 0.0)
    den_t = torch.clamp_min(torch.as_tensor(err_den, dtype=F32), 1e-30)
    return out, {"compress_rel_err": torch.sqrt(err_num / den_t)}


def error_feedback_update(grads, ef_state, block: int = 256):
    """Error-feedback compression: compress (g + e), carry new residual."""
    def one(g, e):
        if g.ndim < 2:
            return g, e
        tot = g.float() + e
        dq = quantize_dequantize(tot, block)
        return dq.to(g.dtype), tot - dq

    pairs = tree_map(one, grads, ef_state)
    is_pair = lambda x: isinstance(x, tuple) and len(x) == 2 and \
        all(torch.is_tensor(a) for a in x)
    comp = tree_map(lambda t: t[0], pairs, is_leaf=is_pair)
    new_ef = tree_map(lambda t: t[1], pairs, is_leaf=is_pair)
    return comp, new_ef


def init_error_feedback(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                          device=p.device), params)
