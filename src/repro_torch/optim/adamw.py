"""AdamW over parameter trees (the port's nested dicts and lists of
tensors) as plain functions, as the JAX package's ``optim/adamw.py``.

State (m, v) mirrors the parameter tree.  Update math runs in f32
whatever the parameter or moment dtype (bf16 moments are up-cast each
step), in the JAX package's order: global-norm clip, both bias
corrections, ``mhat / (sqrt(vhat) + eps)``, and decoupled weight decay
on leaves with ``ndim >= 2`` only.  (``torch.optim.AdamW`` decays every
leaf and orders its arithmetic otherwise, so it is not used.)
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from repro_torch.models.transformer import tree_leaves_with_path, tree_map

F32 = torch.float32


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def adamw_init(params, dtype=F32):
    """dtype=bfloat16 gives the low-memory state variant; the update math
    still runs in f32 (moments are up-cast per step)."""
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params)}


def global_norm(tree):
    leaves = [g.float().square().sum() for _, g in
              tree_leaves_with_path(tree)]
    return torch.sqrt(torch.stack(leaves).sum())


def adamw_update(cfg: AdamWConfig, params, grads, opt_state, step, *,
                 lr_scale=1.0, gnorm=None):
    """Returns (new_params, new_opt_state, metrics).  ``step`` is the
    0-d step counter (tensor or int) before this update.  ``gnorm`` is
    the gradients' global norm where the caller has it (a sharded step
    sums over every shard, ``train.step``); by default
    :func:`global_norm` of ``grads``."""
    if gnorm is None:
        gnorm = global_norm(grads)
    clip = torch.clamp_max(cfg.grad_clip / torch.clamp_min(gnorm, 1e-9), 1.0)
    t = (torch.as_tensor(step, device=gnorm.device) + 1).to(F32)
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t
    lr = cfg.lr * lr_scale

    def upd(p, g, m, v):
        st_dtype = m.dtype
        g = g.float() * clip
        m = cfg.b1 * m.float() + (1 - cfg.b1) * g
        v = cfg.b2 * v.float() + (1 - cfg.b2) * g.square()
        mhat = m / bc1
        vhat = v / bc2
        step_ = mhat / (vhat.sqrt() + cfg.eps)
        if p.ndim >= 2:                      # decoupled decay, matrices only
            step_ = step_ + cfg.weight_decay * p.float()
        new_p = (p.float() - lr * step_).to(p.dtype)
        return new_p, m.to(st_dtype), v.to(st_dtype)

    out = tree_map(upd, params, grads, opt_state["m"], opt_state["v"])
    is_out = lambda x: isinstance(x, tuple) and len(x) == 3 and \
        all(torch.is_tensor(a) for a in x)
    pick = lambda i: tree_map(lambda o: o[i], out, is_leaf=is_out)
    return pick(0), {"m": pick(1), "v": pick(2)}, {"grad_norm": gnorm}
