"""Train-step factory: loss -> grads (with microbatch accumulation) ->
optional compression -> AdamW, as the JAX package's ``train/step.py``.

Loss and gradients come from ``torch.autograd`` over the port's
``lm_loss``; the forward runs under the config's remat policy
(``RunConfig.remat``).  With ``rc.microbatch = m > 1`` the batch is cut
into ``m`` pieces along its first axis and the step carries ``g / m``
in f32 and ``loss / m``, summed in microbatch order from zero (the JAX
package's ``lax.scan`` carry); the other metrics are the last
microbatch's.
"""

from __future__ import annotations

from typing import Optional

import torch

from repro_torch.models.transformer import (
    RunConfig, lm_loss, tree_leaves_with_path, tree_map,
    tree_map_with_path)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import compress_grads

F32 = torch.float32


def _grad_fn(cfg, rc: RunConfig):
    """(params, batch) -> (loss, metrics, grads), all detached."""
    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda a: a.detach().requires_grad_(True),
                            params)
            leaves = tree_leaves_with_path(live)
            loss, metrics = lm_loss(live, cfg, batch, rc)
            grads = torch.autograd.grad(loss, [a for _, a in leaves],
                                        allow_unused=True)
        # a leaf the loss never reads gets a zero gradient, as under JAX
        by_path = {p: torch.zeros_like(a) if g is None else g
                   for (p, a), g in zip(leaves, grads)}
        grads = tree_map_with_path(lambda p, _a: by_path[p], params)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)
    return grad_fn


def make_train_step(cfg, rules, rc: RunConfig, opt_cfg: AdamWConfig, *,
                    schedule=None, compression: Optional[str] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The
    batch's arrays (numpy or tensors) go to the device of the state's
    parameters; the step never syncs with the host."""
    if rules is not None:
        raise NotImplementedError("sharding rules are not ported yet; "
                                  "pass rules=None")
    grad_fn = _grad_fn(cfg, rc)

    def grads_of(params, batch):
        m = rc.microbatch
        if not m or m <= 1:
            return grad_fn(params, batch)

        def split(x):
            b = x.shape[0]
            if b % m:
                raise ValueError(f"batch {b} does not split into {m} "
                                 f"microbatches")
            return x.reshape(m, b // m, *x.shape[1:])

        mbs = {k: split(v) for k, v in batch.items()}
        grads = tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                               device=p.device), params)
        loss = torch.zeros((), dtype=F32, device=batch["tokens"].device)
        for i in range(m):
            l_i, metrics, g_i = grad_fn(params,
                                        {k: v[i] for k, v in mbs.items()})
            grads = tree_map(lambda a, g: a + g.to(F32) / m, grads, g_i)
            loss = loss + l_i / m
        return loss, metrics, grads

    def train_step(state, batch):
        params = state["params"]
        dev = next(a for _, a in tree_leaves_with_path(params)).device
        batch = {k: torch.as_tensor(v).to(dev) for k, v in batch.items()}
        loss, metrics, grads = grads_of(params, batch)
        if compression:
            grads, cmetrics = compress_grads(grads, method=compression)
            metrics = {**metrics, **cmetrics}
        lr_scale = schedule(state["step"]) if schedule is not None else 1.0
        params, opt, om = adamw_update(
            opt_cfg, params, grads, state["opt"], state["step"],
            lr_scale=lr_scale)
        new_state = {"params": params, "opt": opt, "step": state["step"] + 1}
        metrics = {"loss": loss, **metrics, **om}
        return new_state, metrics

    return train_step
