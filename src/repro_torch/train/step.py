"""Train-step factory: loss -> grads (with microbatch accumulation) ->
optional compression -> AdamW, as the JAX package's ``train/step.py``.

Loss and gradients come from ``torch.autograd`` over the port's
``lm_loss``; the forward runs under the config's remat policy
(``RunConfig.remat``).  With ``rc.microbatch = m > 1`` the batch is cut
into ``m`` pieces along its first axis and the step carries ``g / m``
in f32 and ``loss / m``, summed in microbatch order from zero (the JAX
package's ``lax.scan`` carry); the other metrics are the last
microbatch's.

With sharding rules the step is sharded over ``rules.mesh``, the
pattern of ZeRO-3 / FSDP over every mesh axis a pspec names: the state's
leaves are shards placed by ``train_state_pspecs``; each rank takes its
slice of each microbatch over the batch's mesh axes, gathers every
parameter to full, runs the same forward and backward on its slice, and
brings each gradient back to its parameter's placements (the sum over
the batch axes by reduce-scatter or all-reduce; a local slice on the
other axes, whose copies are identical and never summed).  The model
takes every batch-wide statistic over the batch ranks
(``rules.batch``): the loss's label count, the MoE's capacity, positions
and aux terms.  So each rank's loss and metrics are the global batch's,
and its gradient is its slice's part of the global gradient: the sharded
step optimises the unsharded step's objective, masked labels and MoE
dispatch included.  Compression runs on the batch-reduced full
gradient, before the slice, so its 256-value blocks are the unsharded
step's.  The global norm sums each shard's squares once (on the first
copy) and all-reduces one scalar over the world; AdamW then updates the
shards locally.

On a runtime ``DeviceMesh`` the leaves are ``DTensor`` and the
collectives run; on a mesh description (the dry-run) the state is this
rank's meta shards and the collectives are recorded
(``sharding.collectives``; ``train_step.collectives`` holds them).
"""

from __future__ import annotations

import math
from dataclasses import replace
from typing import Optional

import torch

from repro_torch.models.transformer import (
    RunConfig, lm_loss, tree_leaves_with_path, tree_map,
    tree_map_with_path)
from repro_torch.optim.adamw import AdamWConfig, adamw_update
from repro_torch.optim.compression import compress_grads
from repro_torch.sharding.collectives import (BatchGroup, Collectives,
                                              to_local, wrap)
from repro_torch.sharding.specs import mesh_axes, to_named

F32 = torch.float32


def _grad_fn(cfg, rc: RunConfig, rules=None):
    """(params, batch) -> (loss, metrics, grads), all detached."""
    def grad_fn(params, batch):
        with torch.enable_grad():
            live = tree_map(lambda a: a.detach().requires_grad_(True),
                            params)
            leaves = tree_leaves_with_path(live)
            loss, metrics = lm_loss(live, cfg, batch, rc, rules=rules)
            grads = torch.autograd.grad(loss, [a for _, a in leaves],
                                        allow_unused=True)
        # a leaf the loss never reads gets a zero gradient, as under JAX
        by_path = {p: torch.zeros_like(a) if g is None else g
                   for (p, a), g in zip(leaves, grads)}
        grads = tree_map_with_path(lambda p, _a: by_path[p], params)
        return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
                grads)
    return grad_fn


def _grads_of(grad_fn, m: int):
    """(params, batch) -> (loss, metrics, grads) over ``m`` microbatches
    (one pass when ``m`` <= 1)."""
    def grads_of(params, batch):
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
    return grads_of


def make_train_step(cfg, rules, rc: RunConfig, opt_cfg: AdamWConfig, *,
                    schedule=None, compression: Optional[str] = None):
    """Returns ``train_step(state, batch) -> (state, metrics)``.  The
    batch's arrays (numpy or tensors) go to the device of the state's
    parameters; the step never syncs with the host.  With ``rules`` the
    step is sharded over ``rules.mesh`` (see the module's docstring); the
    batch is then the global batch, the same on every rank."""
    if rules is not None:
        if getattr(rules, "mesh", None) is None:
            raise ValueError("sharding rules carry no mesh")
        return _sharded_step(cfg, rules, rc, opt_cfg, schedule, compression)
    grads_of = _grads_of(_grad_fn(cfg, rc), rc.microbatch)

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


def batch_mesh_dims(rules, n_batch: int) -> tuple:
    """The mesh dims a global batch of ``n_batch`` rows is split over:
    its pspec's ("batch" rule, divisibility honoured), in mesh order."""
    entry = rules.pspec(("batch",), (n_batch,))
    axes = entry[0] if entry else ()
    axes = axes if isinstance(axes, tuple) else (axes,)
    names = list(mesh_axes(rules.mesh))
    return tuple(sorted(names.index(a) for a in axes))


def rank_rules(rules, comm: Collectives, over: tuple):
    """The rules a rank's model runs under when the batch is split over
    mesh dims ``over``: with the batch ranks (``rules.batch``) that the
    loss's label count and the MoE's positions and aux terms are taken
    over, and whose slices hold ``moe_groups`` G / ranks groups each.
    ``rules`` as they are on a single batch rank."""
    group = BatchGroup(comm, over)
    if group.n == 1:
        return rules
    G = rules.moe_groups
    if G > 1 and G % group.n:
        raise ValueError(f"moe_groups={G} does not divide into the "
                         f"{group.n} ranks the batch is split over")
    return replace(rules, batch=group)


def _sharded_step(cfg, rules, rc, opt_cfg, schedule, compression):
    from repro_torch.train.state import train_state_pspecs
    from torch.distributed.tensor import Replicate, Shard
    comm = Collectives(rules.mesh)
    named = to_named(rules, train_state_pspecs(cfg, rules))
    par_named = named["params"]
    n_dims = len(comm.sizes)
    m = rc.microbatch if rc.microbatch and rc.microbatch > 1 else 1

    def train_step(state, batch):
        over = batch_mesh_dims(rules, len(batch["tokens"]) // m)
        n_ranks = math.prod(comm.sizes[i] for i in over)
        grads_of = _grads_of(_grad_fn(cfg, rc, rank_rules(rules, comm,
                                                          over)), m)

        local = tree_map(to_local, state)
        dev = local["step"].device
        # each microbatch split over the batch ranks: a rank's i-th
        # microbatch is its slice of the global i-th
        row_split = tuple(Shard(1) if i in over else Replicate()
                          for i in range(n_dims))

        def rows(v):
            v = torch.as_tensor(v).to(dev)
            if v.shape[0] % (m * n_ranks):
                raise ValueError(f"batch {v.shape[0]} does not split into "
                                 f"{m} microbatches over {n_ranks} ranks")
            v = v.reshape(m, v.shape[0] // m, *v.shape[1:])
            return comm.local(v, row_split).reshape(-1, *v.shape[2:])

        batch = {k: rows(v) for k, v in batch.items()}
        params = tree_map(lambda a, nm: comm.gather(a, nm.placements),
                          local["params"], par_named)
        # loss and metrics are the global batch's on every rank; each
        # rank's gradient is its slice's part, so the ranks' sum is the
        # global batch's gradient
        loss, metrics, grads = grads_of(params, batch)
        del params
        scalars = {"loss": loss, **metrics}
        if compression:
            grads = tree_map(lambda g: comm.reduce_sum(g, over), grads)
            grads, cmetrics = compress_grads(grads, method=compression)
            scalars.update(cmetrics)
            grads = tree_map(lambda g, nm: comm.local(g, nm.placements),
                             grads, par_named)
        else:
            grads = tree_map(lambda g, nm: comm.reduce_sum(
                g, over, nm.placements), grads, par_named)
        # each element's square counted once: on its first copy
        sq = tree_map(lambda g, nm: g.float().square().sum()
                      if comm.owns(nm.placements)
                      else g.new_zeros((), dtype=F32), grads, par_named)
        gnorm = torch.sqrt(comm.all_reduce(torch.stack(
            [a for _, a in tree_leaves_with_path(sq)]).sum()))
        step = local["step"]
        lr_scale = schedule(step) if schedule is not None else 1.0
        params, opt, om = adamw_update(
            opt_cfg, local["params"], grads, local["opt"], step,
            lr_scale=lr_scale, gnorm=gnorm)
        new = {"params": params, "opt": opt, "step": step + 1}
        if not comm.record:
            new = tree_map(lambda a, nm, full: wrap(a, nm, tuple(full.shape)),
                           new, named, state)
        return new, {**scalars, **om}

    train_step.collectives = comm
    return train_step
