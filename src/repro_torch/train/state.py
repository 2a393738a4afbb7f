"""The train state: ``{"params", "opt": {"m", "v"}, "step"}``, the JAX
package's tree (``train/state.py``), of tensors on one device, or of
``DTensor`` shards on a mesh (:func:`shard_train_state`).  ``step`` is a
0-d int32 tensor there, so a step reads it without a host sync.

``abstract_train_state`` gives the tree as meta tensors and
``train_state_pspecs`` its ``PartitionSpec`` tree, for the dry-run and
for placing a state on a mesh."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.transformer import (
    abstract_params, dtype_of, init_params, param_pspecs,
    params_from_reference, tree_map)
from repro_torch.optim.adamw import adamw_init
from repro_torch.sharding.collectives import distribute
from repro_torch.sharding.specs import NamedPlacements, PartitionSpec, to_named

F32 = torch.float32


def init_train_state(cfg, seed=0, *, opt_dtype=F32, device="cuda"):
    """Parameters from ``seed`` (``init_params``), zero moments in
    ``opt_dtype`` and step 0, on ``device``: the card unless the caller
    asks for the CPU (a CUDA device raises when there is no card)."""
    dev = resolve_device(device)
    params = init_params(cfg, seed, dev)
    return {"params": params, "opt": adamw_init(params, dtype=opt_dtype),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


def train_state_from_reference(cfg, tree, device="cuda"):
    """The JAX package's train state as numpy arrays (``jax.tree.map(
    np.asarray, state)``) as the port's on ``device``: parameters and f32
    moments through ``params_from_reference`` (shapes checked against the
    schema)."""
    dev = resolve_device(device)
    opt = {k: params_from_reference(cfg, tree["opt"][k], dev)
           for k in ("m", "v")}
    return {"params": params_from_reference(cfg, tree["params"], dev),
            "opt": opt,
            "step": torch.as_tensor(np.asarray(tree["step"], np.int32),
                                    device=dev)}


def abstract_train_state(cfg, *, opt_dtype=F32, param_dtype=None):
    """The state as meta tensors (no storage).  ``opt_dtype`` /
    ``param_dtype`` give the low-memory form (bf16 AdamW moments and bf16
    master weights)."""
    p = abstract_params(cfg, param_dtype)
    od = dtype_of(opt_dtype)
    moments = lambda: tree_map(
        lambda a: torch.empty(a.shape, dtype=od, device="meta"), p)
    return {"params": p, "opt": {"m": moments(), "v": moments()},
            "step": torch.empty((), dtype=torch.int32, device="meta")}


def train_state_pspecs(cfg, rules):
    ps = param_pspecs(cfg, rules)
    return {"params": ps, "opt": {"m": ps, "v": ps},
            "step": PartitionSpec()}


def shard_train_state(state, cfg, rules):
    """A full state (every rank holding the same one) placed on
    ``rules.mesh`` (a ``DeviceMesh``) by ``train_state_pspecs``: each leaf
    this rank's shard as a ``DTensor``, on the mesh's device."""
    named = to_named(rules, train_state_pspecs(cfg, rules))
    return tree_map(distribute, state, named,
                    is_leaf=lambda x: isinstance(x, NamedPlacements))


TrainState = dict     # structural alias: {"params", "opt", "step"}
