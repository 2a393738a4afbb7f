"""The train state: ``{"params", "opt": {"m", "v"}, "step"}``, the JAX
package's tree (``train/state.py``), of tensors on one device.  ``step``
is a 0-d int32 tensor there, so a step reads it without a host sync."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.transformer import init_params, params_from_reference
from repro_torch.optim.adamw import adamw_init

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


TrainState = dict     # structural alias: {"params", "opt", "step"}
