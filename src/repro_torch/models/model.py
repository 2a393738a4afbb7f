"""Public model API: ``build_model(cfg, device=)`` returns a ``Model``
bundle with init / hidden states / logits / loss / prefill / decode entry
points over an explicit parameter tree (the JAX package's layout, see
``models.transformer``) on the model's device.  The bundle holds no
weights: as in the JAX package, each call takes the tree, which
``params_from_reference`` maps leaf for leaf from the JAX package's.

The device is ``cuda`` unless the caller asks for the CPU, and a CUDA
model raises when there is no card.  ``rules`` (``sharding.
ShardingRules``) reach every entry point; the model reads their
``moe_groups`` (the MoE's group-local dispatch).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.core.engine import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.transformer import (  # noqa: F401
    RunConfig, init_params, params_from_reference)


@dataclass(frozen=True)
class Model:
    cfg: ModelConfig
    rc: RunConfig = field(default_factory=RunConfig)
    device: torch.device = field(
        default_factory=lambda: resolve_device("cuda"))
    rules: object = None

    # -- parameters ----------------------------------------------------
    def init(self, seed=0, device=None):
        """Random parameters from ``seed`` (int or ``torch.Generator``) on
        ``device`` (default: the model's)."""
        dev = self.device if device is None else resolve_device(device)
        return init_params(self.cfg, seed, dev)

    def params_from_reference(self, tree):
        """The JAX package's parameters (a tree of numpy arrays) as this
        model's, on its device."""
        return T.params_from_reference(self.cfg, tree, self.device)

    def compute_params(self, params):
        """``params`` with the leaves read in the compute dtype cast once
        (same values as casting at each use)."""
        return T.compute_params(self.cfg, params)

    def param_count(self) -> tuple[int, int]:
        return self.cfg.param_counts()

    def _batch(self, batch):
        """The batch's arrays as tensors on the model's device."""
        return {k: torch.as_tensor(v).to(self.device) for k, v in
                batch.items()}

    # -- forward --------------------------------------------------------
    def loss(self, params, batch):
        """batch: dict(tokens, labels[, prefix_embed, encoder_frames]).
        Differentiable: ``train.step`` takes its gradients by autograd."""
        return T.lm_loss(params, self.cfg, self._batch(batch), self.rc,
                         rules=self.rules)

    def hidden_states(self, params, batch):
        batch = self._batch(batch)
        x, aux, _ = T.forward(
            params, self.cfg, batch["tokens"], rc=self.rc,
            prefix_embed=batch.get("prefix_embed"),
            encoder_frames=batch.get("encoder_frames"), rules=self.rules)
        return x, aux

    def logits(self, params, batch):
        """Full logits — small configs only (materializes (B, S, V))."""
        x, aux = self.hidden_states(params, batch)
        head = T.unembed(params, self.cfg).to(x.dtype)
        return (x @ head).float(), aux

    # -- serve ----------------------------------------------------------
    def prefill(self, params, batch):
        batch = self._batch(batch)
        return T.prefill(
            params, self.cfg, batch["tokens"], rc=self.rc,
            prefix_embed=batch.get("prefix_embed"),
            encoder_frames=batch.get("encoder_frames"), rules=self.rules)

    def decode_step(self, params, cache, token):
        token = torch.as_tensor(token).to(self.device)
        return T.decode_step(params, self.cfg, cache, token, rc=self.rc,
                             rules=self.rules)

    def init_cache(self, batch: int, max_len: int, dtype=torch.bfloat16):
        return T.init_cache(self.cfg, batch, max_len, dtype, self.device)


def build_model(cfg: ModelConfig, rules=None,
                rc: Optional[RunConfig] = None, device="cuda") -> Model:
    return Model(cfg=cfg, rc=rc or RunConfig(), device=resolve_device(device),
                 rules=rules)
