"""Architecture registry.

``get_config(name)`` resolves any assigned architecture (and the reduced
smoke-test variants via ``reduced``).  ``ARCHITECTURES`` lists the 10
assigned IDs in assignment order.  The port keeps its own copy of the
JAX package's configs (plain dataclasses), equal field by field.
"""

from __future__ import annotations

import importlib

from repro_torch.configs.base import (  # noqa: F401
    ModelConfig, ShapeSpec, LayerSpec, SHAPES, shape_for, reduced,
    attn, mamba, rwkv, ATTN, MAMBA, RWKV,
)

_MODULES = {
    "smollm-135m": "smollm_135m",
    "phi4-mini-3.8b": "phi4_mini_3p8b",
    "qwen3-0.6b": "qwen3_0p6b",
    "gemma3-12b": "gemma3_12b",
    "paligemma-3b": "paligemma_3b",
    "jamba-1.5-large-398b": "jamba_1p5_large",
    "llama4-scout-17b-a16e": "llama4_scout",
    "olmoe-1b-7b": "olmoe_1b_7b",
    "whisper-medium": "whisper_medium",
    "rwkv6-7b": "rwkv6_7b",
}

ARCHITECTURES = tuple(_MODULES)


def get_config(name: str) -> ModelConfig:
    if name not in _MODULES:
        raise KeyError(
            f"unknown arch {name!r}; available: {', '.join(ARCHITECTURES)}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.CONFIG
