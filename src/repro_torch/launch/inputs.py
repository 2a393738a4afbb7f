"""Abstract inputs (meta tensors) and their pspecs for every (architecture
x input-shape) cell: the dry-run's allocation-free stand-ins, as the JAX
package's ``launch/inputs.py``.
"""

from __future__ import annotations

import torch

from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.models.transformer import cache_pspecs, init_cache
from repro_torch.sharding.specs import to_named  # noqa: F401  (API)


def _meta(shape, dtype):
    return torch.empty(shape, dtype=dtype, device="meta")


def batch_logical_dims(cfg: ModelConfig, with_labels: bool = True):
    dims = {"tokens": ("batch", "seq_tok")}
    if with_labels:
        dims["labels"] = ("batch", "seq_tok")
    if cfg.prefix_len:
        dims["prefix_embed"] = ("batch", "prefix", "vec")
    if cfg.is_enc_dec:
        dims["encoder_frames"] = ("batch", "frames", "vec")
    return dims


def train_batch_specs(cfg: ModelConfig, shape: ShapeSpec, rules=None,
                      with_labels: bool = True):
    """(abstract batch, pspec tree)."""
    B, S = shape.global_batch, shape.seq_len
    s_text = S - cfg.prefix_len
    batch = {"tokens": _meta((B, s_text), torch.int32)}
    if with_labels:
        batch["labels"] = _meta((B, s_text), torch.int32)
    if cfg.prefix_len:
        batch["prefix_embed"] = _meta((B, cfg.prefix_len, cfg.d_model),
                                      torch.bfloat16)
    if cfg.is_enc_dec:
        batch["encoder_frames"] = _meta((B, cfg.encoder_seq, cfg.d_model),
                                        torch.bfloat16)
    if rules is None:
        return batch, None
    dims = batch_logical_dims(cfg, with_labels)
    ps = {k: rules.pspec(dims[k], tuple(batch[k].shape)) for k in batch}
    return batch, ps


def decode_specs(cfg: ModelConfig, shape: ShapeSpec, rules=None):
    """(abstract (cache, token), pspec trees) for one decode step.

    The cache holds ``seq_len - 1`` tokens (pos = seq_len - 1); the step
    appends the one new token — "decode one token against a seq_len
    cache".  ``pos`` is a 0-d int32 meta tensor, as the JAX package's
    abstract cache has it.
    """
    B, S = shape.global_batch, shape.seq_len
    cache = init_cache(cfg, B, S, abstract=True)
    cache = dict(cache, pos=_meta((), torch.int32))
    token = _meta((B, 1), torch.int32)
    if rules is None:
        return (cache, token), None
    cache_ps = cache_pspecs(cfg, rules, cache)
    token_ps = rules.pspec(("batch", "seq_tok"), (B, 1))
    return (cache, token), (cache_ps, token_ps)
