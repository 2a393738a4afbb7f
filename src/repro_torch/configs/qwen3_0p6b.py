"""qwen3-0.6b — dense with qk-norm, GQA.

28L d_model=1024 16H (GQA kv=8) head_dim=128 d_ff=3072 vocab=151936
[hf:Qwen/Qwen3-8B family]
"""

from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="qwen3-0.6b",
    family="dense",
    n_layers=28,
    d_model=1024,
    n_heads=16,
    n_kv_heads=8,
    head_dim=128,
    d_ff=3072,
    vocab_size=151_936,
    pattern=(attn(),),
    rope_base=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
)
