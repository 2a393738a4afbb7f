"""olmoe-1b-7b — MoE with 64 experts, top-8 routing, MHA.

16L d_model=2048 16H (kv=16, i.e. MHA) head_dim=128 d_ff=1024/expert
vocab=50304, 64 experts top-8 [arXiv:2409.02060]
"""

from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="olmoe-1b-7b",
    family="moe",
    n_layers=16,
    d_model=2048,
    n_heads=16,
    n_kv_heads=16,
    head_dim=128,
    d_ff=1024,
    vocab_size=50_304,
    pattern=(attn(moe=True),),
    n_experts=64,
    moe_top_k=8,
    d_ff_expert=1024,
    rope_base=10_000.0,
    qk_norm=True,
    tie_embeddings=False,
)
