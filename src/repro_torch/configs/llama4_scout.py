"""llama4-scout-17b-a16e — MoE 16 experts top-1 + shared expert, early fusion.

48L d_model=5120 40H (GQA kv=8) head_dim=128 d_ff=8192 vocab=202048
[hf:meta-llama/Llama-4-Scout-17B-16E]

Simplifications noted in DESIGN.md: interleaved NoPE layers kept as plain
RoPE; every layer is MoE (Scout's interleave step is 1) with one shared
expert.  Full attention => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="llama4-scout-17b-a16e",
    family="moe",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    head_dim=128,
    d_ff=8192,
    vocab_size=202_048,
    pattern=(attn(moe=True),),
    n_experts=16,
    moe_top_k=1,
    n_shared_experts=1,
    d_ff_expert=8192,
    rope_base=500_000.0,
    tie_embeddings=False,
)
