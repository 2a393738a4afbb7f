"""jamba-1.5-large-398b — hybrid Mamba + attention 1:7 interleave with MoE.

72L d_model=8192 64H (GQA kv=8) head_dim=128 d_ff=24576 vocab=65536,
MoE 16 experts top-2 on every other layer. [arXiv:2403.19887]

Pattern (one Jamba block, repeated 9x): [m, m*, m, a*, m, m*, m, m*]
where * marks MoE layers (every 2nd) and `a` is the single attention layer.
SSM state is O(1) => long_500k decode cell runs.
"""

from repro_torch.configs.base import ModelConfig, attn, mamba

CONFIG = ModelConfig(
    name="jamba-1.5-large-398b",
    family="hybrid",
    n_layers=72,
    d_model=8192,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=24_576,
    vocab_size=65_536,
    pattern=(
        mamba(),
        mamba(moe=True),
        mamba(),
        attn(moe=True),
        mamba(),
        mamba(moe=True),
        mamba(),
        mamba(moe=True),
    ),
    n_experts=16,
    moe_top_k=2,
    d_ff_expert=24_576,
    rope_base=10_000.0,
    use_rope=False,                  # jamba uses no positional encoding
    mamba_d_state=16,
    mamba_d_conv=4,
    mamba_expand=2,
    tie_embeddings=False,
)
