"""gemma3-12b — dense with 5 local (sliding-window 1024) : 1 global interleave.

48L d_model=3840 16H (GQA kv=8) head_dim=256 d_ff=15360 vocab=262144, 128k ctx
[hf:google/gemma-3 family]

Sub-quadratic in the 5/6 local layers => long_500k decode cell runs; local
layers keep a ring-buffer KV cache of the window only.
"""

from repro_torch.configs.base import ModelConfig, attn

_LOCAL_WINDOW = 1024

CONFIG = ModelConfig(
    name="gemma3-12b",
    family="dense",
    n_layers=48,
    d_model=3840,
    n_heads=16,
    n_kv_heads=8,
    head_dim=256,
    d_ff=15_360,
    vocab_size=262_144,
    pattern=(
        attn(window=_LOCAL_WINDOW),
        attn(window=_LOCAL_WINDOW),
        attn(window=_LOCAL_WINDOW),
        attn(window=_LOCAL_WINDOW),
        attn(window=_LOCAL_WINDOW),
        attn(),                       # global layer
    ),
    rope_base=1_000_000.0,
    qk_norm=True,
    tie_embeddings=True,
)
