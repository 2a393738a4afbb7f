"""paligemma-3b — VLM: SigLIP frontend (STUB) + gemma decoder backbone.

18L d_model=2048 8H (GQA kv=1) head_dim=256 d_ff=16384 vocab=257216
[arXiv:2407.07726]

The modality frontend is a stub: ``input_specs()`` supplies 256 precomputed
patch embeddings (B, 256, d_model); the backbone applies prefix-LM masking
(bidirectional over image + prompt prefix).
"""

from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="paligemma-3b",
    family="vlm",
    n_layers=18,
    d_model=2048,
    n_heads=8,
    n_kv_heads=1,
    head_dim=256,
    d_ff=16_384,
    vocab_size=257_216,
    pattern=(attn(),),
    rope_base=10_000.0,
    prefix_lm=True,
    prefix_len=256,                  # SigLIP patch embeddings (stubbed)
    tie_embeddings=True,
)
