"""smollm-135m — llama-arch small dense LM.

30L d_model=576 9H (GQA kv=3) head_dim=64 d_ff=1536 vocab=49152
[hf:HuggingFaceTB/SmolLM-135M]
"""

from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    n_layers=30,
    d_model=576,
    n_heads=9,
    n_kv_heads=3,
    head_dim=64,
    d_ff=1536,
    vocab_size=49_152,
    pattern=(attn(),),
    rope_base=10_000.0,
    tie_embeddings=True,
)
