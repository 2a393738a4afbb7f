"""rwkv6-7b (Finch) — attention-free RNN with data-dependent decay.

32L d_model=4096 (64 heads x 64 head_dim) d_ff=14336 vocab=65536
[arXiv:2404.05892]

O(1) recurrent state => decode and long_500k cells are state-carrying
recurrent steps; no KV cache exists.
"""

from repro_torch.configs.base import ModelConfig, rwkv

CONFIG = ModelConfig(
    name="rwkv6-7b",
    family="ssm",
    n_layers=32,
    d_model=4096,
    n_heads=32,                      # unused by rwkv mixing (kept for shape API)
    n_kv_heads=32,
    head_dim=128,
    d_ff=14_336,
    vocab_size=65_536,
    pattern=(rwkv(),),
    use_rope=False,
    rwkv_head_dim=64,
    rwkv_lora_dim=64,
    tie_embeddings=False,
)
