"""whisper-medium — encoder-decoder audio model; conv frontend is a STUB.

24L (enc) + 24L (dec) d_model=1024 16H (MHA) head_dim=64 d_ff=4096
vocab=51865 [arXiv:2212.04356]

``input_specs()`` supplies 1500 precomputed mel-frame embeddings
(B, 1500, d_model) in place of the conv1d frontend.  Decoder layers carry
cross-attention against the encoder output.  Absolute (sinusoidal)
positions, no RoPE.  Full attention both sides => long_500k skipped.
"""

from repro_torch.configs.base import ModelConfig, attn

CONFIG = ModelConfig(
    name="whisper-medium",
    family="audio",
    n_layers=24,                     # decoder layers
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    head_dim=64,
    d_ff=4096,
    vocab_size=51_865,
    pattern=(attn(cross_attn=True),),
    use_rope=False,
    n_encoder_layers=24,
    encoder_seq=1500,
    tie_embeddings=True,
)
