"""Config system for the LM substrate.

A ``ModelConfig`` fully describes one architecture: geometry, the repeating
per-layer block ``pattern`` (attention / mamba / rwkv, sliding windows, MoE),
modality stubs, and serving metadata.  One module per assigned architecture
lives next to this file; ``repro_torch.configs.get_config(name)`` resolves
them.

Input shapes are the four assigned cells (train_4k / prefill_32k / decode_32k /
long_500k); ``shape_for`` returns the concrete ``ShapeSpec`` and knows which
cells an architecture must skip (``long_500k`` on pure full-attention archs).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


# ---------------------------------------------------------------------------
# Layer specs
# ---------------------------------------------------------------------------

ATTN = "attn"
MAMBA = "mamba"
RWKV = "rwkv"


@dataclass(frozen=True)
class LayerSpec:
    """One layer inside the repeating block pattern."""

    kind: str = ATTN            # attn | mamba | rwkv
    window: Optional[int] = None  # sliding-window size (attn only); None = global
    moe: bool = False           # MoE MLP instead of dense MLP
    cross_attn: bool = False    # decoder cross-attention (enc-dec models)

    def __post_init__(self):
        assert self.kind in (ATTN, MAMBA, RWKV), self.kind


def attn(window: Optional[int] = None, moe: bool = False,
         cross_attn: bool = False) -> LayerSpec:
    return LayerSpec(kind=ATTN, window=window, moe=moe, cross_attn=cross_attn)


def mamba(moe: bool = False) -> LayerSpec:
    return LayerSpec(kind=MAMBA, moe=moe)


def rwkv() -> LayerSpec:
    return LayerSpec(kind=RWKV)


# ---------------------------------------------------------------------------
# Model config
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                 # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    d_ff: int
    vocab_size: int
    pattern: tuple = (LayerSpec(),)   # repeating unit; len divides n_layers

    # attention details
    rope_base: float = 10_000.0
    use_rope: bool = True       # False => sinusoidal absolute positions
    qk_norm: bool = False
    prefix_lm: bool = False     # bidirectional attention over the prefix

    # embeddings / head
    tie_embeddings: bool = True
    vocab_pad_multiple: int = 256

    # MoE
    n_experts: int = 0
    moe_top_k: int = 0
    n_shared_experts: int = 0
    d_ff_expert: int = 0        # defaults to d_ff
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # Mamba
    mamba_d_state: int = 16
    mamba_d_conv: int = 4
    mamba_expand: int = 2
    mamba_dt_rank: int = 0      # 0 => d_model // 16

    # RWKV-6
    rwkv_head_dim: int = 64
    rwkv_lora_dim: int = 64     # low-rank dim of the data-dependent decay MLPs

    # encoder-decoder (whisper)
    n_encoder_layers: int = 0
    encoder_seq: int = 0        # stub frontend sequence length (whisper: 1500)

    # multimodal prefix stub (paligemma: 256 patch embeddings)
    prefix_len: int = 0

    norm_eps: float = 1e-6
    # numerics
    param_dtype: str = "float32"     # master weights
    compute_dtype: str = "bfloat16"

    # ------------------------------------------------------------------
    def __post_init__(self):
        assert self.n_layers % len(self.pattern) == 0, (
            f"{self.name}: pattern of len {len(self.pattern)} does not divide "
            f"{self.n_layers} layers")
        if self.n_experts:
            assert self.moe_top_k > 0

    # -- derived geometry ------------------------------------------------
    @property
    def pattern_repeats(self) -> int:
        return self.n_layers // len(self.pattern)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def padded_vocab(self) -> int:
        return _round_up(self.vocab_size, self.vocab_pad_multiple)

    @property
    def d_ff_e(self) -> int:
        return self.d_ff_expert or self.d_ff

    @property
    def dt_rank(self) -> int:
        return self.mamba_dt_rank or max(1, self.d_model // 16)

    @property
    def d_inner(self) -> int:
        return self.mamba_expand * self.d_model

    @property
    def n_rwkv_heads(self) -> int:
        return self.d_model // self.rwkv_head_dim

    @property
    def is_enc_dec(self) -> bool:
        return self.n_encoder_layers > 0

    @property
    def is_sub_quadratic(self) -> bool:
        """True when the arch can serve very long contexts: every layer is
        either attention-free (mamba / rwkv) or sliding-window attention,
        except for a bounded number of global-attention layers whose decode
        cost is O(S) per token (gemma3-style interleave counts; a pure
        full-attention stack does not)."""
        kinds = [l.kind for l in self.pattern]
        if all(k in (MAMBA, RWKV) for k in kinds):
            return True
        n_global_attn = sum(
            1 for l in self.pattern if l.kind == ATTN and l.window is None)
        n_local = sum(
            1 for l in self.pattern
            if l.kind != ATTN or l.window is not None)
        # hybrid / local-global interleaves: most layers must be cheap
        return n_local > 0 and n_global_attn * 2 <= len(self.pattern)

    # -- parameter counting (analytical; used for 6ND and roofline) ------
    def layer_specs(self):
        """All ``n_layers`` layer specs, pattern expanded."""
        return list(self.pattern) * self.pattern_repeats

    def attn_params(self, cross: bool = False) -> int:
        p = self.d_model * self.q_dim + 2 * self.d_model * self.kv_dim
        p += self.q_dim * self.d_model
        if self.qk_norm:
            p += 2 * self.head_dim
        if cross:  # a full second attention stack against encoder states
            p += self.attn_params(cross=False)
        return p

    def dense_mlp_params(self) -> int:
        return 3 * self.d_model * self.d_ff      # swiglu: gate, up, down

    def moe_mlp_params(self) -> tuple[int, int]:
        """(total, active) MoE MLP params per layer."""
        per_exp = 3 * self.d_model * self.d_ff_e
        router = self.d_model * self.n_experts
        shared = self.n_shared_experts * 3 * self.d_model * self.d_ff
        total = self.n_experts * per_exp + router + shared
        active = self.moe_top_k * per_exp + router + shared
        return total, active

    def mamba_params(self) -> int:
        di, n, r = self.d_inner, self.mamba_d_state, self.dt_rank
        p = self.d_model * 2 * di                  # in_proj (x & gate)
        p += di * self.mamba_d_conv + di           # depthwise conv (+ bias)
        p += di * (r + 2 * n)                      # x_proj -> dt, B, C
        p += r * di + di                           # dt_proj
        p += di * n + di                           # A_log, D
        p += di * self.d_model                     # out_proj
        return p

    def rwkv_params(self) -> int:
        d, r = self.d_model, self.rwkv_lora_dim
        tm = 4 * d * d                              # r, k, v, out projections
        tm += d * d                                 # gate
        tm += 5 * (d * r + r * d)                   # ddlerp low-rank (w,k,v,r,g)
        tm += d * r + r * d                         # decay lora
        tm += 7 * d                                 # mu_x, mu_rkvwg(5d), w_base
        tm += 3 * d                                 # u bonus, group-ln w/b
        cm = 2 * d * self.d_ff                      # rwkv channel-mix: k, v
        cm += d * d + 2 * d                         # receptance, mu_k, mu_r
        return tm + cm

    def params_per_layer(self, spec: LayerSpec) -> tuple[int, int]:
        """(total, active) params of one layer, norms included."""
        norms = 2 * self.d_model
        if spec.kind == ATTN:
            mix = self.attn_params(cross=spec.cross_attn)
            if spec.cross_attn:
                norms += self.d_model
        elif spec.kind == MAMBA:
            mix = self.mamba_params()
        else:
            mix = self.rwkv_params()
        if spec.kind == RWKV:
            return mix + norms, mix + norms
        if spec.moe:
            tot, act = self.moe_mlp_params()
            return mix + tot + norms, mix + act + norms
        mlp = self.dense_mlp_params()
        return mix + mlp + norms, mix + mlp + norms

    def param_counts(self) -> tuple[int, int]:
        """(total, active) parameters of the full model."""
        tot = act = 0
        for spec in self.layer_specs():
            t, a = self.params_per_layer(spec)
            tot, act = tot + t, act + a
        emb = self.padded_vocab * self.d_model
        tot += emb
        act += emb
        if not self.tie_embeddings:
            tot += emb
            act += emb
        if self.is_enc_dec:
            enc = self.n_encoder_layers * (
                self.attn_params() + self.dense_mlp_params() + 2 * self.d_model)
            enc += self.d_model                  # encoder final norm
            tot += enc
            act += enc
        tot += self.d_model  # final norm
        act += self.d_model
        return tot, act


# ---------------------------------------------------------------------------
# Input shapes (the four assigned cells)
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    mode: str                   # "train" | "prefill" | "decode"


SHAPES = {
    "train_4k":    ShapeSpec("train_4k",    4_096,   256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32_768,  32,  "prefill"),
    "decode_32k":  ShapeSpec("decode_32k",  32_768,  128, "decode"),
    "long_500k":   ShapeSpec("long_500k",   524_288, 1,   "decode"),
}


def shape_for(cfg: ModelConfig, shape_name: str) -> Optional[ShapeSpec]:
    """Resolve a shape cell for an arch; None => documented skip."""
    spec = SHAPES[shape_name]
    if shape_name == "long_500k" and not cfg.is_sub_quadratic:
        return None             # pure full-attention arch: skip (DESIGN.md)
    return spec


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family config for CPU smoke tests."""
    # keep one pattern repetition, shrink every width
    small = dict(
        n_layers=len(cfg.pattern),
        d_model=64,
        n_heads=4,
        n_kv_heads=max(1, min(cfg.n_kv_heads, 2)),
        head_dim=16,
        d_ff=128,
        vocab_size=256,
        vocab_pad_multiple=32,
        n_experts=min(cfg.n_experts, 4) if cfg.n_experts else 0,
        moe_top_k=min(cfg.moe_top_k, 2) if cfg.n_experts else 0,
        d_ff_expert=64 if cfg.n_experts else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        mamba_d_state=8,
        mamba_dt_rank=8,
        rwkv_head_dim=16,
        rwkv_lora_dim=8,
        n_encoder_layers=2 if cfg.is_enc_dec else 0,
        encoder_seq=16 if cfg.is_enc_dec else 0,
        prefix_len=4 if cfg.prefix_len else 0,
        name=cfg.name + "-reduced",
    )
    small.update(overrides)
    return dataclasses.replace(cfg, **small)
