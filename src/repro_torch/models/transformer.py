"""Model assembly: schema-driven parameters, stacked blocks, and the three
execution paths (train forward, prefill, decode).

Parameters are described by a *schema* tree of ``PSpec(shape, dims, init)``
leaves — the single source of truth for random init and for the shapes
``params_from_reference`` checks.  The tree is the JAX package's: a dict
with ``embed``, ``blocks`` (a list over pattern positions), ``final_norm``
and, per config, ``lm_head`` and ``encoder``.  Every leaf of a
pattern-position subtree carries a leading ``pattern_repeats`` axis
(R, ...), and so does every cache leaf (R, B, S, ...); where the JAX
package scans over R, the port loops over it in Python.

The JAX package's sharding view of the schema is here too:
``abstract_params`` (meta tensors, no allocation), ``param_pspecs`` and
``param_logical_dims``, and for caches ``init_cache(abstract=True)``,
``cache_logical_dims`` and ``cache_pspecs``.  The execution paths take a
``rules=`` keyword (``sharding.ShardingRules``); the model reads only its
``moe_groups`` (the MoE's group-local dispatch), since every rank computes
with full tensors (``sharding.constrain`` is the identity).
"""

from __future__ import annotations

import math
import zlib
from dataclasses import dataclass
from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.configs.base import ATTN, MAMBA, RWKV, LayerSpec, ModelConfig
from repro_torch.models import layers as L
from repro_torch.models import mamba as M
from repro_torch.models import moe as MoE
from repro_torch.models import rwkv as R

F32 = torch.float32


def pick_chunk(n: int, target: int) -> int:
    """Largest divisor of n that is <= target."""
    c = min(n, target)
    while n % c:
        c -= 1
    return c


def dtype_of(name) -> torch.dtype:
    """A config's dtype name ("float32", "bfloat16") as a torch dtype (a
    torch dtype passes through)."""
    return name if isinstance(name, torch.dtype) else getattr(torch, name)


# ---------------------------------------------------------------------------
# Trees (nested dicts / lists / tuples)
# ---------------------------------------------------------------------------

def tree_map_with_path(fn: Callable, tree, *rest, is_leaf=None,
                       path: str = ""):
    """``fn(path, leaf, *same_leaf_of_rest)`` over the leaves of ``tree``;
    paths read as JAX's ``keystr`` (``['blocks'][0]['mix']['wq']``)."""
    if is_leaf is not None and is_leaf(tree):
        return fn(path, tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, v, *(r[k] for r in rest),
                                      is_leaf=is_leaf, path=f"{path}[{k!r}]")
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            tree_map_with_path(fn, v, *(r[i] for r in rest),
                               is_leaf=is_leaf, path=f"{path}[{i}]")
            for i, v in enumerate(tree))
    return fn(path, tree, *rest)


def tree_map(fn: Callable, tree, *rest, is_leaf=None):
    """``fn`` over the leaves of ``tree`` (and the same leaves of ``rest``)."""
    return tree_map_with_path(lambda _path, *leaves: fn(*leaves), tree, *rest,
                              is_leaf=is_leaf)


def tree_leaves_with_path(tree, is_leaf=None) -> list:
    """(path, leaf) pairs of ``tree`` in key order."""
    out = []
    tree_map_with_path(lambda path, leaf: out.append((path, leaf)), tree,
                       is_leaf=is_leaf)
    return out


def _at(tree, r: int):
    """Layer ``r`` of a stacked (R, ...) tree: views, no copies."""
    return tree_map(lambda a: a[r], tree)


def _unstack(tree, n: int) -> list:
    """The ``n`` layers of a stacked (R, ...) tree, each leaf unbound once
    (views, no copies): autograd then stacks the layers' gradients in
    one copy, where indexing each layer would add a zero-padded (R, ...)
    gradient per layer."""
    parts = tree_map(lambda a: a.unbind(0), tree)
    is_parts = lambda x: isinstance(x, tuple)
    return [tree_map(lambda t: t[r], parts, is_leaf=is_parts)
            for r in range(n)]


# ---------------------------------------------------------------------------
# Parameter schema
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class PSpec:
    shape: tuple
    dims: tuple
    # linear | embed | zeros | ones | mamba_A | mamba_dt
    init: str = "linear"

    def __post_init__(self):
        assert len(self.shape) == len(self.dims), (self.shape, self.dims)


def _is_pspec(x) -> bool:
    return isinstance(x, PSpec)


def _attn_schema(cfg: ModelConfig) -> dict:
    d, qd, kvd, hd = cfg.d_model, cfg.q_dim, cfg.kv_dim, cfg.head_dim
    s = {
        "wq": PSpec((d, qd), ("d", "qdim")),
        "wk": PSpec((d, kvd), ("d", "kvdim")),
        "wv": PSpec((d, kvd), ("d", "kvdim")),
        "wo": PSpec((qd, d), ("qdim", "d")),
    }
    if cfg.qk_norm:
        s["q_norm"] = PSpec((hd,), ("vec",), "zeros")
        s["k_norm"] = PSpec((hd,), ("vec",), "zeros")
    return s


def _dense_mlp_schema(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "w_gate": PSpec((d, f), ("d", "ff")),
        "w_up": PSpec((d, f), ("d", "ff")),
        "w_down": PSpec((f, d), ("ff", "d")),
    }


def _moe_schema(cfg: ModelConfig) -> dict:
    d, f, E = cfg.d_model, cfg.d_ff_e, cfg.n_experts
    s = {
        "router": PSpec((d, E), ("d", "vec")),
        "w_gate": PSpec((E, d, f), ("experts", "d", "ffe")),
        "w_up": PSpec((E, d, f), ("experts", "d", "ffe")),
        "w_down": PSpec((E, f, d), ("experts", "ffe", "d")),
    }
    if cfg.n_shared_experts:
        fs = cfg.d_ff
        s["shared_w_gate"] = PSpec((d, fs), ("d", "ff"))
        s["shared_w_up"] = PSpec((d, fs), ("d", "ff"))
        s["shared_w_down"] = PSpec((fs, d), ("ff", "d"))
    return s


def _mamba_schema(cfg: ModelConfig) -> dict:
    d, D, N, Rk, KC = (cfg.d_model, cfg.d_inner, cfg.mamba_d_state,
                       cfg.dt_rank, cfg.mamba_d_conv)
    return {
        "in_proj": PSpec((d, 2 * D), ("d", "d_inner")),
        "conv_w": PSpec((D, KC), ("d_inner", "vec")),
        "conv_b": PSpec((D,), ("d_inner",), "zeros"),
        "x_proj": PSpec((D, Rk + 2 * N), ("d_inner", "vec")),
        "dt_proj": PSpec((Rk, D), ("vec", "d_inner")),
        "dt_bias": PSpec((D,), ("d_inner",), "mamba_dt"),
        "A_log": PSpec((D, N), ("d_inner", "vec"), "mamba_A"),
        "D_skip": PSpec((D,), ("d_inner",), "ones"),
        "out_proj": PSpec((D, d), ("d_inner", "d")),
    }


def _rwkv_tm_schema(cfg: ModelConfig) -> dict:
    d, r = cfg.d_model, cfg.rwkv_lora_dim
    return {
        "mu_x": PSpec((d,), ("vec",), "zeros"),
        "mu_rkvwg": PSpec((5, d), ("vec", "d"), "zeros"),
        "lora_mix_A": PSpec((d, 5 * r), ("d", "vec")),
        "lora_mix_B": PSpec((5, r, d), ("vec", "lora", "d")),
        "Wr": PSpec((d, d), ("d", "rflat")),
        "Wk": PSpec((d, d), ("d", "rflat")),
        "Wv": PSpec((d, d), ("d", "rflat")),
        "Wg": PSpec((d, d), ("d", "rflat")),
        "Wo": PSpec((d, d), ("rflat", "d")),
        "w_base": PSpec((d,), ("vec",), "zeros"),
        "lora_w_A": PSpec((d, r), ("d", "lora")),
        "lora_w_B": PSpec((r, d), ("lora", "d")),
        "u_bonus": PSpec((d,), ("vec",), "zeros"),
        "ln_w": PSpec((d,), ("vec",), "ones"),
        "ln_b": PSpec((d,), ("vec",), "zeros"),
    }


def _rwkv_cm_schema(cfg: ModelConfig) -> dict:
    d, f = cfg.d_model, cfg.d_ff
    return {
        "mu_k": PSpec((d,), ("vec",), "zeros"),
        "mu_r": PSpec((d,), ("vec",), "zeros"),
        "Wk": PSpec((d, f), ("d", "ff")),
        "Wv": PSpec((f, d), ("ff", "d")),
        "Wr": PSpec((d, d), ("d", "rflat")),
    }


def _block_schema(cfg: ModelConfig, spec: LayerSpec) -> dict:
    d = cfg.d_model
    s = {"norm_mix": PSpec((d,), ("vec",), "zeros"),
         "norm_mlp": PSpec((d,), ("vec",), "zeros")}
    if spec.kind == ATTN:
        s["mix"] = _attn_schema(cfg)
    elif spec.kind == MAMBA:
        s["mix"] = _mamba_schema(cfg)
    else:
        s["mix"] = _rwkv_tm_schema(cfg)
    if spec.cross_attn:
        s["norm_cross"] = PSpec((d,), ("vec",), "zeros")
        s["cross"] = _attn_schema(cfg)
    if spec.kind == RWKV:
        s["mlp"] = _rwkv_cm_schema(cfg)
    elif spec.moe:
        s["mlp"] = _moe_schema(cfg)
    else:
        s["mlp"] = _dense_mlp_schema(cfg)
    return s


def _stack(schema, n: int):
    return tree_map(lambda p: PSpec((n,) + p.shape, ("layers",) + p.dims,
                                    p.init), schema, is_leaf=_is_pspec)


def param_schema(cfg: ModelConfig) -> dict:
    d, V = cfg.d_model, cfg.padded_vocab
    Rn = cfg.pattern_repeats
    schema = {
        "embed": PSpec((V, d), ("vocab", "d"), "embed"),
        "blocks": [_stack(_block_schema(cfg, s), Rn) for s in cfg.pattern],
        "final_norm": PSpec((d,), ("vec",), "zeros"),
    }
    if not cfg.tie_embeddings:
        schema["lm_head"] = PSpec((d, V), ("d", "vocab"))
    if cfg.is_enc_dec:
        enc_block = {
            "norm_mix": PSpec((d,), ("vec",), "zeros"),
            "norm_mlp": PSpec((d,), ("vec",), "zeros"),
            "mix": _attn_schema(cfg),
            "mlp": _dense_mlp_schema(cfg),
        }
        schema["encoder"] = {
            "blocks": [_stack(enc_block, cfg.n_encoder_layers)],
            "final_norm": PSpec((d,), ("vec",), "zeros"),
        }
    return schema


# -- schema consumers -------------------------------------------------------

def leaf_seed(seed: int, path: str) -> int:
    """A leaf's generator seed: the model seed and a stable hash of the
    leaf's path (CRC-32), the same in every process.  (The JAX package
    folds in Python's ``hash`` of the path, which changes from process
    to process unless ``PYTHONHASHSEED`` is set.)"""
    return (seed * 0x9E3779B1 + zlib.crc32(path.encode())) % (2 ** 63)


def init_params(cfg: ModelConfig, seed=0, device="cpu") -> dict:
    """Random parameters from ``seed`` (an int or a ``torch.Generator``,
    from which one int is drawn), made on ``device`` by one generator per
    leaf seeded by :func:`leaf_seed`: the same seed gives the same
    weights on every run on the same kind of device."""
    if isinstance(seed, torch.Generator):
        seed = int(torch.randint(0, 2 ** 62, (1,), generator=seed))
    dev = torch.device(device)
    dtype = dtype_of(cfg.param_dtype)

    def make(path, spec: PSpec):
        g = torch.Generator(device=dev).manual_seed(leaf_seed(seed, path))
        fan_in = spec.shape[-2] if len(spec.shape) >= 2 else spec.shape[-1]
        if spec.init == "linear":
            return (torch.randn(spec.shape, generator=g, dtype=dtype,
                                device=dev) / math.sqrt(max(1, fan_in)))
        if spec.init == "embed":
            return torch.randn(spec.shape, generator=g, dtype=dtype,
                               device=dev) * 0.02
        if spec.init == "zeros":
            return torch.zeros(spec.shape, dtype=dtype, device=dev)
        if spec.init == "ones":
            return torch.ones(spec.shape, dtype=dtype, device=dev)
        if spec.init == "mamba_A":
            a = torch.arange(1, spec.shape[-1] + 1, dtype=F32,
                             device=dev).expand(spec.shape)
            return torch.log(a).to(dtype).contiguous()
        if spec.init == "mamba_dt":
            u = torch.empty(spec.shape, dtype=F32, device=dev).uniform_(
                math.log(1e-3), math.log(1e-1), generator=g)
            dt = torch.exp(u)
            # inverse softplus
            return (dt + torch.log(-torch.expm1(-dt))).to(dtype)
        raise ValueError(spec.init)

    return tree_map_with_path(make, param_schema(cfg), is_leaf=_is_pspec)


def params_from_reference(cfg: ModelConfig, tree, device="cpu") -> dict:
    """The JAX package's parameter tree, as numpy arrays (``jax.tree.map(
    np.asarray, params)``), as the port's tree on ``device``: the same
    dict / list structure, the stacked (R, ...) leaves and the blocks list
    over pattern positions as they are, each leaf checked against the
    schema's shape and cast to ``param_dtype``."""
    dtype = dtype_of(cfg.param_dtype)
    dev = torch.device(device)

    def take(path: str, spec: PSpec, leaf):
        a = torch.from_numpy(np.array(leaf))
        if tuple(a.shape) != spec.shape:
            raise ValueError(f"{path}: shape {tuple(a.shape)}, schema "
                             f"{spec.shape}")
        return a.to(device=dev, dtype=dtype)

    schema = param_schema(cfg)
    n_ref = len(tree_leaves_with_path(tree))
    n_port = len(tree_leaves_with_path(schema, is_leaf=_is_pspec))
    if n_ref != n_port:
        raise ValueError(f"reference tree has {n_ref} leaves, the schema "
                         f"{n_port}")
    return tree_map_with_path(take, schema, tree, is_leaf=_is_pspec)


def abstract_params(cfg: ModelConfig, dtype=None) -> dict:
    """The parameter tree as meta tensors (shapes and dtype, no storage):
    the dry-run's stand-in.  ``dtype`` defaults to ``param_dtype``."""
    dt = dtype_of(dtype or cfg.param_dtype)
    return tree_map(lambda s: torch.empty(s.shape, dtype=dt, device="meta"),
                    param_schema(cfg), is_leaf=_is_pspec)


def param_pspecs(cfg: ModelConfig, rules) -> dict:
    """PartitionSpec tree mirroring the params."""
    return tree_map(lambda s: rules.pspec(s.dims, s.shape),
                    param_schema(cfg), is_leaf=_is_pspec)


def param_logical_dims(cfg: ModelConfig) -> dict:
    return tree_map(lambda s: s.dims, param_schema(cfg), is_leaf=_is_pspec)


# Leaves the model reads in f32 whatever the compute dtype (norm scales,
# the SSM's decay and skip, RWKV's decay, bonus and group norm).
_F32_LEAVES = frozenset({
    "norm_mix", "norm_mlp", "norm_cross", "final_norm", "q_norm", "k_norm",
    "A_log", "D_skip", "w_base", "u_bonus", "ln_w", "ln_b"})


def compute_params(cfg: ModelConfig, params) -> dict:
    """The tree with every leaf the model only reads in the compute dtype
    cast to it once, the f32 leaves kept: each use's cast is then a
    no-op and gives the same values as casting the master weight there."""
    dt = dtype_of(cfg.compute_dtype)
    return {k: _cast_leaves(k, v, dt) for k, v in params.items()}


def _cast_leaves(name, node, dt):
    if isinstance(node, dict):
        return {k: _cast_leaves(k, v, dt) for k, v in node.items()}
    if isinstance(node, (list, tuple)):
        return type(node)(_cast_leaves(name, v, dt) for v in node)
    return node if name in _F32_LEAVES else node.to(dt)


# ---------------------------------------------------------------------------
# Execution knobs
# ---------------------------------------------------------------------------

@dataclass(frozen=True)
class RunConfig:
    """The JAX package's execution knobs.  Three concern the backward
    pass and act only where autograd records (``train.step``), never
    under ``torch.no_grad``:

    * ``remat``: :func:`forward` checkpoints each repeat of the
      super-block (and :func:`encode` each encoder layer), keeping only
      its input and recomputing the rest in backward;
    * ``remat_policy``: ``"full"`` recomputes everything, ``"dots"``
      also keeps the outputs of plain matrix products (``layers.remat``);
    * ``microbatch``: ``train.step.make_train_step`` splits the batch
      into this many pieces and carries their mean gradient in f32.

    The loss's cross-entropy chunks and the Mamba and RWKV chunk steps are
    checkpointed whatever ``remat`` says, as in the JAX package."""
    q_chunk: int = 512
    kv_chunk: int = 1024
    mamba_chunk: int = 256
    rwkv_chunk: int = 256
    loss_chunk: int = 256
    remat: bool = True
    microbatch: int = 0          # 0 = no gradient accumulation
    prefill_pad: int = 0         # pad prefill KV caches to this many slots
                                 # (0 = exactly the prompt; decode then has
                                 # no headroom)
    causal_skip: bool = False    # static causal block skipping in flash
    remat_policy: str = "full"   # full | dots (save matmul outputs)


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _apply_mix(p, x, cfg, spec, rc: RunConfig, *, positions,
               cache=None, pos=None, collect=False):
    """Mixer sublayer dispatch. Returns (out, cache_out)."""
    if spec.kind == ATTN:
        return L.attention_layer(
            p, x, cfg, spec, positions=positions, cache=cache, pos=pos,
            q_chunk=pick_chunk(x.shape[1], rc.q_chunk),
            kv_chunk=rc.kv_chunk, collect_kv=collect,
            pad_to=rc.prefill_pad, causal_skip=rc.causal_skip)
    if spec.kind == MAMBA:
        return M.mamba_mixer(p, x, cfg, state=cache,
                             chunk=pick_chunk(x.shape[1], rc.mamba_chunk),
                             collect_state=collect)
    return R.rwkv_time_mix(p, x, cfg, state=cache,
                           chunk=pick_chunk(x.shape[1], rc.rwkv_chunk),
                           collect_state=collect)


def apply_block(bp, x, cfg, spec: LayerSpec, rc: RunConfig, *,
                positions, encoder_out=None, cache=None, pos=None,
                aux=None, collect=False, rules=None):
    """One block: mixer + (cross) + mlp with pre-norms and residuals.

    Returns (x, cache_out) — cache_out has the layer-cache structure when
    ``collect`` or ``cache`` is given, else None.
    """
    eps = cfg.norm_eps
    h = L.rms_norm(x, bp["norm_mix"], eps)
    mix_cache = None if cache is None else cache.get("mix")
    mix, mix_cache_out = _apply_mix(
        bp["mix"], h, cfg, spec, rc, positions=positions,
        cache=mix_cache, pos=pos, collect=collect)
    x = x + mix

    cross_cache_out = None
    if spec.cross_attn:
        h = L.rms_norm(x, bp["norm_cross"], eps)
        cross_cache = None if cache is None else cache.get("cross")
        cr, cross_cache_out = L.attention_layer(
            bp["cross"], h, cfg, spec, positions=positions,
            kv_x=encoder_out, cache=cross_cache, pos=pos,
            is_cross=(cache is not None and encoder_out is None),
            q_chunk=pick_chunk(x.shape[1], rc.q_chunk),
            kv_chunk=rc.kv_chunk, collect_kv=collect)
        x = x + cr

    h = L.rms_norm(x, bp["norm_mlp"], eps)
    mlp_cache_out = None
    if spec.kind == RWKV:
        cm_cache = None if cache is None else cache.get("mlp")
        mlp, mlp_cache_out = R.rwkv_channel_mix(
            bp["mlp"], h, cfg, state=cm_cache, collect_state=collect)
    elif spec.moe:
        mlp = MoE.moe_mlp(bp["mlp"], h, cfg, rules=rules, aux=aux)
    else:
        mlp = L.swiglu_mlp(bp["mlp"], h)
    x = x + mlp

    cache_out = None
    if (cache is not None) or collect:
        cache_out = {"mix": mix_cache_out}
        if spec.cross_attn:
            cache_out["cross"] = cross_cache_out
        if spec.kind == RWKV:
            cache_out["mlp"] = mlp_cache_out
    return x, cache_out


def _stack_layers(per_layer: list):
    """Per-layer cache trees -> one tree of stacked (R, ...) leaves (None
    for a config of no layers, which the dry-run traces)."""
    if not per_layer:
        return None
    return tree_map(lambda *xs: torch.stack(xs), per_layer[0], *per_layer[1:])


def _restack(old, per_layer: list):
    """The stacked cache after a decode step.  A leaf whose new per-layer
    values keep its dtype is written into it in place (an attention
    cache's step was written there already); one whose dtype changed (a
    recurrent state the cache held in bf16, now in the compute dtype, as
    the JAX package's step returns it) is stacked anew."""
    def one(o, *news):
        if all(n.dtype == o.dtype for n in news):
            for r, n in enumerate(news):
                if n.data_ptr() != o[r].data_ptr():
                    o[r].copy_(n)
            return o
        return torch.stack(news)
    return tree_map(one, old, *per_layer)


# ---------------------------------------------------------------------------
# Encoder (whisper)
# ---------------------------------------------------------------------------

def encode(params, cfg: ModelConfig, frames, rc: RunConfig):
    """frames: (B, F, d) precomputed frontend embeddings (stub)."""
    B, Fr, d = frames.shape
    positions = torch.arange(Fr, device=frames.device)
    x = frames + L.sinusoidal_embedding(positions, d)[None].to(frames.dtype)
    enc_spec = LayerSpec(kind=ATTN)

    def body(x, bp):
        h = L.rms_norm(x, bp["norm_mix"], cfg.norm_eps)
        mix, _ = L.attention_layer(
            bp["mix"], h, cfg, enc_spec, positions=positions,
            causal=False, q_chunk=pick_chunk(Fr, rc.q_chunk),
            kv_chunk=pick_chunk(Fr, rc.kv_chunk))
        x = x + mix
        h = L.rms_norm(x, bp["norm_mlp"], cfg.norm_eps)
        return x + L.swiglu_mlp(bp["mlp"], h)

    for bp in _unstack(params["blocks"][0], cfg.n_encoder_layers):
        x = L.remat(body, x, bp) if rc.remat else body(x, bp)
    return L.rms_norm(x, params["final_norm"], cfg.norm_eps)


# ---------------------------------------------------------------------------
# Forward (train / prefill)
# ---------------------------------------------------------------------------

def embed_tokens(params, cfg, tokens, dtype):
    # the backward sums each row's repeats in one fixed order (F.embedding
    # sorts, then sums segments), so a replayed step reproduces it bitwise
    return F.embedding(tokens, params["embed"].to(dtype))


_AUX = ("load_balance", "router_z", "dropped_frac")


def forward(params, cfg: ModelConfig, tokens, *, rc: RunConfig,
            prefix_embed=None, encoder_frames=None, collect_cache=False,
            rules=None):
    """tokens: (B, S_text).  Returns (hidden (B,S,d), aux, caches|None).

    S = prefix_len + S_text for VLM configs (prefix embeddings prepended).
    """
    dt = dtype_of(cfg.compute_dtype)
    x = embed_tokens(params, cfg, tokens, dt)
    if cfg.prefix_len:
        assert prefix_embed is not None
        x = torch.cat([prefix_embed.to(dt), x], dim=1)
    B, S, d = x.shape
    dev = x.device
    positions = torch.arange(S, device=dev)
    if not cfg.use_rope and not cfg.is_enc_dec:
        x = x + L.sinusoidal_embedding(positions, d)[None].to(dt)

    encoder_out = None
    if cfg.is_enc_dec:
        assert encoder_frames is not None
        encoder_out = encode(params["encoder"], cfg, encoder_frames.to(dt),
                             rc)
        x = x + L.sinusoidal_embedding(positions, d)[None].to(dt)

    aux = tuple(torch.zeros((), dtype=F32, device=dev) for _ in _AUX)
    layers = [_unstack(b, cfg.pattern_repeats) for b in params["blocks"]]

    # the pattern repeats in order; each applies the whole super-block in
    # pattern order (gemma3: 5 local + 1 global; jamba: 1 attn + 7 mamba)
    def superblock(r, x, *aux):
        aux = dict(zip(_AUX, aux))
        outs = []
        for i, spec in enumerate(cfg.pattern):
            x, cache_out = apply_block(
                layers[i][r], x, cfg, spec, rc, positions=positions,
                encoder_out=encoder_out, aux=aux, collect=collect_cache,
                rules=rules)
            outs.append(cache_out)
        return x, tuple(aux[n] for n in _AUX), outs

    caches = [[] for _ in cfg.pattern]
    for r in range(cfg.pattern_repeats):
        if rc.remat and not collect_cache:
            x, aux, outs = L.remat(superblock, r, x, *aux,
                                   dots=rc.remat_policy == "dots")
        else:
            x, aux, outs = superblock(r, x, *aux)
        for i, c in enumerate(outs):
            caches[i].append(c)
    aux = dict(zip(_AUX, aux))

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    if not collect_cache:
        return x, aux, None
    cache = {"blocks": [_stack_layers(c) for c in caches], "pos": S}
    if cfg.is_enc_dec:
        cache["encoder_out"] = encoder_out
    return x, aux, cache


# ---------------------------------------------------------------------------
# Loss (chunked cross-entropy, each chunk checkpointed)
# ---------------------------------------------------------------------------

def unembed(params, cfg):
    if cfg.tie_embeddings:
        return params["embed"].T      # (d, V)
    return params["lm_head"]


def _ce_chunk(xi, yi, head):
    """(summed cross-entropy, label count) of one chunk; labels < 0 are
    masked."""
    logits = (xi @ head).float()                      # (B, cs, V)
    lse = torch.logsumexp(logits, dim=-1)
    safe = torch.clamp_min(yi, 0)
    gold = torch.gather(logits, -1, safe[..., None].long())[..., 0]
    mask = (yi >= 0).float()
    return ((lse - gold) * mask).sum(), mask.sum()


def lm_loss(params, cfg: ModelConfig, batch, rc: RunConfig, *,
            rules=None):
    """batch: dict(tokens, labels[, prefix_embed, encoder_frames]).

    labels < 0 are masked.  Returns (loss, metrics).  With
    ``rules.batch`` (the sharded step's batch ranks, each holding a slice
    of the batch) the loss and metrics are the whole batch's on every
    rank, and the gradient is this slice's part of the whole batch's.
    """
    x, aux, _ = forward(
        params, cfg, batch["tokens"], rc=rc,
        prefix_embed=batch.get("prefix_embed"),
        encoder_frames=batch.get("encoder_frames"), rules=rules)
    B, S, d = x.shape
    labels = batch["labels"]
    if cfg.prefix_len:      # prefix positions carry no LM loss
        pad = torch.full((B, cfg.prefix_len), -1, dtype=labels.dtype,
                         device=labels.device)
        labels = torch.cat([pad, labels], dim=1)
    head = unembed(params, cfg).to(x.dtype)

    cs = pick_chunk(S, rc.loss_chunk)
    tot = torch.zeros((), dtype=F32, device=x.device)
    cnt = torch.zeros((), dtype=F32, device=x.device)
    # each chunk's (B, cs, V) f32 logits live only inside the chunk: the
    # backward recomputes them (the JAX package's jax.checkpoint(ce_chunk))
    for lo in range(0, S, cs):
        t, c = L.remat(_ce_chunk, x[:, lo:lo + cs], labels[:, lo:lo + cs],
                       head)
        tot = tot + t
        cnt = cnt + c
    group = getattr(rules, "batch", None)
    if group is not None:       # the mean over every rank's labels
        tot, cnt = group.total(tot), group.sum(cnt)
    ce = tot / torch.clamp_min(cnt, 1.0)
    loss = ce
    if cfg.n_experts:
        loss = loss + cfg.router_aux_weight * aux["load_balance"] \
            + 1e-3 * aux["router_z"]
    metrics = {"ce": ce, "tokens": cnt, **aux}
    return loss, metrics


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cpu", abstract: bool = False):
    """Cache tree for decoding; leaves stacked over pattern repeats.
    ``pos`` is a Python int (the JAX package's is an int32 scalar).
    ``abstract=True`` gives meta tensors, without any allocation (the
    dry-run's path: a 500k-context cache never touches memory)."""
    Rn = cfg.pattern_repeats
    dev = torch.device("meta" if abstract else device)

    def one(spec: LayerSpec):
        c = {}
        if spec.kind == ATTN:
            c["mix"] = L.init_attn_cache(cfg, spec, batch, max_len, dtype,
                                         dev)
        elif spec.kind == MAMBA:
            c["mix"] = M.init_mamba_state(cfg, batch, dtype, dev)
        else:
            c["mix"] = R.init_rwkv_state(cfg, batch, dtype, dev)
            c["mlp"] = {"shift_cm": torch.zeros(
                (batch, 1, cfg.d_model), dtype=dtype, device=dev)}
        if spec.cross_attn:
            K, Dh = cfg.n_kv_heads, cfg.head_dim
            c["cross"] = {
                "k": torch.zeros((batch, cfg.encoder_seq, K, Dh),
                                 dtype=dtype, device=dev),
                "v": torch.zeros((batch, cfg.encoder_seq, K, Dh),
                                 dtype=dtype, device=dev)}
        return c

    blocks = [tree_map(lambda a: a.expand((Rn,) + a.shape).contiguous(),
                       one(s)) for s in cfg.pattern]
    cache = {"blocks": blocks, "pos": 0}
    if cfg.is_enc_dec:
        cache["encoder_out"] = torch.zeros(
            (batch, cfg.encoder_seq, cfg.d_model), dtype=dtype, device=dev)
    return cache


def cache_logical_dims(cfg: ModelConfig) -> dict:
    """Logical-dim tree mirroring ``init_cache`` (drives cache sharding)."""
    def one(spec: LayerSpec):
        c = {}
        if spec.kind == ATTN:
            c["mix"] = {"k": ("batch", "cache_seq", "kvheads", "hd"),
                        "v": ("batch", "cache_seq", "kvheads", "hd")}
        elif spec.kind == MAMBA:
            c["mix"] = {"conv": ("batch", "vec", "d_inner"),
                        "ssm": ("batch", "d_inner", "vec")}
        else:
            c["mix"] = {"shift_tm": ("batch", "vec", "vec"),
                        "wkv": ("batch", "rheads", "vec", "vec")}
            c["mlp"] = {"shift_cm": ("batch", "vec", "vec")}
        if spec.cross_attn:
            c["cross"] = {"k": ("batch", "frames", "kvheads", "hd"),
                          "v": ("batch", "frames", "kvheads", "hd")}
        return c

    blocks = [tree_map(lambda dims: ("layers",) + dims, one(s),
                       is_leaf=_is_dims) for s in cfg.pattern]
    dims = {"blocks": blocks, "pos": ()}
    if cfg.is_enc_dec:
        dims["encoder_out"] = ("batch", "frames", "vec")
    return dims


def _is_dims(x) -> bool:
    """A tuple of logical dim names (``()`` included): a leaf of a dims
    tree."""
    return isinstance(x, tuple) and all(isinstance(e, str) for e in x)


def cache_pspecs(cfg: ModelConfig, rules, cache) -> dict:
    """PartitionSpec tree for a cache tree (``pos`` gets ``P()``)."""
    return tree_map(lambda dm, leaf: rules.pspec(dm, tuple(getattr(
        leaf, "shape", ()))), cache_logical_dims(cfg), cache,
        is_leaf=_is_dims)


def decode_step(params, cfg: ModelConfig, cache, token, *, rc: RunConfig,
                rules=None):
    """One decode step.  token: (B, 1) int.  Returns (logits, new_cache).

    The step is written into the cache's tensors in place where their
    dtype allows (see :func:`_restack`), so the cache passed in is the
    cache returned, one position further."""
    dt = dtype_of(cfg.compute_dtype)
    x = embed_tokens(params, cfg, token, dt)            # (B, 1, d)
    pos = int(cache["pos"])
    positions = torch.arange(pos, pos + 1, device=x.device)
    if not cfg.use_rope:
        x = x + L.sinusoidal_embedding(positions, cfg.d_model)[None].to(dt)

    new_cs = [[] for _ in cfg.pattern]
    for r in range(cfg.pattern_repeats):
        for i, spec in enumerate(cfg.pattern):
            x, cache_out = apply_block(
                _at(params["blocks"][i], r), x, cfg, spec, rc,
                positions=positions, cache=_at(cache["blocks"][i], r),
                pos=pos, rules=rules)
            new_cs[i].append(cache_out)
    new_blocks = [_restack(old, new) for old, new in
                  zip(cache["blocks"], new_cs)]

    x = L.rms_norm(x, params["final_norm"], cfg.norm_eps)
    logits = (x @ unembed(params, cfg).to(dt)).float()
    new_cache = dict(cache, blocks=new_blocks, pos=pos + 1)
    return logits[:, 0], new_cache


def prefill(params, cfg: ModelConfig, tokens, *, rc: RunConfig,
            prefix_embed=None, encoder_frames=None, rules=None):
    """Run the full prompt, return (last-position logits, cache)."""
    x, _, cache = forward(
        params, cfg, tokens, rc=rc, prefix_embed=prefix_embed,
        encoder_frames=encoder_frames, collect_cache=True, rules=rules)
    logits = (x[:, -1:] @ unembed(params, cfg).to(x.dtype)).float()
    return logits[:, 0], cache
