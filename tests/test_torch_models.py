"""The port's LM (``repro_torch.models``) against the JAX package, on the
CPU, for all ten architectures at ``reduced()`` width.

Weights are made once per case with numpy from a seed, in the JAX
package's schema and its init's distributions (norm scales and other
zero-initialized vectors drawn small and nonzero, so they matter), and
go to the port through ``params_from_reference``.  In float32 compute
the port's hidden states, logits, loss, prefill logits and cache and 4
decode steps agree with the reference within rtol 1e-4 / atol 1e-5 (the
two frameworks sum matrix products in different orders); in bfloat16
compute within rtol = atol = 5e-2 (a bf16 rounding of an intermediate
may land on either side in the two)."""

import dataclasses
import math
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models import build_model as ref_build_model  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import moe as ref_moe  # noqa: E402
from repro.models import transformer as ref_T  # noqa: E402

from repro_torch.configs import (  # noqa: E402
    ARCHITECTURES, get_config, reduced)
from repro_torch.models import build_model, layers, moe  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
CHUNKS = dict(q_chunk=8, kv_chunk=8, mamba_chunk=8, rwkv_chunk=8,
              loss_chunk=8)
RTOL, ATOL = 1e-4, 1e-5
BF16_TOL = 5e-2
S, PROMPT, PAD = 32, 24, 32


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs: its tensors are small,
    and beside other test workers more threads only contend."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def ref_weights(cfg, seed: int = 0):
    """The reference's parameter tree as numpy arrays, from a seed."""
    rng = np.random.default_rng(seed)

    def make(s):
        shape = s.shape
        fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
        if s.init == "linear":
            a = rng.standard_normal(shape) / math.sqrt(max(1, fan_in))
        elif s.init == "embed":
            a = rng.standard_normal(shape) * 0.02
        elif s.init == "zeros":
            a = rng.standard_normal(shape) * 0.1
        elif s.init == "ones":
            a = 1.0 + rng.standard_normal(shape) * 0.1
        elif s.init == "mamba_A":
            a = np.broadcast_to(np.log(np.arange(1, shape[-1] + 1)), shape)
        else:                                   # mamba_dt: inverse softplus
            dt = np.exp(rng.uniform(math.log(1e-3), math.log(1e-1), shape))
            a = dt + np.log(-np.expm1(-dt))
        return np.asarray(a, np.float32)

    return jax.tree.map(make, ref_T.param_schema(cfg),
                        is_leaf=lambda x: isinstance(x, ref_T.PSpec))


def _local_window(cfg, window):
    """``cfg`` with every windowed layer's window set to ``window``."""
    return dataclasses.replace(cfg, pattern=tuple(
        dataclasses.replace(s, window=window if s.window else None)
        for s in cfg.pattern))


def make_pair(arch, compute="float32", rc=None, window=None, **over):
    """(reference model, its params, port model, its params) for one
    reduced config; ``over`` overrides the reduced config's fields and
    ``window`` its local layers' window."""
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  compute_dtype=compute, **over)
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype=compute, **over)
    if window is not None:
        ref_cfg, cfg = _local_window(ref_cfg, window), \
            _local_window(cfg, window)
    rc = {**CHUNKS, **(rc or {})}
    ref_model = ref_build_model(ref_cfg, rc=ref_T.RunConfig(**rc))
    model = build_model(cfg, rc=T.RunConfig(**rc), device="cpu")
    tree = ref_weights(ref_cfg)
    return (ref_model, jax.tree.map(jnp.asarray, tree), model,
            model.params_from_reference(tree))


def make_batch(cfg, B=2, seq=S, seed=0):
    rng = np.random.default_rng(seed)
    s_text = seq - cfg.prefix_len
    b = {"tokens": rng.integers(0, cfg.vocab_size,
                                (B, s_text)).astype(np.int32)}
    b["labels"] = np.roll(b["tokens"], -1, axis=1)
    b["labels"][:, -2:] = -1                     # masked positions
    if cfg.prefix_len:
        b["prefix_embed"] = (0.5 * rng.standard_normal(
            (B, cfg.prefix_len, cfg.d_model))).astype(np.float32)
    if cfg.is_enc_dec:
        b["encoder_frames"] = (0.5 * rng.standard_normal(
            (B, cfg.encoder_seq, cfg.d_model))).astype(np.float32)
    return b


def to_jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def close(got, want, rtol=RTOL, atol=ATOL, what=""):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(np.asarray(got, np.float32),
                               np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


def close_trees(got, want, rtol=RTOL, atol=ATOL):
    g = dict(T.tree_leaves_with_path(got))
    w = dict(T.tree_leaves_with_path(want))
    assert set(g) == set(w)
    for path in sorted(w):
        assert tuple(g[path].shape) == tuple(w[path].shape), path
        close(g[path], w[path], rtol, atol, path)


def prompt_batch(batch, n):
    b = {k: v for k, v in batch.items() if k != "labels"}
    b["tokens"] = batch["tokens"][:, :n]
    return b


@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_forward_prefill_decode_match_reference(arch):
    ref_model, ref_p, model, p = make_pair(arch, rc={"prefill_pad": PAD})
    cfg = model.cfg
    batch = make_batch(cfg)
    jb = to_jax(batch)

    h, aux = model.hidden_states(p, batch)
    ref_h, ref_aux = ref_model.hidden_states(ref_p, jb)
    close(h, ref_h, what="hidden")
    for name in ref_aux:
        close(aux[name], ref_aux[name], what=name)
    ref_logits = (ref_h @ ref_T.unembed(ref_p, ref_model.cfg)).astype(
        jnp.float32)                     # the reference's Model.logits
    close(model.logits(p, batch)[0], ref_logits, what="logits")
    loss, metrics = model.loss(p, batch)
    ref_loss, ref_metrics = ref_model.loss(ref_p, jb)
    close(loss, ref_loss, what="loss")
    assert set(metrics) == set(ref_metrics)
    for name in ref_metrics:
        close(metrics[name], ref_metrics[name], what=name)

    n = PROMPT - cfg.prefix_len
    pb = prompt_batch(batch, n)
    logits, cache = model.prefill(p, pb)
    ref_logits, ref_cache = ref_model.prefill(ref_p, to_jax(pb))
    close(logits, ref_logits, what="prefill logits")
    assert cache["pos"] == int(ref_cache["pos"]) == PROMPT
    close_trees(cache["blocks"], ref_cache["blocks"])

    ref_decode = jax.jit(ref_model.decode_step)
    for j in range(4):
        tok = batch["tokens"][:, n + j:n + j + 1]
        logits, cache = model.decode_step(p, cache, tok)
        ref_logits, ref_cache = ref_decode(ref_p, ref_cache, jnp.asarray(tok))
        close(logits, ref_logits, what=f"decode step {j}")
    assert cache["pos"] == int(ref_cache["pos"])
    close_trees(cache["blocks"], ref_cache["blocks"])


def test_gemma3_ring_cache_past_the_window():
    """Local layers of window 8: the prompt (12) already overruns the ring,
    and 10 decode steps wrap it again; logits and ring contents track the
    reference, and each step's logits equal the port's own forward over
    the prompt plus the tokens so far."""
    ref_model, ref_p, model, p = make_pair(
        "gemma3-12b", rc={"prefill_pad": PAD}, window=8)
    toks = make_batch(model.cfg, seq=22)["tokens"]
    logits, cache = model.prefill(p, {"tokens": toks[:, :12]})
    ref_logits, ref_cache = ref_model.prefill(ref_p,
                                              {"tokens": toks[:, :12]})
    assert cache["blocks"][0]["mix"]["k"].shape[2] == 8       # a ring
    close_trees(cache["blocks"], ref_cache["blocks"])
    ref_decode = jax.jit(ref_model.decode_step)
    for j in range(12, 22):
        tok = toks[:, j:j + 1]
        logits, cache = model.decode_step(p, cache, tok)
        ref_logits, ref_cache = ref_decode(ref_p, ref_cache, jnp.asarray(tok))
        close(logits, ref_logits, what=f"decode at {j}")
        h, _ = model.hidden_states(p, {"tokens": toks[:, :j + 1]})
        full = (h[:, -1] @ T.unembed(p, model.cfg)).float()
        close(logits, full, rtol=1e-4, atol=1e-4, what=f"forward at {j}")
    close_trees(cache["blocks"], ref_cache["blocks"])


@pytest.mark.parametrize("spec", [
    dict(causal=True), dict(causal=True, window=5),
    dict(causal=True, prefix_len=6), dict(causal=True, window=5,
                                          prefix_len=6),
    dict(causal=False), dict(causal=False, window=3)])
def test_mask_spec_equals_reference(spec):
    q = np.arange(4, 20)
    k = np.arange(0, 24)
    got = layers.MaskSpec(**spec).allowed(torch.as_tensor(q),
                                          torch.as_tensor(k))
    want = ref_layers.MaskSpec(**spec).allowed(jnp.asarray(q), jnp.asarray(k))
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_paligemma_prefix_is_bidirectional():
    """The prefix-LM mask: a change to the last prefix embedding reaches
    the first position's hidden state (the prefix attends both ways), a
    change to the last text token does not; both hidden states track the
    reference."""
    ref_model, ref_p, model, p = make_pair("paligemma-3b")
    cfg = model.cfg
    batch = make_batch(cfg)
    h0, _ = model.hidden_states(p, batch)
    moved = dict(batch, prefix_embed=batch["prefix_embed"].copy())
    moved["prefix_embed"][:, -1] += 1.0
    h1, _ = model.hidden_states(p, moved)
    close(h1, ref_model.hidden_states(ref_p, to_jax(moved))[0])
    assert not torch.allclose(h0[:, 0], h1[:, 0])
    late = dict(batch, tokens=batch["tokens"].copy())
    late["tokens"][:, -1] = (late["tokens"][:, -1] + 1) % cfg.vocab_size
    h2, _ = model.hidden_states(p, late)
    assert torch.equal(h0[:, :-1], h2[:, :-1])


def test_whisper_encoder_matches_reference():
    ref_model, ref_p, model, p = make_pair("whisper-medium")
    frames = make_batch(model.cfg)["encoder_frames"]
    got = T.encode(p["encoder"], model.cfg, torch.as_tensor(frames),
                   model.rc)
    want = ref_T.encode(ref_p["encoder"], ref_model.cfg, None,
                        jnp.asarray(frames), ref_model.rc)
    assert got.shape == (2, model.cfg.encoder_seq, model.cfg.d_model)
    close(got, want, what="encoder")


@pytest.mark.parametrize("arch,field", [("jamba-1.5-large-398b",
                                         "mamba_chunk"),
                                        ("rwkv6-7b", "rwkv_chunk")])
def test_recurrent_chunking_is_invariant(arch, field):
    """Chunks of 4, 8 and 32 give the same hidden states and prefill state
    (within f32 rounding), and chunks of 4 match the reference."""
    ref_model, ref_p, model, p = make_pair(arch, rc={field: 4})
    batch = make_batch(model.cfg)
    pb = prompt_batch(batch, PROMPT)
    h4, _ = model.hidden_states(p, batch)
    _, c4 = model.prefill(p, pb)
    close(h4, ref_model.hidden_states(ref_p, to_jax(batch))[0])
    for chunk in (8, 32):
        other = dataclasses.replace(model, rc=dataclasses.replace(
            model.rc, **{field: chunk}))
        close(other.hidden_states(p, batch)[0], h4, what=f"chunk {chunk}")
        close_trees(other.prefill(p, pb)[1]["blocks"], c4["blocks"])


@pytest.mark.parametrize("arch,window", [("smollm-135m", None),
                                         ("gemma3-12b", 6)])
def test_causal_skip_equals_dense_mask(arch, window):
    """Skipping the causally invisible (and out-of-window) kv blocks gives
    the dense mask's hidden states, and the reference's skip."""
    ref_model, ref_p, model, p = make_pair(arch, rc={"causal_skip": True},
                                           window=window)
    batch = make_batch(model.cfg)
    skip, _ = model.hidden_states(p, batch)
    dense = dataclasses.replace(model, rc=dataclasses.replace(
        model.rc, causal_skip=False))
    close(skip, dense.hidden_states(p, batch)[0])
    close(skip, ref_model.hidden_states(ref_p, to_jax(batch))[0])


def test_moe_capacity_drops_tokens_like_reference():
    """olmoe at capacity factor 0.5: tokens are dropped, and the port
    drops the same ones (equal router statistics, hidden states)."""
    ref_model, ref_p, model, p = make_pair("olmoe-1b-7b",
                                           capacity_factor=0.5)
    batch = make_batch(model.cfg)
    h, aux = model.hidden_states(p, batch)
    ref_h, ref_aux = ref_model.hidden_states(ref_p, to_jax(batch))
    assert float(aux["dropped_frac"]) > 0.1
    for name in ref_aux:
        close(aux[name], ref_aux[name], what=name)
    assert float(aux["dropped_frac"]) == float(ref_aux["dropped_frac"])
    close(h, ref_h)


def test_moe_ties_route_to_the_lower_expert():
    """A zero router makes every expert equally likely: the reference's
    top-k takes experts 0..K-1, and so must the port."""
    cfg = dataclasses.replace(reduced(get_config("olmoe-1b-7b")),
                              compute_dtype="float32", capacity_factor=8.0)
    rng = np.random.default_rng(3)
    d, E, f = cfg.d_model, cfg.n_experts, cfg.d_ff_e
    w = {"router": np.zeros((d, E), np.float32),
         "w_gate": rng.standard_normal((E, d, f)).astype(np.float32) / 8,
         "w_up": rng.standard_normal((E, d, f)).astype(np.float32) / 8,
         "w_down": rng.standard_normal((E, f, d)).astype(np.float32) / 8}
    x = rng.standard_normal((2, 6, d)).astype(np.float32)
    aux, ref_aux = {}, {}
    got = moe.moe_mlp({k: torch.as_tensor(v) for k, v in w.items()},
                      torch.as_tensor(x), cfg, aux=aux)
    want = ref_moe.moe_mlp({k: jnp.asarray(v) for k, v in w.items()},
                           jnp.asarray(x), cfg, None, aux=ref_aux)
    close(got, want)
    for name in ref_aux:
        close(aux[name], ref_aux[name], what=name)
    assert moe.capacity(1024, 8, 2, 1.25) == ref_moe.capacity(
        1024, 8, 2, 1.25) == 320


def test_bf16_compute_within_looser_tolerance():
    ref_model, ref_p, model, p = make_pair("qwen3-0.6b", compute="bfloat16",
                                           rc={"prefill_pad": PAD})
    batch = make_batch(model.cfg)
    h, _ = model.hidden_states(p, batch)
    assert h.dtype == torch.bfloat16
    close(h, ref_model.hidden_states(ref_p, to_jax(batch))[0],
          rtol=BF16_TOL, atol=BF16_TOL)
    pb = prompt_batch(batch, PROMPT)
    logits, cache = model.prefill(model.compute_params(p), pb)
    ref_logits, _ = ref_model.prefill(ref_p, to_jax(pb))
    close(logits, ref_logits, rtol=BF16_TOL, atol=BF16_TOL)
    # the weights cast once give the values cast at each use
    same, _ = model.prefill(p, pb)
    assert torch.equal(same, logits)


def test_init_reproducible_with_the_schema_shapes():
    cfg = reduced(get_config("jamba-1.5-large-398b"))
    model = build_model(cfg, device="cpu")
    a, b = model.init(7), model.init(7)
    leaves = T.tree_leaves_with_path(a)
    schema = T.tree_leaves_with_path(
        ref_T.param_schema(cfg), is_leaf=lambda x: isinstance(x, ref_T.PSpec))
    assert {pth: tuple(v.shape) for pth, v in leaves} == \
        {pth: s.shape for pth, s in schema}
    assert sum(v.numel() for _, v in leaves) == cfg.param_counts()[0]
    assert all(torch.equal(x, y) for (_, x), (_, y) in zip(
        leaves, T.tree_leaves_with_path(b)))
    g = torch.Generator().manual_seed(7)
    c = model.init(g)
    assert not torch.equal(c["embed"], a["embed"])
    # and in another process (the reference's hash()-seeded init is not)
    code = ("import torch\n"
            "from repro_torch.configs import get_config, reduced\n"
            "from repro_torch.models import build_model\n"
            "p = build_model(reduced(get_config('jamba-1.5-large-398b')),"
            " device='cpu').init(7)\n"
            "print(float(p['embed'].double().sum()),"
            " float(p['blocks'][1]['mlp']['w_up'].double().sum()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, env=dict(
                             os.environ, PYTHONPATH=str(ROOT / "src")))
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == [
        repr(float(a["embed"].double().sum())),
        repr(float(a["blocks"][1]["mlp"]["w_up"].double().sum()))]
    with pytest.raises(ValueError, match="shape"):
        tree = ref_weights(cfg)
        tree["embed"] = tree["embed"][:, :-1]
        model.params_from_reference(tree)
