"""The port's serving engine and serve launcher against the JAX package,
on the CPU.

Same weights (numpy, from a seed, through ``params_from_reference``) in
both packages; float32 compute with the engines' bf16 cache.  Token lists
must be equal: the port's engine reproduces the reference's naive greedy
loop for a single request, and the reference's own engine for a
mixed-length batch, where every slot decodes at the batch's common
position."""

import dataclasses
import json
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
from repro.models import transformer as ref_T  # noqa: E402
from repro.obs import MetricsRegistry as RefRegistry  # noqa: E402
from repro.serving.engine import Request as RefRequest  # noqa: E402
from repro.serving.engine import ServeEngine as RefEngine  # noqa: E402

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import RunConfig  # noqa: E402
from repro_torch.obs import MetricsRegistry  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

from test_torch_models import (  # noqa: E402,F401
    one_torch_thread, ref_weights)

ROOT = Path(__file__).resolve().parents[1]
RC = dict(q_chunk=8, kv_chunk=8, mamba_chunk=8, rwkv_chunk=8, loss_chunk=8)


def make_pair(arch, rc=None):
    rc = {**RC, **(rc or {})}
    ref_cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                                  compute_dtype="float32")
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    ref_model = ref_build_model(ref_cfg, rc=ref_T.RunConfig(**rc))
    model = build_model(cfg, rc=RunConfig(**rc), device="cpu")
    tree = ref_weights(ref_cfg)
    return (ref_model, jax.tree.map(jnp.asarray, tree), model,
            model.params_from_reference(tree))


def ref_naive_greedy(ref_model, params, prompt, n_new):
    """``tests/test_serving.py``'s loop: prefill with 64 slots of headroom,
    then one decode step per token."""
    model = ref_build_model(ref_model.cfg, rc=dataclasses.replace(
        ref_model.rc, prefill_pad=64))
    logits, cache = jax.jit(model.prefill)(
        params, {"tokens": jnp.asarray(prompt, jnp.int32)[None]})
    out = [int(jnp.argmax(logits[0]))]
    decode = jax.jit(model.decode_step)
    for _ in range(n_new - 1):
        logits, cache = decode(params, cache,
                               jnp.asarray([[out[-1]]], jnp.int32))
        out.append(int(jnp.argmax(logits[0])))
    return out


def naive_greedy(model, params, prompt, n_new):
    """The same loop on the port."""
    model = dataclasses.replace(model, rc=dataclasses.replace(
        model.rc, prefill_pad=64))
    logits, cache = model.prefill(params, {"tokens": prompt[None]})
    out = [int(torch.argmax(logits[0]))]
    for _ in range(n_new - 1):
        logits, cache = model.decode_step(params, cache, [[out[-1]]])
        out.append(int(torch.argmax(logits[0])))
    return out


def prompts(vocab, n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, vocab, int(rng.integers(lo, hi))).astype(
        np.int32) for _ in range(n)]


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b"])
def test_engine_matches_reference_naive_greedy_single(arch):
    ref_model, ref_p, model, p = make_pair(arch)
    prompt = prompts(model.cfg.vocab_size, 1, 12, 13, 0)[0]
    want = ref_naive_greedy(ref_model, ref_p, prompt, 6)
    assert naive_greedy(model, p, prompt, 6) == want
    eng = ServeEngine(model, p, n_slots=2, max_len=64)
    done = eng.run([Request(rid=0, prompt=prompt, max_new_tokens=6)])
    assert done[0].out_tokens == want


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b"])
def test_mixed_length_batch_equals_reference_engine(arch):
    """5 requests of 4..9 tokens over 2 slots: admissions reset the common
    decode position while other slots decode; the port's tokens are the
    reference engine's, and its metric counters the same."""
    ref_model, ref_p, model, p = make_pair(arch)
    ps = prompts(model.cfg.vocab_size, 5, 4, 10, 1)
    ref_reqs = [RefRequest(rid=i, prompt=q, max_new_tokens=5)
                for i, q in enumerate(ps)]
    reqs = [Request(rid=i, prompt=q, max_new_tokens=5)
            for i, q in enumerate(ps)]
    ref_reg, reg = RefRegistry(), MetricsRegistry()
    RefEngine(ref_model, ref_p, n_slots=2, max_len=64,
              metrics=ref_reg).run(list(ref_reqs))
    done = ServeEngine(model, p, n_slots=2, max_len=64,
                       metrics=reg).run(list(reqs))
    assert len(done) == 5
    assert [r.out_tokens for r in reqs] == [r.out_tokens for r in ref_reqs]
    assert len({len(q) for q in ps}) > 1
    snap, ref_snap = reg.snapshot(), ref_reg.snapshot()
    assert snap["counters"] == ref_snap["counters"]
    assert set(snap["histograms"]) == set(ref_snap["histograms"]) == \
        {"serve.request_latency_s"}
    assert snap["histograms"]["serve.request_latency_s"]["count"] == 5


def test_engine_rejects_prompt_exceeding_max_len():
    ref_model, ref_p, model, p = make_pair("smollm-135m")
    ps = prompts(model.cfg.vocab_size, 3, 40, 49, 2)
    reg, ref_reg = MetricsRegistry(), RefRegistry()
    eng = ServeEngine(model, p, n_slots=2, max_len=32, metrics=reg)
    ref_eng = RefEngine(ref_model, ref_p, n_slots=2, max_len=32,
                        metrics=ref_reg)
    too_long = Request(rid=0, prompt=ps[0], max_new_tokens=4)
    ref_too_long = RefRequest(rid=0, prompt=ps[0], max_new_tokens=4)
    assert not eng.admit(too_long) and not ref_eng.admit(ref_too_long)
    assert too_long.done and too_long.out_tokens == []
    assert too_long.error == ref_too_long.error is not None
    ok = Request(rid=1, prompt=ps[1][:8], max_new_tokens=4)
    reject2 = Request(rid=2, prompt=ps[2], max_new_tokens=4)
    done = eng.run([reject2, ok])
    assert len(done) == 2 and reject2.out_tokens == []
    assert ok.error is None and len(ok.out_tokens) == 4
    assert reg.counter("serve.rejected").value == 2.0
    assert ref_reg.counter("serve.rejected").value == 1.0


def test_serve_launcher_runs_on_the_cpu(tmp_path):
    out_json = tmp_path / "m.json"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--device", "cpu",
         "--requests", "4", "--max-new", "4", "--d-model", "64",
         "--metrics-out", str(out_json)],
        env=env, cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "[serve] 4 requests, 16 tokens" in out.stdout
    assert "serve.tokens=12" in out.stdout
    snap = json.loads(out_json.read_text())
    assert snap["counters"]["serve.requests"] == 4


def test_build_model_and_engine_default_to_the_card():
    cfg = dataclasses.replace(reduced(get_config("smollm-135m")),
                              compute_dtype="float32")
    if torch.cuda.is_available():
        model = build_model(cfg)
        assert model.device.type == "cuda"
        eng = ServeEngine(model, model.init(0), n_slots=2, max_len=16)
        assert eng.cache["blocks"][0]["mix"]["k"].device.type == "cuda"
        return
    with pytest.raises(RuntimeError, match="CUDA"):
        build_model(cfg)
    model = build_model(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="CUDA"):
        model.init(0, device="cuda")
    eng = ServeEngine(model, model.init(0), n_slots=2, max_len=16)
    assert eng.device.type == "cpu"
    assert eng.cache["blocks"][0]["mix"]["k"].device.type == "cpu"
    from repro_torch.launch.serve import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--requests", "1", "--max-new", "2", "--d-model", "64"])
