"""The port's LM on the card against the same weights on the CPU.

JAX-free, so it runs on a machine with a card and no JAX; it skips
where there is no card.  Prefill and decode logits agree within rtol
1e-4 / atol 1e-5 (f32, TF32 off: torch's default), and a ServeEngine
wave of mixed-length prompts gives the same tokens on both devices."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from repro_torch.models.transformer import RunConfig, tree_map  # noqa: E402
from repro_torch.serving import Request, ServeEngine  # noqa: E402

RC = RunConfig(q_chunk=8, kv_chunk=8, mamba_chunk=8, rwkv_chunk=8,
               loss_chunk=8, prefill_pad=32)


@pytest.fixture
def cuda():
    """The card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the model runs there by default")
    return torch.device("cuda")


def _models(arch, cuda):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    cpu = build_model(cfg, rc=RC, device="cpu")
    params = cpu.init(0)
    return (cpu, params, dataclasses.replace(cpu, device=cuda),
            tree_map(lambda a: a.to(cuda), params))


def _close(got, want):
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-4,
                               atol=1e-5)


@pytest.mark.parametrize("arch", ["smollm-135m", "gemma3-12b",
                                  "jamba-1.5-large-398b", "olmoe-1b-7b",
                                  "rwkv6-7b"])
def test_prefill_and_decode_on_card(arch, cuda):
    cpu, p, card, p_card = _models(arch, cuda)
    rng = np.random.default_rng(0)
    tokens = rng.integers(0, cpu.cfg.vocab_size, (2, 24)).astype(np.int32)
    (want, c_cpu) = cpu.prefill(p, {"tokens": tokens})
    (got, c_card) = card.prefill(p_card, {"tokens": tokens})
    _close(got, want)
    for _ in range(3):
        tok = torch.argmax(want, -1)[:, None]
        want, c_cpu = cpu.decode_step(p, c_cpu, tok)
        got, c_card = card.decode_step(p_card, c_card, tok)
        _close(got, want)


@pytest.mark.parametrize("arch", ["smollm-135m", "rwkv6-7b"])
def test_engine_wave_on_card(arch, cuda):
    cpu, p, card, p_card = _models(arch, cuda)
    rng = np.random.default_rng(1)
    prompts = [rng.integers(0, cpu.cfg.vocab_size, int(n)).astype(np.int32)
               for n in rng.integers(4, 10, 5)]
    outs = []
    for model, params in ((cpu, p), (card, p_card)):
        reqs = [Request(rid=i, prompt=q, max_new_tokens=5)
                for i, q in enumerate(prompts)]
        ServeEngine(model, params, n_slots=2, max_len=64).run(list(reqs))
        outs.append([r.out_tokens for r in reqs])
    assert outs[0] == outs[1]
