"""The port's training on the card against the same state on the CPU.

JAX-free, so it runs on a machine with a card and no JAX; it skips where
there is no card.  One train step at ``reduced()`` width in f32 from one
state on both devices: loss within rtol 1e-5, the moments within 1e-3 of
each leaf's max (the gradients, summed in other orders), and a replayed
``train_loop`` on the card equal to an unbroken one bitwise; a
checkpoint saved from the card restores on the CPU bit for bit."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.checkpoint import (  # noqa: E402
    Checkpointer, restore_checkpoint, save_checkpoint)
from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.data import LMDataConfig, SyntheticLM  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    RunConfig, tree_leaves_with_path, tree_map)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train import init_train_state, make_train_step  # noqa: E402
from repro_torch.train.loop import FailureInjector, train_loop  # noqa: E402

RC = RunConfig(q_chunk=8, kv_chunk=8, mamba_chunk=8, rwkv_chunk=8,
               loss_chunk=8)


@pytest.fixture
def cuda():
    """The card; the test skips where there is none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: training runs there by default")
    return torch.device("cuda")


def _setup(arch):
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    step = make_train_step(cfg, None, RC, AdamWConfig(lr=1e-3))
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=2))
    return cfg, step, data


def _same(a, b):
    la, lb = tree_leaves_with_path(a), tree_leaves_with_path(b)
    assert [p for p, _ in la] == [p for p, _ in lb]
    for (path, x), (_, y) in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x.cpu(), y.cpu()), path


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "gemma3-12b",
                                  "jamba-1.5-large-398b", "olmoe-1b-7b",
                                  "rwkv6-7b"])
def test_train_step_on_card(arch, cuda):
    cfg, step, data = _setup(arch)
    cpu = init_train_state(cfg, 0, device="cpu")
    card = tree_map(lambda a: a.to(cuda), cpu)
    want, want_m = step(cpu, data.batch(0))
    got, got_m = step(card, data.batch(0))
    np.testing.assert_allclose(float(got_m["loss"]), float(want_m["loss"]),
                               rtol=1e-5)
    for k in ("m", "v"):
        for (path, g), (_, w) in zip(tree_leaves_with_path(got["opt"][k]),
                                     tree_leaves_with_path(want["opt"][k])):
            scale = max(float(w.abs().max()), 1e-30)
            assert float((g.cpu() - w).abs().max()) <= 1e-3 * scale, path
    again, _ = step(card, data.batch(0))
    _same(again, got)


def test_replay_on_card_is_bitwise(cuda, tmp_path):
    cfg, step, data = _setup("qwen3-0.6b")
    init = lambda: init_train_state(cfg, 0, device=cuda)
    straight, _ = train_loop(init_state_fn=init, train_step=step,
                             batch_fn=data.batch, n_steps=8, log_every=0)
    broken, hist = train_loop(
        init_state_fn=init, train_step=step, batch_fn=data.batch, n_steps=8,
        checkpointer=Checkpointer(str(tmp_path), every=2),
        failure_injector=FailureInjector(fail_at=(3, 5)), log_every=0)
    assert hist["restarts"] == 2
    _same(broken, straight)
    on_cpu, _ = restore_checkpoint(str(tmp_path),
                                   init_train_state(cfg, 1, device="cpu"))
    _same(on_cpu, broken)


def test_bf16_moments_checkpoint_from_card(cuda, tmp_path):
    cfg, step, data = _setup("smollm-135m")
    st = init_train_state(cfg, 0, opt_dtype=torch.bfloat16, device=cuda)
    st, _ = step(st, data.batch(0))
    save_checkpoint(str(tmp_path), 1, st)
    back, _ = restore_checkpoint(str(tmp_path), st)
    _same(back, st)
