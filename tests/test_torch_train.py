"""The port's LM training (``repro_torch.train``, ``optim``,
``launch/train.py``) against the JAX package's, on the CPU, at
``reduced()`` width in f32 with ``CHUNKS``-sized chunks.

Weights are made with numpy from a seed in the reference's schema and
carried to the port by ``params_from_reference`` (the reference's own
init is seeded by Python's ``hash``: two inits are never compared).

* Loss and metrics within rtol 1e-4 / atol 1e-5, every gradient leaf
  within rtol 1e-3 / atol 1e-5 x the leaf's max |g| of
  ``jax.value_and_grad`` over the reference's ``lm_loss``, for all ten
  architectures (the other five in ``test_torch_train_grads.py``, so two
  test workers share the reference's compile time).
* One ``make_train_step`` and a ``microbatch=2`` step: moments as the
  gradients, parameters within atol 1e-6 of the reference's where the
  gradient's rms (sqrt v) is above 1e-3 of the leaf's largest, and
  everywhere within 2 lr: an update is lr x m / (sqrt(v) + 1e-8), which
  near |g| ~ 1e-8 the gradients' rounding moves by a part of lr.
* Within the port, bitwise: ``remat`` off, on and ``"dots"``; a
  ``train_loop`` broken at steps 3 and 7 and replayed from its
  checkpoints, against the unbroken run.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import transformer as ref_T
from repro.optim.adamw import AdamWConfig as RefAdamW
from repro.optim.schedule import cosine_schedule as ref_cosine
from repro.train.step import make_train_step as ref_make_train_step

from repro_torch.checkpoint import Checkpointer
from repro_torch.configs import ARCHITECTURES, get_config, reduced
from repro_torch.models import layers
from repro_torch.models import transformer as T
from repro_torch.models.transformer import RunConfig, tree_leaves_with_path
from repro_torch.optim import AdamWConfig, cosine_schedule
from repro_torch.train import (init_train_state, make_train_step,
                               train_state_from_reference)
from repro_torch.train.loop import (FailureInjector, SimulatedDeviceLoss,
                                    StragglerPolicy, train_loop)

from test_torch_models import make_batch, make_pair, to_jax

LOSS_RTOL, LOSS_ATOL = 1e-4, 1e-5
GRAD_RTOL, GRAD_ATOL = 1e-3, 1e-5          # atol x the leaf's max |g|
PARAM_ATOL = 1e-6
LR = 1e-3
ARCHS = ARCHITECTURES[:5]


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """One intra-op thread while the module runs (small tensors; other
    test workers run beside it), restored after."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# -- gradients against jax.value_and_grad ------------------------------------

def port_grads(model, params, batch, rc=None):
    """(loss, metrics, {path: grad}) of the port's lm_loss by autograd."""
    live = T.tree_map(lambda a: a.detach().requires_grad_(True), params)
    leaves = tree_leaves_with_path(live)
    loss, metrics = T.lm_loss(live, model.cfg, model._batch(batch),
                              rc or model.rc)
    grads = torch.autograd.grad(loss, [a for _, a in leaves])
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            {p: g for (p, _), g in zip(leaves, grads)})


def reference_grads(ref_model, ref_params, batch):
    fn = jax.jit(jax.value_and_grad(
        lambda p, b: ref_T.lm_loss(p, ref_model.cfg, None, b, ref_model.rc),
        has_aux=True))
    (loss, metrics), grads = fn(ref_params, to_jax(batch))
    flat = jax.tree_util.tree_flatten_with_path(grads)[0]
    return (np.asarray(loss), {k: np.asarray(v) for k, v in metrics.items()},
            {jax.tree_util.keystr(p): np.asarray(g) for p, g in flat})


def grad_case(arch):
    ref_model, ref_p, model, p = make_pair(arch)
    batch = make_batch(model.cfg)
    return {"port": port_grads(model, p, batch),
            "ref": reference_grads(ref_model, ref_p, batch)}


@pytest.fixture(scope="module", params=ARCHS)
def case(request):
    """Each architecture's port and reference gradients, computed once."""
    return grad_case(request.param)


def check_loss(case):
    (loss, metrics, _), (ref_loss, ref_metrics, _) = case["port"], \
        case["ref"]
    np.testing.assert_allclose(float(loss), float(ref_loss),
                               rtol=LOSS_RTOL, atol=LOSS_ATOL)
    assert set(metrics) == set(ref_metrics)
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)


def check_grads(case):
    got, want = case["port"][2], case["ref"][2]
    assert set(got) == set(want)
    for path in sorted(want):
        w = want[path]
        g = got[path].numpy()
        assert g.shape == w.shape, path
        assert np.isfinite(g).all(), path
        np.testing.assert_allclose(
            g, w, rtol=GRAD_RTOL,
            atol=GRAD_ATOL * max(float(np.abs(w).max()), 1e-30),
            err_msg=path)


def test_loss_matches_reference(case):
    check_loss(case)


def test_grads_match_reference(case):
    check_grads(case)


# -- the train step against the reference's --------------------------------

def _step_pair(rc_over=None, batch_size=2, schedule=True):
    arch = "qwen3-0.6b"
    ref_model, ref_p, model, _ = make_pair(arch, rc=rc_over)
    rc, ref_rc = model.rc, ref_model.rc
    zeros = jax.tree.map(lambda a: np.zeros(a.shape, np.float32), ref_p)
    tree = {"params": jax.tree.map(np.asarray, ref_p),
            "opt": {"m": zeros, "v": zeros},
            "step": np.asarray(0, np.int32)}
    sched = ref_sched = None
    if schedule:
        sched = lambda s: cosine_schedule(s, warmup=2, total=10)
        ref_sched = lambda s: ref_cosine(s, warmup=2, total=10)
    step = make_train_step(model.cfg, None, rc, AdamWConfig(lr=LR),
                           schedule=sched)
    ref_step = jax.jit(ref_make_train_step(
        ref_model.cfg, None, ref_rc, RefAdamW(lr=LR), schedule=ref_sched))
    state = train_state_from_reference(model.cfg, tree, device="cpu")
    ref_state = jax.tree.map(jnp.asarray, tree)
    return model, step, ref_step, state, ref_state


def check_states(state, ref_state, metrics, ref_metrics):
    assert int(state["step"]) == int(ref_state["step"])
    ref_flat = {jax.tree_util.keystr(p): np.asarray(v) for p, v in
                jax.tree_util.tree_flatten_with_path(ref_state)[0]}
    for path, leaf in tree_leaves_with_path(state):
        want = ref_flat[path]
        got = leaf.numpy()
        if path.startswith("['params']"):
            rms = np.sqrt(ref_flat["['opt']['v']" + path[10:]])
            steady = rms > 1e-3 * rms.max()
            np.testing.assert_allclose(got[steady], want[steady], rtol=0,
                                       atol=PARAM_ATOL, err_msg=path)
            np.testing.assert_allclose(got, want, rtol=0, atol=2 * LR,
                                       err_msg=path)
        elif path.startswith("['opt']"):
            scale = max(float(np.abs(want).max()), 1e-30)
            np.testing.assert_allclose(got, want, rtol=GRAD_RTOL,
                                       atol=GRAD_ATOL * scale, err_msg=path)
    assert set(metrics) == set(ref_metrics)
    for k in ref_metrics:
        np.testing.assert_allclose(float(metrics[k]), float(ref_metrics[k]),
                                   rtol=LOSS_RTOL, atol=LOSS_ATOL,
                                   err_msg=k)


def test_train_step_matches_reference():
    """Two steps under the cosine schedule from the same state."""
    model, step, ref_step, state, ref_state = _step_pair()
    for seed in (0, 1):
        batch = make_batch(model.cfg, seed=seed)
        state, metrics = step(state, batch)
        ref_state, ref_metrics = ref_step(ref_state, to_jax(batch))
        check_states(state, ref_state, metrics, ref_metrics)
    assert int(state["step"]) == 2


def test_microbatch_matches_reference():
    model, step, ref_step, state, ref_state = _step_pair(
        {"microbatch": 2}, schedule=False)
    batch = make_batch(model.cfg, B=4)
    state, metrics = step(state, batch)
    ref_state, ref_metrics = ref_step(ref_state, to_jax(batch))
    check_states(state, ref_state, metrics, ref_metrics)


def test_microbatch_is_the_mean_of_its_pieces():
    """microbatch=2 against one batch: the same loss and gradients up to
    f32 rounding (equal label counts per piece)."""
    cfg = dataclasses.replace(reduced(get_config("smollm-135m")),
                              compute_dtype="float32")
    rng = np.random.default_rng(3)
    t = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    out = {}
    for m in (0, 2):
        rc = RunConfig(q_chunk=8, kv_chunk=8, loss_chunk=8, microbatch=m)
        step = make_train_step(cfg, None, rc, AdamWConfig())
        out[m] = step(init_train_state(cfg, 0, device="cpu"), batch)
    (s1, m1), (s2, m2) = out[0], out[2]
    torch.testing.assert_close(m2["loss"], m1["loss"], rtol=1e-6, atol=0)
    torch.testing.assert_close(m2["grad_norm"], m1["grad_norm"], rtol=1e-5,
                               atol=0)
    for (path, a), (_, b) in zip(tree_leaves_with_path(s2["opt"]["m"]),
                                 tree_leaves_with_path(s1["opt"]["m"])):
        scale = float(b.abs().max())
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-6 * scale,
                                   msg=path)


def test_make_train_step_refuses_rules():
    """Rules that carry no mesh cannot shard a step (the sharded step is
    ``tests/test_torch_sharded_train.py``'s)."""
    cfg = reduced(get_config("qwen3-0.6b"))
    with pytest.raises(ValueError, match="mesh"):
        make_train_step(cfg, object(), RunConfig(), AdamWConfig())


# -- backward knobs: recompute changes no value ----------------------------

@pytest.mark.parametrize("arch", ARCHITECTURES)
def test_remat_variants_bitwise(arch):
    _, _, model, p = make_pair(arch)
    batch = make_batch(model.cfg)
    runs = [port_grads(model, p, batch,
                       dataclasses.replace(model.rc, remat=remat,
                                           remat_policy=policy))
            for remat, policy in ((False, "full"), (True, "full"),
                                  (True, "dots"))]
    base = runs[0]
    for other in runs[1:]:
        assert torch.equal(other[0], base[0])
        for path, g in base[2].items():
            assert torch.equal(other[2][path], g), path


def test_no_checkpointing_without_autograd(monkeypatch):
    """Serving runs under torch.no_grad and pays nothing for remat: no
    checkpoint is taken; with autograd on, each super-block repeat and
    each loss chunk is."""
    _, _, model, p = make_pair("qwen3-0.6b")
    batch = make_batch(model.cfg)
    calls = []
    real = layers.checkpoint

    def counting(fn, *args, **kw):
        calls.append(fn)
        return real(fn, *args, **kw)

    monkeypatch.setattr(layers, "checkpoint", counting)
    with torch.no_grad():
        model.loss(p, batch)
        model.prefill(p, {"tokens": batch["tokens"]})
    assert calls == []
    port_grads(model, p, batch)
    S = batch["tokens"].shape[1]
    assert len(calls) == model.cfg.pattern_repeats + S // 8


# -- the loop: replay, stragglers, restart budget ----------------------------

def _loop_setup(arch="qwen3-0.6b"):
    from repro_torch.data import LMDataConfig, SyntheticLM
    cfg = dataclasses.replace(reduced(get_config(arch)),
                              compute_dtype="float32")
    rc = RunConfig(q_chunk=8, kv_chunk=8, mamba_chunk=8, rwkv_chunk=8,
                   loss_chunk=8)
    step = make_train_step(cfg, None, rc, AdamWConfig(lr=1e-3),
                           schedule=lambda s: cosine_schedule(
                               s, warmup=2, total=10))
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=2))
    return (lambda: init_train_state(cfg, 0, device="cpu")), step, \
        data.batch


@pytest.mark.parametrize("arch", ["qwen3-0.6b", "jamba-1.5-large-398b"])
def test_replay_after_failures_is_bitwise(tmp_path, arch):
    init, step, batch = _loop_setup(arch)
    straight, hist_a = train_loop(init_state_fn=init, train_step=step,
                                  batch_fn=batch, n_steps=10, log_every=0)
    ck = Checkpointer(str(tmp_path), every=2)
    broken, hist_b = train_loop(
        init_state_fn=init, train_step=step, batch_fn=batch, n_steps=10,
        checkpointer=ck, failure_injector=FailureInjector(fail_at=(3, 7)),
        log_every=0)
    assert hist_a["restarts"] == 0 and hist_b["restarts"] == 2
    assert len(hist_b["loss"]) == 12          # steps 2 and 6 replayed
    assert hist_b["loss"][-1] == hist_a["loss"][-1]
    for (path, a), (_, b) in zip(tree_leaves_with_path(broken),
                                 tree_leaves_with_path(straight)):
        assert torch.equal(a, b), path
    assert int(broken["step"]) == 10


def _toy():
    def init_state():
        return {"params": {"w": torch.tensor(4.0)},
                "step": torch.zeros((), dtype=torch.int32)}

    def step(state, batch):
        w = state["params"]["w"]
        loss = (w - batch["target"]) ** 2
        w = w - 0.1 * 2 * (w - batch["target"])
        return ({"params": {"w": w}, "step": state["step"] + 1},
                {"loss": loss})

    return init_state, step, lambda i: {"target": torch.tensor(1.0)}


def test_loop_runs_to_completion():
    init, step, batch = _toy()
    _, hist = train_loop(init_state_fn=init, train_step=step,
                         batch_fn=batch, n_steps=30, log_every=0)
    assert len(hist["loss"]) == 30
    assert hist["loss"][-1] < hist["loss"][0]


def test_failure_triggers_restore_and_replay(tmp_path):
    init, step, batch = _toy()
    state, hist = train_loop(
        init_state_fn=init, train_step=step, batch_fn=batch, n_steps=20,
        checkpointer=Checkpointer(str(tmp_path), every=5),
        failure_injector=FailureInjector(fail_at=(7, 13)), log_every=0)
    assert hist["restarts"] == 2
    assert len(hist["loss"]) > 20
    assert hist["loss"][-1] < 1e-2
    assert int(state["step"]) == 20


def test_restart_budget_enforced(tmp_path):
    init, step, batch = _toy()

    class AlwaysFail(FailureInjector):
        def check(self, step):
            raise SimulatedDeviceLoss("boom")

    with pytest.raises(RuntimeError, match="restart budget"):
        train_loop(init_state_fn=init, train_step=step, batch_fn=batch,
                   n_steps=5, failure_injector=AlwaysFail(),
                   checkpointer=Checkpointer(str(tmp_path), every=100),
                   max_restarts=2, log_every=0)


def test_straggler_policy_detects_slow_steps():
    pol = StragglerPolicy(slack=2.0, patience=2, window=16)
    fired = [i for i in range(20)
             if pol.observe(i, 10.0 if i in (12, 13) else 1.0)]
    assert fired == [13]
    assert len(pol.events) == 2


def test_straggler_mitigation_checkpoints(tmp_path):
    init, step, batch = _toy()

    class FakeStraggler(StragglerPolicy):
        def observe(self, step, dt):
            return step == 9

    ck = Checkpointer(str(tmp_path), every=10_000)   # cadence never fires
    _, hist = train_loop(init_state_fn=init, train_step=step,
                         batch_fn=batch, n_steps=12, checkpointer=ck,
                         straggler=FakeStraggler(), log_every=0)
    assert hist["straggler_events"] == 1
    assert hist["checkpoints"] >= 2     # mitigation save + final save


def test_training_with_compression_converges():
    cfg = reduced(get_config("smollm-135m"))
    rc = RunConfig(q_chunk=8, kv_chunk=8, loss_chunk=8)
    step = make_train_step(cfg, None, rc, AdamWConfig(lr=3e-3),
                           compression="int8")
    state = init_train_state(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    toks = rng.integers(0, 32, (4, 33)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    losses = []
    for _ in range(30):
        state, m = step(state, batch)
        losses.append(float(m["loss"]))
        assert 0 < float(m["compress_rel_err"]) < 0.05
    assert losses[-1] < losses[0] * 0.8
    assert all(np.isfinite(losses))


# -- the launcher ------------------------------------------------------------

def test_launcher_on_the_cpu(tmp_path, capsys):
    from repro_torch.launch.train import main
    ck = tmp_path / "ck"
    argv = ["--device", "cpu", "--arch", "qwen3-0.6b", "--steps", "12",
            "--batch", "2", "--seq", "32", "--ckpt-dir", str(ck),
            "--ckpt-every", "4", "--inject-failures", "6"]
    hist = main(argv)
    out = capsys.readouterr().out
    assert "training qwen3-0.6b-reduced:" in out
    assert "final loss" in out and "restarts=1" in out
    assert hist["restarts"] == 1 and len(hist["loss"]) == 14
    assert all(np.isfinite(hist["loss"]))
    assert sorted(p.name for p in ck.iterdir()) == [
        "LATEST", "step_00000004", "step_00000008", "step_00000012"]
    more = main(argv[:5] + ["16"] + argv[6:-2])   # resumes at step 12
    assert more["restarts"] == 0 and len(more["loss"]) == 4
