"""The port's sharded train step (``train.step`` with sharding rules over
a ``torch.distributed`` mesh) and elastic restore, on the CPU with gloo,
against its unsharded step and the JAX package's.

As ``tests/test_distributed.py``'s sharded-train and elastic tests:
reduced qwen3-0.6b in f32 on a 4x2 ("data", "model") mesh of 8 ranks;
the step's loss within 1e-3 and every parameter within rtol / atol 2e-3
of the port's unsharded step and of the reference's, with int8
compression and with ``microbatch=2`` too.  After one AdamW step a
parameter moves by about lr * sign(g) whatever the gradient's size, so
the optimizer's m and v (the gradient and its square) are held too, leaf
by leaf, and the metrics (label count, the MoE's aux terms).  Masked
labels spread unevenly over the ranks and olmoe's MoE (ungrouped, with
two microbatches, and group-local) check that the sharded step
optimises the unsharded objective: the global label mean, the global
capacity and positions, the global aux terms.  A checkpoint saved from a
2x2 mesh of 4 ranks restores onto the 4x2 mesh bitwise, and a change of
the model axis is refused.  A world of one is the unsharded step
bitwise, and so is a ``train_loop`` replayed from collective
checkpoints after an injected failure.  The ranks run in
``shard_workers.py`` (no JAX in them); the
comparisons run here.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as ref_get_config  # noqa: E402
from repro.configs import reduced as ref_reduced  # noqa: E402
from repro.models.transformer import RunConfig as RefRunConfig  # noqa: E402
from repro.optim.adamw import AdamWConfig as RefAdamW  # noqa: E402
from repro.train.step import make_train_step as ref_make_train_step  # noqa

from repro_torch.models.transformer import (  # noqa: E402
    RunConfig, tree_leaves_with_path)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.train.state import init_train_state  # noqa: E402
from repro_torch.train.step import make_train_step  # noqa: E402

import shard_workers as W  # noqa: E402

LOSS_TOL, PARAM_TOL = 1e-3, 2e-3
# moments, as a share of the leaf's largest: float-order noise, and with
# int8 compression one quantization step of the leaf's largest block
# (1/127 of it in m, twice that in v), where an element of the reduced
# gradient rounds to the other side of a step
MOMENT_TOL = 1e-4
MOMENT_TOL_INT8 = 2 / 127
METRIC_RTOL = 1e-4


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The 4-rank save, then the 8-rank steps and elastic restore, once."""
    out = tmp_path_factory.mktemp("sharded")
    ckpt = str(out / "ckpt")
    W.spawn(W.save_sharded, 4, str(out), (2, 2), ckpt)
    W.spawn(W.sharded_steps, 8, str(out), (4, 2), ckpt)
    W.spawn(W.world_of_one, 1, str(out))
    return out


def _load(path) -> dict:
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def port_unsharded(variant):
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        kw = W.VARIANTS[variant]
        cfg = W.qwen_cfg(kw.get("arch", "qwen3-0.6b"))
        rc = RunConfig(q_chunk=8, kv_chunk=8, loss_chunk=8,
                       microbatch=kw.get("microbatch", 0))
        step = make_train_step(cfg, None, rc, AdamWConfig(lr=1e-3),
                               compression=kw.get("compression"))
        state, metrics = step(init_train_state(cfg, 0, device="cpu"),
                              W.qwen_batch(kw.get("masked", False)))
    finally:
        torch.set_num_threads(n)
    return ({p: a.numpy() for p, a in tree_leaves_with_path(state)},
            {k: float(v) for k, v in metrics.items()})


def reference_unsharded(variant):
    """The reference's unsharded step on the port's seed-0 weights."""
    kw = W.VARIANTS[variant]
    import dataclasses
    arch = kw.get("arch", "qwen3-0.6b")
    cfg = dataclasses.replace(ref_reduced(ref_get_config(arch)),
                              compute_dtype="float32",
                              vocab_pad_multiple=64)
    port = init_train_state(W.qwen_cfg(arch), 0, device="cpu")
    tree = {"params": port["params"], "opt": port["opt"],
            "step": port["step"]}
    tree = jax.tree.map(lambda a: jnp.asarray(a.numpy()), tree,
                        is_leaf=torch.is_tensor)
    rc = RefRunConfig(q_chunk=8, kv_chunk=8, loss_chunk=8,
                      microbatch=kw.get("microbatch", 0))
    rules = _GroupRules(kw["moe_groups"]) if "moe_groups" in kw else None
    step = jax.jit(ref_make_train_step(cfg, rules, rc, RefAdamW(lr=1e-3),
                                       compression=kw.get("compression")))
    new, metrics = step(tree, {k: jnp.asarray(v) for k, v in W.qwen_batch(
        kw.get("masked", False)).items()})
    flat = jax.tree_util.tree_flatten_with_path(new)[0]
    return ({jax.tree_util.keystr(p): np.asarray(a) for p, a in flat},
            {k: float(v) for k, v in metrics.items()})


class _GroupRules:
    """A rules stand-in for the reference's unsharded step that asks for
    group-local dispatch and shards nothing."""
    mesh = None

    def __init__(self, groups):
        self.moe_groups = groups

    def pspec(self, dims, shape):
        from jax.sharding import PartitionSpec
        return PartitionSpec()


def moment_errors(got, want) -> dict:
    """Each optimizer moment leaf's largest difference over the leaf's
    largest magnitude."""
    return {p: float(np.abs(got[p] - w).max()) /
            max(float(np.abs(w).max()), 1e-30)
            for p, w in want.items() if p.startswith("['opt']")}


def _check(got, got_m, want, want_m, variant):
    assert abs(got_m["loss"] - want_m["loss"]) < LOSS_TOL, \
        (got_m["loss"], want_m["loss"])
    assert set(got) == set(want)
    for path, w in want.items():
        if not path.startswith("['params']"):
            continue
        np.testing.assert_allclose(got[path], w, rtol=PARAM_TOL,
                                   atol=PARAM_TOL, err_msg=path)
    # after one step m = (1 - b1) g and v = (1 - b2) g^2: the gradient
    # itself, leaf by leaf, where the parameters only see lr * sign(g)
    tol = MOMENT_TOL_INT8 if "compression" in W.VARIANTS[variant] \
        else MOMENT_TOL
    bad = {p: e for p, e in moment_errors(got, want).items() if e > tol}
    assert not bad, bad
    # the norm is the gradient's scale, which clipping hides from m and v
    for k in ("ce", "tokens", "load_balance", "router_z", "dropped_frac",
              "grad_norm"):
        if k in want_m:
            assert abs(got_m[k] - want_m[k]) <= \
                METRIC_RTOL * abs(want_m[k]) + 1e-6, (k, got_m[k], want_m[k])


@pytest.mark.parametrize("variant", [v for v in W.VARIANTS
                                     if "moe_groups" not in W.VARIANTS[v]])
def test_sharded_step_matches_port_unsharded(runs, variant):
    got = _load(runs / f"step_{variant}.npz")
    got_m = {k: float(v) for k, v in
             _load(runs / f"metrics_{variant}.npz").items()}
    want, want_m = port_unsharded(variant)
    _check(got, got_m, want, want_m, variant)
    assert abs(got_m["grad_norm"] - want_m["grad_norm"]) <= \
        1e-5 * want_m["grad_norm"]
    if variant == "int8":
        assert abs(got_m["compress_rel_err"] -
                   want_m["compress_rel_err"]) <= 1e-6


@pytest.mark.parametrize("variant", list(W.VARIANTS))
def test_sharded_step_matches_reference(runs, variant):
    got = _load(runs / f"step_{variant}.npz")
    got_m = {k: float(v) for k, v in
             _load(runs / f"metrics_{variant}.npz").items()}
    want, want_m = reference_unsharded(variant)
    _check(got, got_m, want, want_m, variant)


def test_world_of_one_is_the_unsharded_step_bitwise(runs):
    got = _load(runs / "one.npz")
    got_m = _load(runs / "one_metrics.npz")
    want, want_m = port_unsharded("plain")
    assert set(got) == set(want)
    for path, w in want.items():
        assert got[path].dtype == w.dtype and np.array_equal(got[path], w), \
            path
    for k, v in want_m.items():
        assert float(got_m[k]) == v, k


def test_elastic_reshard_4_to_8(runs):
    same = np.load(runs / "elastic.npy")[0]
    assert same == 1


def test_elastic_refuses_a_model_axis_change(runs):
    refused = np.load(runs / "elastic.npy")[1]
    assert refused == 1


def test_sharded_loop_replays_to_the_unbroken_state(runs):
    """``train_loop`` on 8 ranks, broken at step 3 and replayed from its
    collective checkpoints, ends on the unbroken run's shards bitwise."""
    replayed = np.load(runs / "elastic.npy")[2]
    assert replayed == 1


def test_sharded_step_refuses_groups_across_ranks(runs):
    """``moe_groups`` = 3 does not split over 4 data ranks: a group would
    straddle two ranks, so the step raises ``ValueError``."""
    assert np.load(runs / "elastic.npy")[3] == 1


def test_full_scale_launcher_defaults_to_the_card():
    """``--scale full`` on the default ``--device cuda`` raises without a
    card, before any process group is made."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    from repro_torch.launch.train import main
    with pytest.raises(RuntimeError, match="CUDA"):
        main(["--scale", "full", "--steps", "1", "--batch", "2", "--seq",
              "16"])
    assert not torch.distributed.is_initialized()


def _launcher_argv(tmp_path, mp):
    return ["--scale", "full", "--device", "cpu", "--arch", "qwen3-0.6b",
            "--model-parallel", str(mp), "--steps", "3", "--batch", "2",
            "--seq", "16", "--metrics-out", str(tmp_path / "metrics.json")]


def test_launcher_lays_the_model_axis(tmp_path, monkeypatch):
    """``--scale full --model-parallel 2`` on a gloo world of 2: a (1, 2)
    ("data", "model") mesh, every parameter stored in halves on the
    model axis and gathered at use; its per-step losses equal the
    unsharded step's on the launcher's own RunConfig, optimizer,
    schedule, seed and batches (reduced configs: the catalog is swapped
    in both processes)."""
    import json
    from repro_torch.launch.train import parse, setup
    argv = _launcher_argv(tmp_path, 2)
    W.spawn_launcher(2, argv)
    with open(tmp_path / "metrics.json") as f:
        got = json.load(f)["loss"]
    import repro_torch.configs as C
    from repro_torch.configs import get_config, reduced
    monkeypatch.setattr(C, "get_config",
                        lambda name: reduced(get_config(name)))
    run = setup(parse(argv))
    step = make_train_step(run["cfg"], None, run["rc"], run["opt"],
                           schedule=run["schedule"],
                           compression=run["compression"])
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        state = init_train_state(run["cfg"], run["seed"], device="cpu")
        want = []
        for i in range(3):
            state, m = step(state, run["data"].batch(i))
            want.append(float(m["loss"]))
    finally:
        torch.set_num_threads(n)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_launcher_refuses_a_model_axis_that_does_not_split(tmp_path):
    """A world of 2 does not split into ``--model-parallel 3``: the
    launcher raises (each rank exits with the error) instead of training
    on another mesh."""
    with pytest.raises(Exception, match="does not split into"):
        W.spawn_launcher(2, _launcher_argv(tmp_path, 3))
