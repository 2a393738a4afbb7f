"""The port's checkpoints (``repro_torch.checkpoint``): atomic save and
restore, the LATEST pointer, gc, torn writes, shape checks, restart
equivalence (bitwise within the port), and the JAX package's format:
each package reads the other's f32 checkpoints bitwise, and bf16 leaves
are the raw 2-byte words the JAX package writes."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import ckpt as ref_ckpt

from repro_torch.checkpoint import (Checkpointer, latest_step,
                                    restore_checkpoint, save_checkpoint)
from repro_torch.models.transformer import tree_leaves_with_path, tree_map


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def numpy_state(seed=0):
    rng = np.random.default_rng(seed)
    w = lambda *s: rng.standard_normal(s).astype(np.float32)
    return {"params": {"w": w(8, 4), "b": w(4),
                       "blocks": [{"wq": w(2, 4, 4)}, {"wq": w(2, 4, 4)}]},
            "opt": {"m": {"w": w(8, 4), "b": w(4),
                          "blocks": [{"wq": w(2, 4, 4)},
                                     {"wq": w(2, 4, 4)}]},
                    "v": {"w": w(8, 4), "b": w(4),
                          "blocks": [{"wq": w(2, 4, 4)},
                                     {"wq": w(2, 4, 4)}]}},
            "step": np.asarray(7 + seed, np.int32)}


def state(seed=0):
    return tree_map(lambda a: torch.from_numpy(np.array(a)),
                    numpy_state(seed))


def assert_same(got, want):
    g, w = tree_leaves_with_path(got), tree_leaves_with_path(want)
    assert [p for p, _ in g] == [p for p, _ in w]
    for (path, a), (_, b) in zip(g, w):
        assert a.dtype == b.dtype and a.device == b.device, path
        assert torch.equal(a, b), path


def test_save_restore_roundtrip(tmp_path):
    d = str(tmp_path)
    st = state()
    path = save_checkpoint(d, 7, st)
    assert path == os.path.join(d, "step_00000007")
    assert sorted(os.listdir(path)) == ["manifest.json", "shard_h000.npz"]
    assert latest_step(d) == 7
    restored, manifest = restore_checkpoint(d, tree_map(torch.zeros_like,
                                                        st))
    assert manifest["step"] == 7
    assert manifest["leaves"]["['params']['blocks'][1]['wq']"] == {
        "shape": [2, 4, 4], "dtype": "float32"}
    assert manifest["leaves"]["['step']"] == {"shape": [], "dtype": "int32"}
    assert_same(restored, st)


def test_bf16_leaves_roundtrip_bitwise(tmp_path):
    st = state()
    st["opt"] = tree_map(lambda a: (a * 1e-3).to(torch.bfloat16), st["opt"])
    save_checkpoint(str(tmp_path), 1, st)
    restored, manifest = restore_checkpoint(str(tmp_path),
                                            tree_map(torch.zeros_like, st))
    assert manifest["leaves"]["['opt']['m']['w']"]["dtype"] == "bfloat16"
    assert_same(restored, st)


def test_latest_pointer_follows_newest(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, state(1))
    save_checkpoint(d, 5, state(5))
    assert latest_step(d) == 5
    restored, _ = restore_checkpoint(d, state())
    assert_same(restored, state(5))
    older, _ = restore_checkpoint(d, state(), step=1)
    assert_same(older, state(1))


def test_gc_keeps_k(tmp_path):
    d = str(tmp_path)
    for s in [1, 2, 3, 4, 5]:
        save_checkpoint(d, s, state(s), keep=2)
    dirs = sorted(x for x in os.listdir(d) if x.startswith("step_"))
    assert dirs == ["step_00000004", "step_00000005"]


def test_torn_write_invisible(tmp_path):
    """A .tmp directory (a crash mid-write) is never restored, and a
    LATEST that names a step without a manifest reads as none."""
    d = str(tmp_path)
    save_checkpoint(d, 3, state(3))
    os.makedirs(os.path.join(d, "step_00000009.tmp"))
    assert latest_step(d) == 3
    restored, _ = restore_checkpoint(d, state())
    assert_same(restored, state(3))
    with open(os.path.join(d, "LATEST"), "w") as f:
        f.write("step_00000009")
    assert latest_step(d) is None
    with pytest.raises(FileNotFoundError):
        restore_checkpoint(d, state())


def test_shape_mismatch_rejected(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 1, state())
    bad = state()
    bad["params"]["w"] = torch.zeros((4, 4))
    with pytest.raises(ValueError, match="shape"):
        restore_checkpoint(d, bad)
    extra = state()
    extra["params"]["new"] = torch.zeros(3)
    with pytest.raises(KeyError, match="missing leaf"):
        restore_checkpoint(d, extra)


def test_checkpointer_cadence(tmp_path):
    ck = Checkpointer(str(tmp_path), every=10)
    assert ck.maybe_save(0, state()) is None       # step 0 skipped
    assert ck.maybe_save(5, state()) is None
    assert ck.maybe_save(10, state()) is not None
    assert ck.maybe_save(11, state(), force=True) is not None
    st, step = ck.restore_or_init(lambda: state(3))
    assert step == 11
    assert_same(st, state())


def test_restore_or_init_without_checkpoint(tmp_path):
    st, step = Checkpointer(str(tmp_path)).restore_or_init(lambda: state(2))
    assert step == 0
    assert_same(st, state(2))


def test_reference_reads_port_checkpoint(tmp_path):
    d = str(tmp_path)
    save_checkpoint(d, 7, state())
    assert ref_ckpt.latest_step(d) == 7
    want = numpy_state()
    like = jax.tree.map(lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype),
                        want)
    got, manifest = ref_ckpt.restore_checkpoint(d, like)
    assert manifest["hash"] == ref_ckpt._config_hash(want)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(want)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def test_port_reads_reference_checkpoint(tmp_path):
    d = str(tmp_path)
    want = numpy_state(1)
    ref_ckpt.save_checkpoint(d, 8, jax.tree.map(jnp.asarray, want))
    assert latest_step(d) == 8
    got, manifest = restore_checkpoint(d, state())
    assert manifest["step"] == 8
    assert_same(got, state(1))
    with open(os.path.join(d, "step_00000008", "manifest.json")) as f:
        ref_manifest = json.load(f)
    save_checkpoint(str(tmp_path / "port"), 8, state(1))
    with open(tmp_path / "port" / "step_00000008" / "manifest.json") as f:
        port_manifest = json.load(f)
    for k in ("step", "hash", "hosts", "leaves"):
        assert port_manifest[k] == ref_manifest[k], k


def test_port_reads_reference_bf16_words(tmp_path):
    """The JAX package writes a bf16 leaf as raw 2-byte words: the port
    reads them back bit for bit, and writes the same bytes."""
    d = str(tmp_path)
    vals = np.asarray([[1.5, -2.0, 3.140625], [0.0, 1e-3, -7.5]],
                      np.float32)
    ref_ckpt.save_checkpoint(d, 2, {"m": jnp.asarray(vals, jnp.bfloat16),
                                    "step": jnp.asarray(2, jnp.int32)})
    like = {"m": torch.zeros((2, 3), dtype=torch.bfloat16),
            "step": torch.zeros((), dtype=torch.int32)}
    got, _ = restore_checkpoint(d, like)
    want = torch.from_numpy(vals).to(torch.bfloat16)
    assert got["m"].dtype == torch.bfloat16 and torch.equal(got["m"], want)
    save_checkpoint(str(tmp_path / "port"), 2, got)
    with np.load(os.path.join(d, "step_00000002", "shard_h000.npz")) as a, \
            np.load(tmp_path / "port" / "step_00000002" /
                    "shard_h000.npz") as b:
        assert a["['m']"].dtype == b["['m']"].dtype == np.dtype("V2")
        assert a["['m']"].tobytes() == b["['m']"].tobytes()


def test_restore_to_a_device(tmp_path):
    save_checkpoint(str(tmp_path), 1, state())
    got, _ = restore_checkpoint(str(tmp_path), state(), device="cpu")
    assert_same(got, state())
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            restore_checkpoint(str(tmp_path), state(), device="cuda")


def test_restart_training_equivalence(tmp_path):
    """Training 6 steps straight == training with a save / restore at
    step 3, bitwise (``test_checkpoint.py``'s check, within the port)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.train import init_train_state, make_train_step

    cfg = reduced(get_config("qwen3-0.6b"))
    rc = RunConfig(q_chunk=8, kv_chunk=8, loss_chunk=8)
    step = make_train_step(cfg, None, rc, AdamWConfig(lr=1e-3))
    rng = np.random.default_rng(0)
    batches = []
    for _ in range(6):
        t = rng.integers(0, 64, (2, 17)).astype(np.int32)
        batches.append({"tokens": t[:, :-1], "labels": t[:, 1:]})

    s_a = init_train_state(cfg, 0, device="cpu")
    for b in batches:
        s_a, _ = step(s_a, b)

    s_b = init_train_state(cfg, 0, device="cpu")
    for b in batches[:3]:
        s_b, _ = step(s_b, b)
    save_checkpoint(str(tmp_path), 3, s_b)
    s_b2, _ = restore_checkpoint(str(tmp_path),
                                 init_train_state(cfg, 1, device="cpu"))
    assert int(s_b2["step"]) == 3
    for b in batches[3:]:
        s_b2, _ = step(s_b2, b)
    assert_same(s_b2, s_a)
