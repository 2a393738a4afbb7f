"""The port's sharded train step on the card, in a world of one over NCCL.

JAX-free, so it runs on a machine with a card and no JAX; it skips where
there is no card.  On a (1, 1) ("data", "model") mesh the sharded step
(gathers and reductions over one rank are copies, the norm's all-reduce
adds nothing) equals the unsharded step bitwise; and the dry-run's
per-device state bytes equal the bytes of the shards
``shard_train_state`` places on the card, whose allocation exceeds them
only by the allocator's rounding of each leaf to 512 bytes.
"""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config, reduced  # noqa: E402
from repro_torch.models.transformer import (  # noqa: E402
    RunConfig, tree_leaves_with_path)
from repro_torch.optim import AdamWConfig  # noqa: E402
from repro_torch.sharding import ShardingRules  # noqa: E402
from repro_torch.train.state import (  # noqa: E402
    init_train_state, shard_train_state)
from repro_torch.train.step import make_train_step  # noqa: E402


@pytest.fixture
def mesh():
    """A (1, 1) mesh on the card in a world of one over NCCL, torn down
    after the test; the test skips where there is no card."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the sharded step runs there")
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_device_mesh
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        yield make_device_mesh((1, 1), ("data", "model"), device="cuda")
    finally:
        dist.destroy_process_group()


def test_world_of_one_step_equals_unsharded(mesh):
    cfg = dataclasses.replace(reduced(get_config("qwen3-0.6b")),
                              compute_dtype="float32")
    rc = RunConfig(q_chunk=8, kv_chunk=8, loss_chunk=8)
    rng = np.random.default_rng(0)
    t = rng.integers(0, cfg.vocab_size, (4, 17)).astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    rules = ShardingRules.for_mesh(mesh)
    plain, pm = make_train_step(cfg, None, rc, AdamWConfig(lr=1e-3))(
        init_train_state(cfg, 0, device="cuda"), batch)
    sharded, sm = make_train_step(cfg, rules, rc, AdamWConfig(lr=1e-3))(
        shard_train_state(init_train_state(cfg, 0, device="cuda"), cfg,
                          rules), batch)
    for (path, a), (_, b) in zip(tree_leaves_with_path(plain),
                                 tree_leaves_with_path(sharded)):
        assert torch.equal(a, b.to_local()), path
    assert float(pm["loss"]) == float(sm["loss"])
    assert float(pm["grad_norm"]) == float(sm["grad_norm"])


def test_state_bytes_equal_the_allocated_shards(mesh):
    from repro_torch.launch.dryrun import state_bytes
    cfg = get_config("qwen3-0.6b")
    rules = ShardingRules.for_mesh(mesh)
    want = state_bytes(cfg, rules)
    n = cfg.param_counts()[0]
    assert want["params"] + want["opt"] == 3 * 4 * n == 7_154_171_904
    full = init_train_state(cfg, 0, device="cpu")
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    state = shard_train_state(full, cfg, rules)
    torch.cuda.synchronize()
    grown = torch.cuda.memory_allocated() - before
    leaves = [a.to_local() for _, a in tree_leaves_with_path(state)]
    held = sum(a.untyped_storage().nbytes() for a in leaves)
    assert held == sum(want.values())
    rounded = sum(-(-a.untyped_storage().nbytes() // 512) * 512
                  for a in leaves)
    assert held <= grown <= rounded
