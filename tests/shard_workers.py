"""Rank functions for the port's multi-process tests
(``test_torch_sharded_train.py``), run under ``torch.multiprocessing``
on the CPU with gloo: JAX-free, so the spawned ranks import only torch
and the port.  Each rank joins the group through a file under the test's
``tmp_path``, uses one intra-op thread, and leaves the group on exit.
Rank 0 writes what the test process compares into ``out``."""

import dataclasses
import os

import numpy as np


def spawn(fn, world: int, out: str, *args):
    """Run ``fn(rank, world, init, out, *args)`` on ``world`` ranks."""
    import torch.multiprocessing as mp
    init = "file://" + os.path.join(out, f"init-{fn.__name__}-{world}")
    mp.spawn(_rank, args=(fn, world, init, out, args), nprocs=world,
             join=True)


def _rank(rank, fn, world, init, out, args):
    import torch
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=world)
    try:
        fn(rank, world, out, *args)
    finally:
        dist.destroy_process_group()


def qwen_cfg(arch="qwen3-0.6b"):
    """The reference test's config: reduced qwen3-0.6b (or ``arch``) in
    f32, vocab padded to 64."""
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config(arch)),
                               compute_dtype="float32",
                               vocab_pad_multiple=64)


def smollm_cfg():
    from repro_torch.configs import get_config, reduced
    return dataclasses.replace(reduced(get_config("smollm-135m")),
                               vocab_pad_multiple=64)


def qwen_batch(masked=False):
    """8 rows of 16 tokens; ``masked``: labels < 0 spread unevenly over
    the rows, so the 4 data ranks' slices count 8, 26, 32 and 32 labels
    (a mean of the ranks' means is not the batch's mean)."""
    rng = np.random.default_rng(0)
    t = rng.integers(0, 64, (8, 17)).astype(np.int32)
    labels = t[:, 1:].copy()
    if masked:
        labels[0] = -1
        labels[1, :8] = -1
        labels[2, 10:] = -1
    return {"tokens": t[:, :-1], "labels": labels}


#: the sharded step's cases: the reference test's (dense qwen, plain,
#: int8, two microbatches), masked labels, and olmoe's MoE (ungrouped,
#: with two microbatches, and with ``moe_groups`` = 4: one group per data
#: rank), whose capacity and aux terms are the global batch's
VARIANTS = {"plain": {}, "int8": {"compression": "int8"},
            "mb2": {"microbatch": 2}, "masked": {"masked": True},
            "moe": {"arch": "olmoe-1b-7b", "masked": True},
            "moe_mb2": {"arch": "olmoe-1b-7b", "microbatch": 2},
            "moe_groups": {"arch": "olmoe-1b-7b", "moe_groups": 4,
                           "masked": True}}


def _full_numpy(state) -> dict:
    """Every leaf gathered to full (``DTensor.full_tensor``, a
    collective), as numpy, by path."""
    from repro_torch.models.transformer import tree_leaves_with_path
    return {p: a.full_tensor().numpy() for p, a in
            tree_leaves_with_path(state)}


def sharded_steps(rank, world, out, shape, ckpt_dir):
    """On a ``shape`` ("data", "model") mesh: for each variant, one
    sharded step from the seed-0 state on ``qwen_batch``; then the
    elastic restore of ``ckpt_dir`` (written by ``save_sharded`` on
    another mesh) and the refused model-axis change."""
    import torch
    from repro_torch.checkpoint.elastic import reshard_checkpoint
    from repro_torch.launch.mesh import (MeshSpec, make_debug_mesh,
                                         make_device_mesh)
    from repro_torch.models.transformer import RunConfig, tree_leaves_with_path
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import ShardingRules
    from repro_torch.sharding.collectives import Collectives
    from repro_torch.train.state import (abstract_train_state,
                                         init_train_state, shard_train_state)
    from repro_torch.train.step import make_train_step

    mesh = make_device_mesh(shape, ("data", "model"), device="cpu")
    rules = ShardingRules.for_mesh(mesh)
    for name, kw in VARIANTS.items():
        cfg = qwen_cfg(kw.get("arch", "qwen3-0.6b"))
        rc = RunConfig(q_chunk=8, kv_chunk=8, loss_chunk=8,
                       microbatch=kw.get("microbatch", 0))
        r = rules.with_overrides(moe_groups=kw.get("moe_groups", 0))
        step = make_train_step(cfg, r, rc, AdamWConfig(lr=1e-3),
                               compression=kw.get("compression"))
        state = shard_train_state(init_train_state(cfg, 0, device="cpu"),
                                  cfg, r)
        new, metrics = step(state, qwen_batch(kw.get("masked", False)))
        full = _full_numpy(new)
        if rank == 0:
            np.savez(os.path.join(out, f"step_{name}.npz"), **full)
            np.savez(os.path.join(out, f"metrics_{name}.npz"),
                     **{k: np.asarray(float(v)) for k, v in
                        metrics.items()})

    # elastic: the checkpoint another mesh wrote, restored onto this one
    small = smollm_cfg()
    want = {p: a for p, a in tree_leaves_with_path(
        init_train_state(small, 0, device="cpu"))}
    restored, manifest = reshard_checkpoint(
        ckpt_dir, small, make_debug_mesh(4, model=2), mesh,
        abstract_train_state(small))
    same = manifest["step"] == 42
    for p, a in tree_leaves_with_path(restored):
        local = a.to_local()
        # this rank's slice of the original leaf, by the same placements
        exp = Collectives(mesh).local(want[p], a.placements)
        same = same and local.dtype == exp.dtype and torch.equal(local, exp)
    try:
        reshard_checkpoint(ckpt_dir, small, make_debug_mesh(4, model=2),
                           MeshSpec(("data", "model"), (2, 4)),
                           abstract_train_state(small))
        refused = False
    except ValueError:
        refused = True
    replayed = _replay_equals_unbroken(qwen_cfg(), rules, out)
    # 3 groups do not split over the 4 data ranks: refused, not run
    moe = qwen_cfg("olmoe-1b-7b")
    r3 = rules.with_overrides(moe_groups=3)
    try:
        make_train_step(moe, r3, RunConfig(q_chunk=8, kv_chunk=8,
                                           loss_chunk=8),
                        AdamWConfig(lr=1e-3))(
            shard_train_state(init_train_state(moe, 0, device="cpu"), moe,
                              r3), qwen_batch())
        groups_refused = False
    except ValueError:
        groups_refused = True
    flags = torch.tensor([int(same), int(refused), int(replayed),
                          int(groups_refused)])
    import torch.distributed as dist
    dist.all_reduce(flags, op=dist.ReduceOp.MIN)
    if rank == 0:
        np.save(os.path.join(out, "elastic.npy"), flags.numpy())


def _replay_equals_unbroken(cfg, rules, out) -> bool:
    """``train_loop`` over the sharded step, broken at step 3 and
    replayed from collective checkpoints every 2 steps, ends on the
    unbroken run's shards bitwise."""
    import torch
    from repro_torch.checkpoint import Checkpointer
    from repro_torch.data import LMDataConfig, SyntheticLM
    from repro_torch.models.transformer import RunConfig, tree_leaves_with_path
    from repro_torch.optim import AdamWConfig
    from repro_torch.train.loop import (FailureInjector, StragglerPolicy,
                                        train_loop)
    from repro_torch.train.state import init_train_state, shard_train_state
    from repro_torch.train.step import make_train_step
    step = make_train_step(cfg, rules, RunConfig(q_chunk=8, kv_chunk=8,
                                                 loss_chunk=8),
                           AdamWConfig(lr=1e-3))
    data = SyntheticLM(LMDataConfig(vocab_size=cfg.vocab_size, seq_len=16,
                                    global_batch=8))
    init = lambda: shard_train_state(init_train_state(cfg, 0, device="cpu"),
                                     cfg, rules)
    kw = dict(init_state_fn=init, train_step=step, batch_fn=data.batch,
              n_steps=5, log_every=0, straggler=StragglerPolicy())
    straight, _ = train_loop(**kw)
    broken, hist = train_loop(
        **kw, checkpointer=Checkpointer(os.path.join(out, "loop"), every=2),
        failure_injector=FailureInjector(fail_at=(3,)))
    return hist["restarts"] == 1 and len(hist["loss"]) == 6 and all(
        torch.equal(a.to_local(), b.to_local()) for (_, a), (_, b) in
        zip(tree_leaves_with_path(broken), tree_leaves_with_path(straight)))


def save_sharded(rank, world, out, shape, ckpt_dir):
    """The seed-0 smollm state placed on a ``shape`` mesh and saved at
    step 42 (a collective save: rank 0 writes)."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.sharding import ShardingRules
    from repro_torch.train.state import init_train_state, shard_train_state
    cfg = smollm_cfg()
    mesh = make_device_mesh(shape, ("data", "model"), device="cpu")
    rules = ShardingRules.for_mesh(mesh)
    state = shard_train_state(init_train_state(cfg, 0, device="cpu"), cfg,
                              rules)
    save_checkpoint(ckpt_dir, 42, state)


def world_of_one(rank, world, out):
    """A sharded step on a (1, 1) mesh, its loss, grad_norm and state,
    for the bitwise comparison with the unsharded step."""
    from repro_torch.launch.mesh import make_device_mesh
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim import AdamWConfig
    from repro_torch.sharding import ShardingRules
    from repro_torch.train.state import init_train_state, shard_train_state
    from repro_torch.train.step import make_train_step
    cfg = qwen_cfg()
    mesh = make_device_mesh((1, 1), ("data", "model"), device="cpu")
    rules = ShardingRules.for_mesh(mesh)
    step = make_train_step(cfg, rules, RunConfig(q_chunk=8, kv_chunk=8,
                                                 loss_chunk=8),
                           AdamWConfig(lr=1e-3))
    state = shard_train_state(init_train_state(cfg, 0, device="cpu"), cfg,
                              rules)
    new, metrics = step(state, qwen_batch())
    np.savez(os.path.join(out, "one.npz"), **_full_numpy(new))
    np.savez(os.path.join(out, "one_metrics.npz"),
             **{k: np.asarray(float(v)) for k, v in metrics.items()})


def free_port() -> int:
    """A port the system has free now (bound to 0, then released)."""
    import socket
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def spawn_launcher(world: int, argv: list):
    """``launch.train.main(argv)`` on ``world`` ranks that find each other
    as ``torch.distributed.run`` would tell them to (``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and a free ``MASTER_PORT`` in each
    rank's environment), with the architectures' configs reduced."""
    import torch.multiprocessing as mp
    mp.spawn(_launcher_rank, args=(world, free_port(), argv), nprocs=world,
             join=True)


def reduced_catalog():
    """``repro_torch.configs.get_config`` giving ``reduced`` configs, so
    ``--scale full`` runs at a width a CPU test affords; returns the
    original."""
    import repro_torch.configs as C
    from repro_torch.configs import reduced
    real = C.get_config
    C.get_config = lambda name: reduced(real(name))
    return real


def _launcher_rank(rank, world, port, argv):
    import torch
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), LOCAL_RANK=str(rank),
                      WORLD_SIZE=str(world), MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    reduced_catalog()
    from repro_torch.launch.train import main
    main(argv)
