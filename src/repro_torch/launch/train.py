"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen3-0.6b --steps 100 --scale reduced``.

``--scale reduced`` (the default) trains a reduced config on one device.
``--scale full`` trains the published one, sharded over the
``torch.distributed`` world the process was started in: one rank per
card under ``python -m torch.distributed.run --nproc-per-node N``, a
world of one without a launcher.  The mesh is ("data", "model") with
``--model-parallel`` ranks on the model axis, and the rules are
``ShardingRules.for_mesh`` on it (``train.step``'s sharded step).  NCCL
on the card, gloo with ``--device cpu``; a failed initialisation raises.
Rank 0 alone prints and writes checkpoints (every rank gathers for a
save).

Runs on the CUDA card by default (``--device cuda``) and raises without
one; ``--device cpu`` runs on the CPU.  ``--metrics-out`` writes rank 0's
per-step losses, step seconds and peak device memory as JSON.
"""

from __future__ import annotations

import argparse
import json


def parse(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--scale", default="reduced",
                    choices=["reduced", "full"])
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--microbatch", type=int, default=0)
    ap.add_argument("--compression", default="none",
                    choices=["none", "int8"])
    ap.add_argument("--inject-failures", default="",
                    help="comma-separated steps to fail at (FT demo)")
    ap.add_argument("--d-model", type=int, default=0,
                    help="override reduced width (e.g. 256 for ~20M)")
    ap.add_argument("--n-layers", type=int, default=0)
    ap.add_argument("--model-parallel", type=int, default=1,
                    help="ranks on the mesh's model axis (--scale full)")
    ap.add_argument("--device", default="cuda",
                    help="where the train state lives")
    ap.add_argument("--metrics-out", default="",
                    help="write losses, step seconds and peak memory here")
    return ap.parse_args(argv)


def setup(args) -> dict:
    """The run's config, RunConfig, optimizer, schedule, data and
    compression, as ``main`` trains with them (a caller that replays the
    run unsharded takes them from here)."""
    from repro_torch.configs import get_config, reduced
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import cosine_schedule

    cfg = get_config(args.arch)
    if args.scale == "reduced":
        over = {}
        if args.d_model:
            over.update(d_model=args.d_model,
                        n_heads=max(4, args.d_model // 64), head_dim=64,
                        n_kv_heads=2, d_ff=args.d_model * 3)
        if args.n_layers:
            patt_mult = max(1, args.n_layers // len(cfg.pattern))
            over["n_layers"] = patt_mult * len(cfg.pattern)
        cfg = reduced(cfg, **over)
    warmup = max(10, args.steps // 20)
    return dict(
        cfg=cfg,
        rc=RunConfig(q_chunk=128, kv_chunk=128, mamba_chunk=64,
                     rwkv_chunk=64, loss_chunk=128,
                     microbatch=args.microbatch),
        opt=AdamWConfig(lr=args.lr),
        schedule=lambda step: cosine_schedule(step, warmup=warmup,
                                              total=args.steps),
        data=SyntheticLM(LMDataConfig(
            vocab_size=cfg.vocab_size, seq_len=args.seq,
            global_batch=args.batch)),
        compression=None if args.compression == "none" else
        args.compression,
        seed=0)


def main(argv=None):
    args = parse(argv)

    import torch
    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.core.engine import resolve_device
    from repro_torch.train.loop import (
        FailureInjector, StragglerPolicy, train_loop)
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    dev = resolve_device(args.device)
    run = setup(args)
    cfg = run["cfg"]
    rank, rules = 0, None
    init = lambda: init_train_state(cfg, run["seed"], device=dev)
    if args.scale == "full":
        import torch.distributed as dist
        from repro_torch.launch.mesh import init_world, make_device_mesh
        from repro_torch.sharding.specs import ShardingRules
        from repro_torch.train.state import shard_train_state
        rank, world = init_world(dev)
        mp = args.model_parallel
        if world % mp:
            dist.destroy_process_group()
            raise ValueError(f"a world of {world} ranks does not split "
                             f"into --model-parallel {mp}")
        mesh = make_device_mesh((world // mp, mp), ("data", "model"),
                                device=dev)
        rules = ShardingRules.for_mesh(mesh)
        full_init = init
        init = lambda: shard_train_state(full_init(), cfg, rules)
    try:
        step_fn = make_train_step(cfg, rules, run["rc"], run["opt"],
                                  schedule=run["schedule"],
                                  compression=run["compression"])
        ckpt = Checkpointer(args.ckpt_dir, every=args.ckpt_every) \
            if args.ckpt_dir else None
        inj = None
        if args.inject_failures:
            inj = FailureInjector(fail_at=tuple(
                int(s) for s in args.inject_failures.split(",")))

        tot, act = cfg.param_counts()
        if rank == 0:
            print(f"training {cfg.name}: {tot/1e6:.1f}M params "
                  f"({act/1e6:.1f}M active), {args.steps} steps, "
                  f"batch {args.batch} x seq {args.seq}", flush=True)
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        seconds = []
        state, hist = train_loop(
            init_state_fn=init, train_step=step_fn,
            batch_fn=run["data"].batch, n_steps=args.steps,
            checkpointer=ckpt, failure_injector=inj,
            straggler=StragglerPolicy(), log_every=10 if rank == 0 else 0,
            metrics_cb=lambda s, m, dt: seconds.append(dt))
        if rank == 0:
            print(f"final loss {hist['loss'][-1]:.4f} "
                  f"(first {hist['loss'][0]:.4f}); "
                  f"restarts={hist['restarts']} "
                  f"straggler_events={hist['straggler_events']}", flush=True)
            if args.metrics_out:
                peak = torch.cuda.max_memory_allocated(dev) \
                    if dev.type == "cuda" else None
                with open(args.metrics_out, "w") as f:
                    json.dump({"loss": hist["loss"], "step_s": seconds,
                               "restarts": hist["restarts"],
                               "peak_bytes": peak}, f)
        return hist
    finally:
        if rules is not None:
            dist.destroy_process_group()


if __name__ == "__main__":
    main()
