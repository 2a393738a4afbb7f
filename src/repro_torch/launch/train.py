"""Training launcher: ``python -m repro_torch.launch.train --arch
qwen3-0.6b --steps 100 --scale reduced``.

``--scale reduced`` (the default) trains a reduced config; ``--scale
full`` the published one, on one device (the port has no sharding
rules, so no production mesh).  Runs on the CUDA card by default
(``--device cuda``) and raises without one; ``--device cpu`` runs on
the CPU.
"""

from __future__ import annotations

import argparse


def main(argv=None):
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
    ap.add_argument("--device", default="cuda",
                    help="where the train state lives")
    args = ap.parse_args(argv)

    from repro_torch.checkpoint.ckpt import Checkpointer
    from repro_torch.configs import get_config, reduced
    from repro_torch.core.engine import resolve_device
    from repro_torch.data.lm_data import LMDataConfig, SyntheticLM
    from repro_torch.models.transformer import RunConfig
    from repro_torch.optim.adamw import AdamWConfig
    from repro_torch.optim.schedule import cosine_schedule
    from repro_torch.train.loop import (
        FailureInjector, StragglerPolicy, train_loop)
    from repro_torch.train.state import init_train_state
    from repro_torch.train.step import make_train_step

    dev = resolve_device(args.device)
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

    rc = RunConfig(q_chunk=128, kv_chunk=128, mamba_chunk=64, rwkv_chunk=64,
                   loss_chunk=128, microbatch=args.microbatch)
    opt = AdamWConfig(lr=args.lr)
    warmup = max(10, args.steps // 20)
    sched = lambda step: cosine_schedule(step, warmup=warmup,
                                         total=args.steps)
    step_fn = make_train_step(
        cfg, None, rc, opt, schedule=sched,
        compression=None if args.compression == "none" else args.compression)

    data = SyntheticLM(LMDataConfig(
        vocab_size=cfg.vocab_size, seq_len=args.seq,
        global_batch=args.batch))

    ckpt = Checkpointer(args.ckpt_dir, every=args.ckpt_every) \
        if args.ckpt_dir else None
    inj = None
    if args.inject_failures:
        inj = FailureInjector(
            fail_at=tuple(int(s) for s in args.inject_failures.split(",")))

    tot, act = cfg.param_counts()
    print(f"training {cfg.name}: {tot/1e6:.1f}M params "
          f"({act/1e6:.1f}M active), {args.steps} steps, "
          f"batch {args.batch} x seq {args.seq}")
    state, hist = train_loop(
        init_state_fn=lambda: init_train_state(cfg, 0, device=dev),
        train_step=step_fn, batch_fn=data.batch, n_steps=args.steps,
        checkpointer=ckpt, failure_injector=inj,
        straggler=StragglerPolicy())
    print(f"final loss {hist['loss'][-1]:.4f} "
          f"(first {hist['loss'][0]:.4f}); restarts={hist['restarts']} "
          f"straggler_events={hist['straggler_events']}")
    return hist


if __name__ == "__main__":
    main()
