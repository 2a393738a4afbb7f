"""LM serving launcher: ``python -m repro_torch.launch.serve --arch
qwen3-0.6b --requests 16``.

A reduced-width model (``configs.reduced`` at ``--d-model``, float32
compute) with random weights from seed 0, served by
``serving.ServeEngine`` over ``--slots`` slots.  Runs on the CUDA card by
default (``--device cuda``) and raises without one; ``--device cpu``
runs on the CPU.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-0.6b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-len", type=int, default=128)
    ap.add_argument("--d-model", type=int, default=128)
    ap.add_argument("--metrics-out", default="",
                    help="write the repro_torch.obs registry snapshot "
                    "(request/token counters + latency histogram) as JSON")
    ap.add_argument("--device", default="cuda",
                    help="where the model and its cache live")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.configs import get_config, reduced
    from repro_torch.models import build_model
    from repro_torch.models.transformer import RunConfig
    from repro_torch.obs import REGISTRY
    from repro_torch.serving.engine import Request, ServeEngine

    cfg = dataclasses.replace(
        reduced(get_config(args.arch), d_model=args.d_model,
                n_heads=4, head_dim=args.d_model // 4,
                d_ff=3 * args.d_model),
        compute_dtype="float32")
    rc = RunConfig(q_chunk=32, kv_chunk=32, loss_chunk=32)
    model = build_model(cfg, rc=rc, device=args.device)
    params = model.init(0)
    tot, _ = cfg.param_counts()
    where = (torch.cuda.get_device_name(model.device)
             if model.device.type == "cuda" else "cpu")
    print(f"[serve] {cfg.name}: {tot/1e6:.1f}M params, "
          f"{args.slots} slots, max_len {args.max_len}, on {where}")

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i,
                    prompt=rng.integers(
                        0, cfg.vocab_size,
                        int(rng.integers(4, 24))).astype(np.int32),
                    max_new_tokens=args.max_new)
            for i in range(args.requests)]
    eng = ServeEngine(model, params, n_slots=args.slots,
                      max_len=args.max_len, metrics=REGISTRY)
    t0 = time.perf_counter()
    done = eng.run(list(reqs))
    dt = time.perf_counter() - t0
    n_tok = sum(len(r.out_tokens) for r in done)
    print(f"[serve] {len(done)} requests, {n_tok} tokens, {dt:.1f}s "
          f"({n_tok/dt:.1f} tok/s on {where})")

    snap = REGISTRY.snapshot()
    kv = ", ".join(f"{k}={v:g}" for k, v in
                   sorted(snap["counters"].items()))
    print(f"[serve] metrics: {kv}")
    lat = REGISTRY.histogram("serve.request_latency_s")
    if lat.count:
        print(f"[serve] request latency: n={lat.count} "
              f"p50<={lat.quantile(0.5):.3g}s "
              f"p99<={lat.quantile(0.99):.3g}s")
    if args.metrics_out:
        with open(args.metrics_out, "w") as f:
            json.dump(snap, f, indent=1, sort_keys=True)
        print(f"[serve] metrics snapshot -> {args.metrics_out}")


if __name__ == "__main__":
    main()
