"""Dry-run: account every (architecture x input-shape) cell on the
production meshes, the port's counterpart of the JAX package's lower and
compile (``src/repro/launch/dryrun.py``).

Per cell, on meta tensors (nothing is allocated) and on a mesh
description (no world of 256 or 512 ranks is needed):

* **bytes per device**: parameters, optimizer moments and step, and the
  batch or the decode cache, each leaf's shard from its pspec (shards are
  even, so the largest is any);
* **FLOPs per device**: ``torch.utils.flop_counter.FlopCounterMode`` over
  this port's sharded step at rank 0's shapes (its batch slice, every
  parameter gathered to full): the train step (forward, backward under
  the cell's remat, AdamW), or prefill, or one decode step.  The port
  has no sharded serving path yet, so a prefill or decode cell is
  accounted in the train step's pattern: parameters (and a decode
  cache on its non-batch axes) gathered at use, each rank on its batch
  slice;
* **collective bytes** by kind: what that step issues for the cell,
  recorded by ``sharding.collectives`` in the same trace;
* **gathered bytes per device**: what that step holds gathered to full
  at once beside the shards: every parameter (gathered before the
  forward and kept through the backward), a train step's full gradients
  (and f32 accumulators under microbatching), a decode step's cache on
  its non-batch axes.  This, not the shards, is what bounds the model a
  device can train or serve until parameters are gathered layer by
  layer (ROADMAP P10).  Activations are counted in neither.

Each cell is traced at no repeat and one repeat of the layer pattern
(and at one and two encoder layers) and extrapolated linearly to the
config's depth, which is exact for both counts (every stacked leaf and
every layer's work scales with the repeats).  A train step of ``m``
microbatches is traced as one microbatch (a global batch of B / m rows)
and its FLOPs and batch bytes taken ``m`` times, which is exact too:
each microbatch does the same work (the MoE's capacity is a
microbatch's), the optimizer counts no FLOPs, the gathers before and
the one reduction after the accumulation are the step's, and the
model's own collectives (the loss's label count, the MoE's positions
and aux terms over the batch ranks) are taken ``m`` times.  So a meta
trace visits each pattern entry's layer once, and the 32k and 500k cells
stay bounded in time.  Nothing here sets an environment variable.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun            # all cells
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch smollm-135m \\
        --shape train_4k --multi-pod both --out results/dryrun.json
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import time
import traceback

import torch

from repro_torch.configs import ARCHITECTURES, SHAPES, get_config, shape_for
from repro_torch.configs.base import ModelConfig, ShapeSpec
from repro_torch.launch.inputs import decode_specs, train_batch_specs
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models.transformer import (
    RunConfig, _is_dims, abstract_params, cache_logical_dims, decode_step,
    param_pspecs, prefill, tree_leaves_with_path, tree_map)
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.sharding.collectives import KINDS, Collectives
from repro_torch.sharding.specs import (ShardingRules, mesh_axes,
                                        spec_placements, to_named)
from repro_torch.train.state import abstract_train_state, train_state_pspecs
from repro_torch.train.step import (batch_mesh_dims, make_train_step,
                                    rank_rules)


def choose_microbatch(global_batch: int, dp_total: int, target_mb: int) -> int:
    """Largest accumulation factor <= target that keeps every microbatch
    divisible by the data-parallel degree."""
    for m in sorted({target_mb, 16, 8, 4, 2, 1}, reverse=True):
        if m <= target_mb and global_batch % m == 0 \
                and (global_batch // m) % dp_total == 0:
            return m
    return 1


def run_config_for(cfg: ModelConfig, shape: ShapeSpec, dp_total: int,
                   overrides=None) -> RunConfig:
    """Per-cell execution knobs (microbatching keyed to model size)."""
    big = cfg.d_model >= 5000 or cfg.param_counts()[0] > 2e10
    target = 16 if big else (8 if cfg.d_model >= 2048 else 4)
    mb = choose_microbatch(shape.global_batch, dp_total, target) \
        if shape.mode == "train" else 0
    kw = dict(microbatch=mb, remat=True)
    if overrides:
        kw.update(overrides)
    return RunConfig(**kw)


# ---------------------------------------------------------------------------
# Accounting
# ---------------------------------------------------------------------------

def _nbytes(tree) -> int:
    return sum(a.numel() * a.element_size()
               for _, a in tree_leaves_with_path(tree) if torch.is_tensor(a))


def _shards(tree, ps_tree, rules, comm):
    """Rank 0's shard of each meta leaf of ``tree``, by ``ps_tree``."""
    named = to_named(rules, ps_tree)
    return tree_map(lambda a, nm: comm.local(a, nm.placements), tree, named)


def state_bytes(cfg, rules, *, opt_dtype=torch.float32,
                param_dtype=None) -> dict:
    """Bytes per device of the train state's shards on ``rules.mesh``:
    params, opt (m and v), step."""
    rules = dataclasses.replace(rules, mesh=_describe(rules.mesh))
    comm = Collectives(rules.mesh)
    local = _shards(abstract_train_state(cfg, opt_dtype=opt_dtype,
                                         param_dtype=param_dtype),
                    train_state_pspecs(cfg, rules), rules, comm)
    return {"params": _nbytes(local["params"]),
            "opt": _nbytes(local["opt"]), "step": _nbytes(local["step"])}


def _describe(mesh):
    """A mesh (runtime or described) as a description."""
    from repro_torch.launch.mesh import MeshSpec
    ax = mesh_axes(mesh)
    return MeshSpec(tuple(ax), tuple(ax.values()))


def _trace(cfg, shape: ShapeSpec, rules, rc, mode, *, opt_cfg,
           serve_dtype, train_lowmem) -> tuple[int, dict, dict, dict]:
    """(FLOPs, collective counts, the part of them the model issues once
    per microbatch, bytes) of one step of ``cfg`` on the description
    ``rules.mesh``, at rank 0's shapes."""
    from torch.utils.flop_counter import FlopCounterMode
    comm = Collectives(rules.mesh)
    over = batch_mesh_dims(rules, shape.global_batch)
    if mode == "train":
        low = dict(opt_dtype=torch.bfloat16, param_dtype=torch.bfloat16) \
            if train_lowmem else {}
        state = _shards(abstract_train_state(cfg, **low),
                        train_state_pspecs(cfg, rules), rules, comm)
        batch, bps = train_batch_specs(cfg, shape, rules)
        step = make_train_step(cfg, rules, rc, opt_cfg)
        with FlopCounterMode(display=False) as fc:
            step(state, batch)
        comm = step.collectives
        nb = {"params": _nbytes(state["params"]),
              "opt": _nbytes(state["opt"]), "step": _nbytes(state["step"]),
              "inputs": _nbytes(_shards(batch, bps, rules, comm))}
        return fc.get_total_flops(), comm.counts, comm.model_counts, nb

    params = _shards(abstract_params(cfg, serve_dtype),
                     param_pspecs(cfg, rules), rules, comm)
    pnamed = to_named(rules, param_pspecs(cfg, rules))
    model_rules = rank_rules(rules, comm, over)
    from torch.distributed.tensor import Replicate, Shard
    rows = tuple(Shard(0) if i in over else Replicate()
                 for i in range(len(comm.sizes)))
    if mode == "prefill":
        batch, bps = train_batch_specs(cfg, shape, rules, with_labels=False)
        inputs = _nbytes(_shards(batch, bps, rules, comm))
        with FlopCounterMode(display=False) as fc, torch.no_grad():
            full = tree_map(lambda a, nm: comm.gather(a, nm.placements),
                            params, pnamed)
            b = {k: comm.local(v, rows) for k, v in batch.items()}
            prefill(full, cfg, b["tokens"], rc=rc, rules=model_rules,
                    prefix_embed=b.get("prefix_embed"),
                    encoder_frames=b.get("encoder_frames"))
    else:
        (cache, token), (cps, tps) = decode_specs(cfg, shape, rules)
        local_cache = _shards(cache, cps, rules, comm)
        inputs = _nbytes(local_cache) + _nbytes(comm.local(
            token, spec_placements(rules.mesh, tps)))

        def gather_rows(a, nm, dims):
            """A cache leaf with every sharded axis gathered but its batch
            rows (already this rank's)."""
            if a is None:
                return a
            b = dims.index("batch")
            pl = tuple(Replicate() if i in over and p == Shard(b) else p
                       for i, p in enumerate(nm.placements))
            return comm.gather(a, pl)

        with FlopCounterMode(display=False) as fc, torch.no_grad():
            full = tree_map(lambda a, nm: comm.gather(a, nm.placements),
                            params, pnamed)
            c = tree_map(gather_rows, dict(local_cache, pos=None),
                         dict(to_named(rules, cps), pos=None),
                         dict(cache_logical_dims(cfg), pos=None))
            c = dict(c, pos=shape.seq_len - 1)
            decode_step(full, cfg, c, comm.local(token, rows), rc=rc,
                        rules=model_rules)
    nb = {"params": _nbytes(params), "opt": 0, "step": 0, "inputs": inputs}
    return fc.get_total_flops(), comm.counts, comm.model_counts, nb


def gathered_bytes(cfg: ModelConfig, shape: ShapeSpec, rules, rc, *,
                   serve_dtype=None, train_lowmem=False) -> dict:
    """Bytes per device the step holds gathered to full beside the
    shards (module docstring), at the config's depth, on meta."""
    if shape.mode == "train":
        low = dict(opt_dtype=torch.bfloat16, param_dtype=torch.bfloat16) \
            if train_lowmem else {}
        params = _nbytes(abstract_train_state(cfg, **low)["params"])
        n = cfg.param_counts()[0]
        acc = 4 * n if rc.microbatch and rc.microbatch > 1 else 0
        out = {"params": params, "grads": params + acc, "cache": 0}
    else:
        out = {"params": _nbytes(abstract_params(cfg, serve_dtype)),
               "grads": 0, "cache": 0}
    if shape.mode == "decode":
        from torch.distributed.tensor import Shard
        sizes = list(mesh_axes(rules.mesh).values())
        over = batch_mesh_dims(rules, shape.global_batch)
        (cache, _), (cps, _) = decode_specs(cfg, shape, rules)
        def held(dims, a, nm):
            """A leaf's bytes on its rank's batch rows only."""
            rows = 1
            if "batch" in dims:
                b = dims.index("batch")
                rows = math.prod(sizes[i] for i in over
                                 if nm.placements[i] == Shard(b))
            return a.numel() * a.element_size() // rows

        out["cache"] = sum(n for _, n in tree_leaves_with_path(tree_map(
            held, cache_logical_dims(cfg), cache, to_named(rules, cps),
            is_leaf=_is_dims)))
    out["total"] = sum(out.values())
    return out


def _at_depth(cfg: ModelConfig, repeats: int, enc: int) -> ModelConfig:
    over = dict(n_layers=repeats * len(cfg.pattern))
    if cfg.is_enc_dec:
        over["n_encoder_layers"] = enc
    return dataclasses.replace(cfg, **over)


def account(cfg: ModelConfig, shape: ShapeSpec, rules, rc: RunConfig, *,
            opt_cfg=None, serve_dtype=None, train_lowmem=False) -> dict:
    """FLOPs, collective bytes by kind and bytes per device of one step
    of ``cfg`` on ``shape``, on the mesh description ``rules.mesh``:
    traced at no and one repeat (one and two encoder layers), with one
    microbatch, and extrapolated to the config's depth (module
    docstring)."""
    kw = dict(opt_cfg=opt_cfg or AdamWConfig(), serve_dtype=serve_dtype,
              train_lowmem=train_lowmem)
    m = rc.microbatch if shape.mode == "train" and rc.microbatch > 1 else 1
    if m > 1:
        sizes = list(mesh_axes(rules.mesh).values())
        ranks = math.prod(sizes[i] for i in
                          batch_mesh_dims(rules, shape.global_batch))
        if shape.global_batch % (m * ranks):
            raise ValueError(f"batch {shape.global_batch} over {ranks} "
                             f"ranks does not split into {m} microbatches")
        shape = dataclasses.replace(shape,
                                    global_batch=shape.global_batch // m)
    rc = dataclasses.replace(rc, microbatch=0)
    R, E = cfg.pattern_repeats, cfg.n_encoder_layers
    base = _trace(_at_depth(cfg, 0, 1), shape, rules, rc, shape.mode, **kw)
    rep = _trace(_at_depth(cfg, 1, 1), shape, rules, rc, shape.mode, **kw)
    enc = _trace(_at_depth(cfg, 0, 2), shape, rules, rc, shape.mode, **kw) \
        if cfg.is_enc_dec else base

    def extrapolate(a, b, c):
        return a + R * (b - a) + (max(E, 1) - 1) * (c - a)

    flops = m * extrapolate(base[0], rep[0], enc[0])
    # the model's collectives (label counts, MoE positions and aux
    # terms) once per microbatch, the rest once per step
    colls = {k: extrapolate(base[1][k], rep[1][k], enc[1][k]) +
             (m - 1) * extrapolate(base[2][k], rep[2][k], enc[2][k])
             for k in (*KINDS, "count")}
    nb = {k: extrapolate(base[3][k], rep[3][k], enc[3][k])
          for k in base[3]}
    nb["inputs"] *= m
    nb["total"] = sum(nb.values())
    return {"flops_per_dev": float(flops), "collectives": colls,
            "bytes_per_dev": nb,
            "gathered_bytes_per_dev": gathered_bytes(
                cfg, shape, rules, dataclasses.replace(rc, microbatch=m),
                serve_dtype=serve_dtype, train_lowmem=train_lowmem)}


def dryrun_cell(arch: str, shape_name: str, *, multi_pod,
                rc_overrides=None,
                rules_overrides=None,
                opt_cfg=None,
                serve_params_dtype=None,
                train_lowmem: bool = False,
                variant: str = "baseline") -> dict:
    """Account one cell; returns its record."""
    cfg = get_config(arch)
    shape = shape_for(cfg, shape_name)
    if shape is None:
        return {"arch": arch, "shape": shape_name, "multi_pod": multi_pod,
                "status": "skip(full-attn)",
                "note": "long_500k skipped: pure full-attention arch"}

    mesh = make_production_mesh(multi_pod=multi_pod)
    axes = mesh_axes(mesh)
    n_chips = math.prod(axes.values())
    dp_total = axes["data"] * axes.get("pod", 1)
    # batch-1 long decode: shard the KV cache sequence instead of batch
    seq_sharded = (shape.mode == "decode"
                   and shape.global_batch % dp_total != 0)
    rules = ShardingRules.for_mesh(mesh, seq_sharded=seq_sharded)
    if rules_overrides:
        rules = rules.with_overrides(**rules_overrides)
    rc = run_config_for(cfg, shape, dp_total, rc_overrides)

    t0 = time.perf_counter()
    acc = account(cfg, shape, rules, rc, opt_cfg=opt_cfg,
                  serve_dtype=serve_params_dtype, train_lowmem=train_lowmem)
    tot, act = cfg.param_counts()
    return {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "variant": variant,
        "rc": {"microbatch": rc.microbatch, "causal_skip": rc.causal_skip,
               "remat_policy": rc.remat_policy},
        "serve_dtype": serve_params_dtype or "float32",
        "status": "ok", "n_chips": n_chips,
        "mode": shape.mode, "seq_len": shape.seq_len,
        "global_batch": shape.global_batch,
        "microbatch": rc.microbatch,
        "params_total": tot, "params_active": act,
        "seq_sharded": seq_sharded,
        # per device: rank 0's shards and its step (matmul FLOPs of the
        # forward, remat recompute and backward, as FlopCounterMode counts)
        **acc,
        "trace_s": round(time.perf_counter() - t0, 2),
    }


#: the serving configuration the JAX package's hill-climb settled on:
#: TP-only params (no FSDP at inference), sequence-sharded decode caches,
#: bf16 weight streams, causal block skipping, group-local MoE dispatch.
OPTIMIZED_SERVE = dict(
    rules_overrides={"d": (), "cache_seq": ("model",), "hd": (),
                     "kvheads": (), "moe_groups": 16},
    serve_params_dtype="bfloat16",
    rc_overrides={"causal_skip": True, "q_chunk": 2048},
)


def coll_total(rec: dict) -> int:
    """Collective bytes of a record, all kinds."""
    return sum(rec["collectives"][k] for k in KINDS)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--multi-pod", default="both",
                    choices=["single", "multi", "both"])
    ap.add_argument("--out", default="results/dryrun.json")
    ap.add_argument("--append", action="store_true")
    ap.add_argument("--serve-optimized", action="store_true",
                    help="apply OPTIMIZED_SERVE to prefill/decode cells "
                         "(baseline runs without)")
    args = ap.parse_args(argv)

    archs = list(ARCHITECTURES) if args.arch == "all" else [args.arch]
    shapes = list(SHAPES) if args.shape == "all" else [args.shape]
    pods = {"single": [False], "multi": [True],
            "both": [False, True]}[args.multi_pod]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    records = []
    if args.append and os.path.exists(args.out):
        with open(args.out) as f:
            records = json.load(f)
    done = {(r["arch"], r["shape"], r["multi_pod"]) for r in records}

    t_all = time.perf_counter()
    for arch in archs:
        for shape in shapes:
            for mp in pods:
                if (arch, shape, mp) in done:
                    continue
                tag = f"{arch} x {shape} x {'2pod' if mp else '1pod'}"
                try:
                    kw = {}
                    if args.serve_optimized and \
                            SHAPES[shape].mode != "train":
                        kw = dict(OPTIMIZED_SERVE,
                                  variant="serve_optimized")
                    rec = dryrun_cell(arch, shape, multi_pod=mp, **kw)
                    if rec["status"] == "ok":
                        print(f"[ok] {tag}: flops/dev="
                              f"{rec['flops_per_dev']:.3e} "
                              f"coll={coll_total(rec) / 1e6:.1f}MB "
                              f"state/dev="
                              f"{rec['bytes_per_dev']['total'] / 1e9:.2f}GB "
                              f"gathered/dev="
                              f"{rec['gathered_bytes_per_dev']['total'] / 1e9:.2f}GB "
                              f"trace={rec['trace_s']}s", flush=True)
                    else:
                        print(f"[skip] {tag}: {rec['status']}", flush=True)
                except Exception as e:  # noqa: BLE001 — record and continue
                    rec = {"arch": arch, "shape": shape, "multi_pod": mp,
                           "status": "error",
                           "error": f"{type(e).__name__}: {e}",
                           "trace": traceback.format_exc()[-2000:]}
                    print(f"[ERR] {tag}: {type(e).__name__}: {e}",
                          flush=True)
                records.append(rec)
                with open(args.out, "w") as f:
                    json.dump(records, f, indent=1)
    ok = sum(1 for r in records if r["status"] == "ok")
    sk = sum(1 for r in records if r["status"].startswith("skip"))
    er = sum(1 for r in records if r["status"] == "error")
    print(f"dry-run wall time: {time.perf_counter() - t_all:.1f} s")
    print(f"dry-run complete: {ok} ok, {sk} documented skips, {er} errors")


if __name__ == "__main__":
    main()
