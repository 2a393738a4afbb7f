"""Checkpoints with an atomic manifest commit, in the JAX package's
layout and format (``checkpoint/ckpt.py``), so either package reads the
other's f32 checkpoints:

    <dir>/step_00000123/
        manifest.json            # leaf shapes / dtypes, structure hash
        shard_h000.npz           # the leaves (keystr path -> array)
    <dir>/LATEST                 # atomically replaced pointer file

Everything is written into ``step_XXXXXXXX.tmp`` and renamed only after
the manifest is fsynced, so a torn write is never readable, and restore
follows LATEST.  Leaves are keyed by the path that JAX's ``keystr``
writes (``['params']['blocks'][0]['mix']['wq']``), which the port's
``tree_map_with_path`` writes too, and stored whole on the host.

numpy has no bfloat16: a bf16 leaf is stored as its raw 2-byte words
(numpy dtype ``V2``) with ``"bfloat16"`` in the manifest, the bytes the
JAX package writes for one, and read back bit for bit.

A sharded state (``DTensor`` leaves, ``train.state.shard_train_state``)
is saved logically unsharded, as the JAX package stores it: every rank
gathers each full leaf, rank 0 writes, and all ranks wait for the commit.
A restore reads full leaves on every rank and keeps each rank's shard,
on the ``shardings`` given or on the ``like`` leaf's placements, so one
checkpoint restores onto any mesh (``checkpoint.elastic``).
"""

from __future__ import annotations

import hashlib
import json
import os
import shutil
import time

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.models.transformer import (
    tree_leaves_with_path, tree_map_with_path)
from repro_torch.sharding.collectives import Collectives, distribute, to_local
from repro_torch.sharding.specs import NamedPlacements

BF16_WORD = np.dtype("V2")


def _dtype_name(leaf) -> str:
    """numpy's name for the leaf's dtype (``float32``, ``bfloat16``)."""
    if torch.is_tensor(leaf):
        return str(leaf.dtype).removeprefix("torch.")
    return str(np.asarray(leaf).dtype)


def _is_sharded(leaf) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(leaf, DTensor)


def _full(leaf):
    """A ``DTensor`` leaf gathered to full on the host (a collective:
    every rank calls it)."""
    comm = Collectives(leaf.device_mesh)
    return comm.gather(to_local(leaf), leaf.placements).cpu()


def _to_numpy(leaf) -> np.ndarray:
    if not torch.is_tensor(leaf):
        return np.asarray(leaf)
    t = leaf.detach().cpu()
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(BF16_WORD)
    return t.numpy()


def _from_numpy(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == BF16_WORD:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(np.array(arr))


def _config_hash(leaves: dict) -> str:
    desc = json.dumps({k: (list(np.shape(v)), _dtype_name(v))
                       for k, v in sorted(leaves.items())})
    return hashlib.sha256(desc.encode()).hexdigest()[:16]


def save_checkpoint(directory: str, step: int, state, *, host: int = 0,
                    keep: int = 3) -> str:
    """Write one checkpoint; returns its final path.  With ``DTensor``
    leaves every rank must call it: each gathers the full leaves, rank 0
    writes, and all return once the commit is made."""
    leaves = dict(tree_leaves_with_path(state))
    if any(_is_sharded(v) for v in leaves.values()):
        import torch.distributed as dist
        writer = dist.get_rank() == 0
        full = {}
        for k, v in leaves.items():
            v = _full(v) if _is_sharded(v) else v
            if writer:
                full[k] = v
        final = _write(directory, step, full, host, keep) if writer else None
        dist.barrier()
        return final or os.path.join(directory, f"step_{step:08d}")
    return _write(directory, step, leaves, host, keep)


def _write(directory: str, step: int, leaves: dict, host: int,
           keep: int) -> str:
    name = f"step_{step:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    os.makedirs(tmp, exist_ok=True)

    arrays = {k: _to_numpy(v) for k, v in leaves.items()}
    np.savez(os.path.join(tmp, f"shard_h{host:03d}.npz"), **arrays)
    manifest = {
        "step": step,
        "time": time.time(),
        "hash": _config_hash(leaves),
        "hosts": 1,
        "leaves": {k: {"shape": list(arrays[k].shape),
                       "dtype": _dtype_name(v)}
                   for k, v in leaves.items()},
    }
    mpath = os.path.join(tmp, "manifest.json")
    with open(mpath, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    # pointer file, atomically replaced
    ptr_tmp = os.path.join(directory, "LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    _gc(directory, keep)
    return final


def _gc(directory: str, keep: int):
    steps = sorted(d for d in os.listdir(directory)
                   if d.startswith("step_") and not d.endswith(".tmp"))
    for d in steps[:-keep]:
        shutil.rmtree(os.path.join(directory, d), ignore_errors=True)


def latest_step(directory: str):
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    with open(ptr) as f:
        name = f.read().strip()
    path = os.path.join(directory, name)
    if not os.path.exists(os.path.join(path, "manifest.json")):
        return None
    return int(name.split("_")[1])


def restore_checkpoint(directory: str, like, *, step=None, device=None,
                       shardings=None):
    """Restore into the structure of ``like`` (a state tree of tensors,
    meta tensors included).  Each leaf takes its ``like`` leaf's dtype
    and is placed by ``shardings`` (a matching tree of
    ``NamedPlacements`` on a runtime mesh: this rank's shard as a
    ``DTensor``), or where there is none, on its ``like`` leaf's
    placements when that is a ``DTensor``, else on ``device`` or its
    ``like`` leaf's device.  Returns (state, manifest)."""
    if step is None:
        step = latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no checkpoint under {directory}")
    path = os.path.join(directory, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    data = {}
    for fn in sorted(os.listdir(path)):
        if fn.startswith("shard_") and fn.endswith(".npz"):
            with np.load(os.path.join(path, fn)) as z:
                data.update({k: z[k] for k in z.files})
    dev = None if device is None else resolve_device(device)

    def take(k, leaf, named=None):
        if k not in data:
            raise KeyError(f"checkpoint at step {step} missing leaf {k}")
        arr = data[k]
        want = tuple(leaf.shape)
        if tuple(arr.shape) != want:
            raise ValueError(
                f"leaf {k}: checkpoint shape {arr.shape} != expected {want}")
        full = _from_numpy(arr).to(dtype=leaf.dtype)
        if named is None and _is_sharded(leaf):
            named = NamedPlacements(leaf.device_mesh, leaf.placements)
        if named is not None:
            return distribute(full, named)
        return full.to(device=leaf.device if dev is None else dev)

    if shardings is None:
        return tree_map_with_path(take, like), manifest
    return tree_map_with_path(take, like, shardings), manifest


class Checkpointer:
    """Cadence-based checkpointing helper for the training loop."""

    def __init__(self, directory: str, every: int = 100, keep: int = 3):
        self.directory = directory
        self.every = every
        self.keep = keep
        os.makedirs(directory, exist_ok=True)

    def maybe_save(self, step: int, state, force: bool = False):
        if force or (self.every and step % self.every == 0 and step > 0):
            return save_checkpoint(self.directory, step, state,
                                   keep=self.keep)
        return None

    def restore_or_init(self, init_fn):
        """(state, step): the latest checkpoint restored into the shapes,
        dtypes, devices and placements of ``init_fn()``'s state, or that
        state and 0 when there is none."""
        step = latest_step(self.directory)
        if step is None:
            return init_fn(), 0
        like = init_fn()
        state, manifest = restore_checkpoint(self.directory, like, step=step)
        return state, manifest["step"]
