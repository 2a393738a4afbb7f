"""On-disk snapshot format for :class:`repro_torch.store.SymbolicStore`.

The format is the JAX package's (format 2, the same layout, the same
content hash over the same logical arrays), so either package opens the
other's snapshots.  Atomic manifest commit, per-host shards, LATEST
pointer, bounded GC:

    <dir>/snap_00000003/
        manifest.json        # row count, encoder class+params, leaf
                             # shapes/dtypes, shard row ranges, cost
                             # model, hash, index meta
        shard_h000.npz       # host 0's row range of raw + rep leaves,
                             # plus the global breakpoint tables
        shard_h001.npz       # further hosts' row ranges (n_hosts > 1)
        index.npz            # optional: flattened split-tree index
                             # (features, node table, split history)
    <dir>/LATEST             # atomically-replaced pointer file

Row-indexed arrays (raw rows, representation leaves) are split into
contiguous per-host row ranges — on a multi-host deployment each process
writes its own ``shard_hNNN.npz``; in a single process host 0 owns
everything, and the layout is already multi-host shaped.  The content
hash is computed over the LOGICAL (concatenated) arrays, so it is
independent of the shard layout and a re-sharded save of identical data
hashes identically.

The on-disk contiguous ranges are a MANIFEST concept only — they are
independent of how a serving process lays rows out on device.

Crash safety: everything is written into ``snap_XXXX.tmp`` and renamed
only after the manifest fsyncs, so a torn write can never produce a
readable-but-wrong snapshot; ``open`` always follows LATEST (or an
explicit snapshot id).

Encoder round-trip: encoders are frozen dataclasses of plain numbers, so
the manifest stores ``{"class": name, "params": asdict}`` and ``open``
rebuilds through a registry.  The *derived* breakpoint tables (the
season/trend components' alphabets) are additionally stored in shard 0
and compared against the rebuilt encoder's tables with
``allclose(rtol=1e-5, atol=1e-6)`` — a library change that silently
moved the breakpoints (re-interpreting every stored symbol) fails
loudly instead of returning wrong matches, while the few-ulp drift
between the two packages' ``ndtri`` passes.

Index round-trip: ``manifest["index"]["kind"]`` dispatches between the
generic :class:`repro_torch.index.SeriesIndex` (rebuilt against the manifest
encoder, so it keeps accepting incremental inserts after reopen) and a
legacy ``SSaxIndex`` a caller attached by hand before saving.

Format history: format 1 (single ``arrays.npz``, variance-split
``SSaxIndex`` tree) is NOT readable by this version — its index node
semantics predate the deterministic split rule the subsystem's
incremental guarantees rest on.  ``open`` rejects it loudly; re-save
from the source data.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import shutil
import time
from typing import Optional

import numpy as np
import torch

FORMAT = 2


def _encoder_registry() -> dict:
    from repro_torch.core import SAX, SSAX, STSAX, TSAX, OneDSAX
    return {c.__name__: c for c in (SAX, SSAX, TSAX, STSAX, OneDSAX)}


# breakpoint-table properties an encoder may expose, probed generically
_BREAKPOINT_ATTRS = ("breakpoints", "b_seas", "b_res", "b_tr")


def encoder_manifest(encoder) -> dict:
    if not dataclasses.is_dataclass(encoder):
        raise TypeError(f"cannot snapshot non-dataclass encoder "
                        f"{type(encoder).__name__}")
    return {"class": type(encoder).__name__,
            "params": dataclasses.asdict(encoder)}


def encoder_from_manifest(m: dict):
    registry = _encoder_registry()
    if m["class"] not in registry:
        raise ValueError(f"unknown encoder class {m['class']!r} "
                         f"(known: {sorted(registry)})")
    return registry[m["class"]](**m["params"])


def _breakpoint_arrays(encoder) -> dict:
    out = {}
    for attr in _BREAKPOINT_ATTRS:
        if hasattr(type(encoder), attr):
            out[f"bp_{attr}"] = torch.as_tensor(
                getattr(encoder, attr)).cpu().numpy().astype(np.float32)
    return out


def _content_hash(arrays: dict) -> str:
    """sha256 over names, shapes, dtypes AND array bytes — verified on
    open, so a corrupted shard cannot open silently.  Computed over the
    logical arrays, independent of the shard layout."""
    h = hashlib.sha256()
    for k in sorted(arrays):
        v = np.ascontiguousarray(arrays[k])
        h.update(f"{k}:{v.shape}:{v.dtype};".encode())
        h.update(v.tobytes())
    return h.hexdigest()[:16]


def _write_manifest(path: str, manifest: dict):
    with open(path, "w") as f:
        json.dump(manifest, f)
        f.flush()
        os.fsync(f.fileno())


def _snap_ids(directory: str):
    if not os.path.isdir(directory):
        return []
    return sorted(int(d.split("_")[1]) for d in os.listdir(directory)
                  if d.startswith("snap_") and not d.endswith(".tmp"))


def _shard_ranges(n: int, n_hosts: int):
    """Contiguous per-host row ranges covering [0, n)."""
    bounds = [int(round(h * n / n_hosts)) for h in range(n_hosts + 1)]
    return [(bounds[h], bounds[h + 1]) for h in range(n_hosts)]


def save_store(directory: str, store, *, keep: int = 3,
               n_hosts: int = 1) -> str:
    """Write one snapshot of ``store``; returns its final path.

    ``n_hosts`` mocks the multi-host layout: row-indexed arrays are
    split into ``n_hosts`` contiguous row ranges, one ``shard_hNNN.npz``
    each (this single process writes them all; on a multi-host
    deployment each host writes its own shard)."""
    from repro_torch.store.symbolic import rep_leaves

    if n_hosts < 1:
        raise ValueError(f"n_hosts must be >= 1, got {n_hosts}")
    os.makedirs(directory, exist_ok=True)
    for leftover in os.listdir(directory):   # crashed saves: never reuse
        if leftover.startswith("snap_") and leftover.endswith(".tmp"):
            shutil.rmtree(os.path.join(directory, leftover),
                          ignore_errors=True)
    snap_id = (_snap_ids(directory) or [0])[-1] + 1
    name = f"snap_{snap_id:08d}"
    tmp = os.path.join(directory, name + ".tmp")
    final = os.path.join(directory, name)
    os.makedirs(tmp, exist_ok=True)

    leaves = rep_leaves(store.rep_view())
    row_arrays = {"raw": np.ascontiguousarray(store.data)}
    for i, leaf in enumerate(leaves):
        row_arrays[f"rep_{i}"] = np.ascontiguousarray(leaf)
    global_arrays = _breakpoint_arrays(store.encoder)
    arrays = {**row_arrays, **global_arrays}     # logical view (hashed)

    ranges = _shard_ranges(int(store.n), n_hosts)
    for h, (lo, hi) in enumerate(ranges):
        shard = {k: v[lo:hi] for k, v in row_arrays.items()}
        if h == 0:
            shard.update(global_arrays)          # host 0 owns globals
        np.savez(os.path.join(tmp, f"shard_h{h:03d}.npz"), **shard)

    hashed = dict(arrays)                # logical arrays + index contents
    index_meta = None
    if store.index is not None:
        meta, idx_arrays = store.index.to_snapshot()
        np.savez(os.path.join(tmp, "index.npz"), **idx_arrays)
        hashed.update({f"index/{k}": v for k, v in idx_arrays.items()})
        index_meta = meta

    manifest = {
        "format": FORMAT,
        "time": time.time(),
        "n": int(store.n),
        "T": int(store.T),
        "version": int(store.version),
        "hosts": int(n_hosts),
        "shards": [{"file": f"shard_h{h:03d}.npz", "rows": [lo, hi]}
                   for h, (lo, hi) in enumerate(ranges)],
        "row_keys": sorted(row_arrays),
        "encoder": encoder_manifest(store.encoder),
        "rep_tuple": isinstance(store.rep_view(), tuple),
        "media": {"name": store.media, "seek_s": store.seek_s,
                  "read_bps": store.read_bps},
        "leaves": {k: {"shape": list(v.shape), "dtype": str(v.dtype)}
                   for k, v in arrays.items()},
        "hash": _content_hash(hashed),
        "index": index_meta,
    }
    _write_manifest(os.path.join(tmp, "manifest.json"), manifest)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)                      # atomic commit
    ptr_tmp = os.path.join(directory, "LATEST.tmp")
    with open(ptr_tmp, "w") as f:
        f.write(name)
        f.flush()
        os.fsync(f.fileno())
    os.replace(ptr_tmp, os.path.join(directory, "LATEST"))
    for old in _snap_ids(directory)[:-keep]:
        shutil.rmtree(os.path.join(directory, f"snap_{old:08d}"),
                      ignore_errors=True)
    return final


def latest_snap(directory: str) -> Optional[int]:
    ptr = os.path.join(directory, "LATEST")
    if not os.path.exists(ptr):
        return None
    name = open(ptr).read().strip()
    if not os.path.exists(os.path.join(directory, name, "manifest.json")):
        return None
    return int(name.split("_")[1])


def _load_shards(path: str, manifest: dict) -> dict:
    """Reassemble the logical arrays from the per-host shard files."""
    row_keys = set(manifest["row_keys"])
    parts: dict = {k: [] for k in row_keys}
    arrays: dict = {}
    for shard in manifest["shards"]:
        with np.load(os.path.join(path, shard["file"])) as z:
            for k in z.files:
                if k in row_keys:
                    parts[k].append(z[k])
                else:
                    arrays[k] = z[k]             # global (host-0) arrays
    for k, chunks in parts.items():
        arrays[k] = np.concatenate(chunks, axis=0) if len(chunks) > 1 \
            else chunks[0]
    return arrays


def open_store(directory: str, *, snap: Optional[int] = None,
               device="cuda"):
    """Reopen a snapshot as a live, append-ready ``SymbolicStore`` whose
    later appends and index inserts encode on ``device``."""
    from repro_torch.index import SeriesIndex
    from repro_torch.index.legacy import SSaxIndex
    from repro_torch.store.symbolic import SymbolicStore

    if snap is None:
        snap = latest_snap(directory)
        if snap is None:
            raise FileNotFoundError(f"no snapshot under {directory}")
    path = os.path.join(directory, f"snap_{snap:08d}")
    manifest = json.load(open(os.path.join(path, "manifest.json")))
    if manifest.get("format") != FORMAT:
        raise ValueError(f"unsupported snapshot format "
                         f"{manifest.get('format')!r} (this build reads "
                         f"format {FORMAT})")
    encoder = encoder_from_manifest(manifest["encoder"])

    arrays = _load_shards(path, manifest)
    idx_arrays = None
    if manifest.get("index") is not None:
        with np.load(os.path.join(path, "index.npz")) as z:
            idx_arrays = {k: z[k] for k in z.files}

    hashed = dict(arrays)
    if idx_arrays is not None:
        hashed.update({f"index/{k}": v for k, v in idx_arrays.items()})
    got_hash = _content_hash(hashed)
    if got_hash != manifest["hash"]:
        raise ValueError(f"snapshot {path} content hash mismatch "
                         f"({got_hash} != {manifest['hash']}); "
                         f"arrays are corrupt or were modified")

    # breakpoint-table validation: the rebuilt encoder must reproduce the
    # alphabets the symbols were written under
    for key, want in _breakpoint_arrays(encoder).items():
        if key not in arrays:
            raise ValueError(f"snapshot missing breakpoint table {key}")
        if not np.allclose(arrays[key], want, rtol=1e-5, atol=1e-6):
            raise ValueError(
                f"breakpoint table {key} drifted between save and open; "
                f"stored symbols would be re-interpreted — refusing")

    n = int(manifest["n"])
    raw = arrays["raw"]
    if raw.shape != (n, int(manifest["T"])):
        raise ValueError(f"raw shape {raw.shape} != manifest "
                         f"({n}, {manifest['T']})")
    rep_keys = sorted((k for k in arrays if k.startswith("rep_")),
                      key=lambda k: int(k.split("_")[1]))
    leaves = tuple(arrays[k] for k in rep_keys)
    for k, leaf in zip(rep_keys, leaves):
        if leaf.shape[0] != n:
            raise ValueError(f"leaf {k} has {leaf.shape[0]} rows, want {n}")

    media = manifest["media"]
    store = SymbolicStore(encoder, media=media.get("name", "ssd"),
                          seek_s=media["seek_s"], read_bps=media["read_bps"],
                          device=device)
    rep = leaves if manifest["rep_tuple"] else leaves[0]
    if n:
        store.append(raw, rep=rep)
    store.version = int(manifest["version"])

    if idx_arrays is not None:
        meta = manifest["index"]
        if meta.get("kind", "ssax") == "series":
            store.index = SeriesIndex.from_snapshot(encoder, meta,
                                                    idx_arrays,
                                                    device=store.device)
        else:
            store.index = SSaxIndex.from_snapshot(meta, idx_arrays,
                                                  encoder=encoder,
                                                  device=store.device)
    return store
