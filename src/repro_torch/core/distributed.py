"""Sharded matching engine over the shards of one device or of a
``torch.distributed`` world of devices.

The JAX package maps the paper's pipeline onto a device mesh: the
dataset's N series are sharded over the ("pod", "data") axes and each
stage runs once per shard.  Here (``ShardMesh``, made by
:func:`make_mesh`) S shards are spread over the R ranks of a process
group, S / R of them on each rank's device, where they are a leading
tensor axis; without a group, R = 1 and all S shards sit on one device.
Every stage runs its per-shard work on the device of the rank that owns
the shard, and the results are the unsharded call's bit for bit — the
shard count and the world size change the layout only, never the bits,
because every per-(query, row) quantity is a row-wise map:

  1. ``encode_sharded`` / ``rowwise_sharded`` — a row-wise map (encode,
     index features) over the shards' contiguous row ranges.
  2. ``repr_distances_sharded`` / ``repr_topk_sharded`` — representation
     bounds per shard; the top-k keeps k candidates per shard and merges
     them (``make_matching_service``).
  3. ``make_engine_service`` — a ``core.engine.MatchEngine`` whose exact
     top-k orders candidates on the device (``ShardedRepSweep.
     candidate_stream``) and whose verification, with
     ``verify="device"``, never moves a raw row to the host.

Shard layout (device mirrors)
-----------------------------
Every device mirror (:class:`RoundRobinMirror`) is laid out round-robin:
global row ``i`` lives on shard ``i % S`` at slot ``i // S`` of an
``(S, capacity, *rest)`` tensor (over a world, each rank holds the
``(S / R, capacity, *rest)`` slice of its own shards).  An append of
``d * S`` rows lands in slots ``[per_live, per_live + d)`` of every
shard, so an append uploads only its chunk and the resident rows never
move; capacity doubles on the device.  The largest S-divisible prefix
(the "head") fills whole slots; the fewer than S rows past it (the
"tail") are staged in their own round-robin places, slot ``per_live`` of
shards ``0 .. tail - 1``, and are overwritten in place by the append
that completes the slot.  So one
sweep over the flattened ``(S * capacity, ...)`` mirror bounds every
row, and one K1 launch over the flattened raw mirror verifies any
candidate, tail included.  Snapshots keep contiguous row ranges on disk
(``ShardedRepSweep.shard_ranges``); the device placement is
``owned_rows``.

Candidate order on the device: ``candidate_stream`` gathers the blocked
bound matrix back into natural id order on the device and sorts it once
with a stable sort, which is the host path's ``np.argsort(kind=
"stable")`` order: ties break toward the smaller id.
:class:`DeviceOrderedStream` then hands ``core.engine.topk_verify`` O(Q)
bounds and O(Q * batch) ids per round; the (Q, N) matrix never reaches
the host (``host_order_bytes`` stays 0, and the matrix path
``repr_distances`` counts every byte it brings over).

Device verification (``verify="device"``): a round's candidate ids map
to their mirror slots on the device and one gathered K1 launch
(``kernels.euclid.euclid_gather``) distances them against the flattened
raw mirror.  K1's reduction order per (query, row) does not depend on
the gather, and the square root is ``kernel_verifier``'s, so the device
route equals the host route (store fetch, then the same K1) bitwise.
Windows (:class:`ShardedWindowSweep`) are cut from a round-robin mirror
of the source rows and z-normalized on the device by
``core.normalize.znormalize``, whose sums run in one fixed elementwise
order, so a window has the bits the host's ``znorm_windows`` gives it.

The representation sweep goes through ``pairwise=`` — the encoder's
``pairwise_distance`` by default, the K2 / K3 kernels with
``kernels.ops.make_pairwise``.

A world of ranks (``make_mesh(S, device, group=)``)
---------------------------------------------------
Rank r owns shards ``r * S / R .. (r + 1) * S / R - 1`` (``mesh.shards``)
and its mirrors hold only those shards' rows; the host store stays whole
on every rank, and every rank calls every entry point with the same
arguments (SPMD).  The collectives (NCCL on the card, gloo on the CPU)
take the place of the reference's ``all_gather``, ``pmin`` and ``psum``:

  * a row-wise map encodes the rank's contiguous block and all-gathers
    the blocks (``encode_sharded``, ``rowwise_sharded``);
  * ``repr_topk_sharded`` and ``ShardedRepSweep.candidates`` all-gather
    k candidates per shard and merge them by (bound, id);
  * the exact candidate order (:class:`WorldOrderedStream`) sorts each
    rank's bounds once on its own device; ``peek`` is an all-reduce MIN
    of the ranks' next bounds, ``take`` all-gathers each rank's next
    ``batch`` (bound, id) pairs and merges them by (bound, id) the same
    way on every rank, so the order is the single-process stable sort's;
  * device verification runs one gathered K1 launch per rank over the
    candidates it owns (+inf for the others) and an all-reduce MIN
    combines them: exactly one rank gives each finite value.

Every collective sits on a path that every rank takes, and every
decision of ``core.engine.topk_verify`` is made from collective results
that are identical on all ranks, so the ranks' loops stay in step.
"""

from __future__ import annotations

import os
import threading
import time
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core.engine import resolve_device
from repro_torch.kernels.euclid import euclid_gather
from repro_torch.obs.trace import span

#: id of the pads a rank adds past its own candidates, and their key
#: (``_keys`` of (+inf, _PAD_ID)): they sort after every real pair; real
#: ids stay below it
_PAD_ID = (1 << 32) - 1
_PAD_KEY = (0x7F800000 << 32) | _PAD_ID


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

class ShardMesh:
    """``n_shards`` shards over the ranks of ``group`` (None: one rank),
    ``n_shards / world`` of them on this rank's ``device``.  ``shape``
    maps the data axis to the total shard count, as a JAX mesh's does,
    so code reading ``mesh.shape[a]`` for the data axes works unchanged.

    The collectives (:meth:`all_gather`, :meth:`all_reduce`) are the
    identity without a group.  ``collectives`` counts their calls and
    bytes; with ``timed = True`` each call is fenced on the device before
    and after, and its seconds are added too (a measurement mode: the
    fences cost a synchronization each)."""

    def __init__(self, n_shards: int, device, group=None):
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        self.shape = {"data": self.n_shards}
        self.group = group
        self.world = 1 if group is None else dist.get_world_size(group)
        self.rank = 0 if group is None else dist.get_rank(group)
        if self.n_shards % self.world:
            raise ValueError(f"n_shards={self.n_shards} is not a multiple "
                             f"of the world size {self.world}")
        self.local = self.n_shards // self.world
        self.shard0 = self.rank * self.local
        self.timed = False
        self.collectives = {"calls": 0, "bytes": 0, "seconds": 0.0}

    @property
    def shards(self) -> range:
        """The global shard ids this rank owns."""
        return range(self.shard0, self.shard0 + self.local)

    def _fence(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def _run(self, fn, nbytes: int):
        if self.timed:
            self._fence()
            t0 = time.perf_counter()
        fn()
        if self.timed:
            self._fence()
            self.collectives["seconds"] += time.perf_counter() - t0
        self.collectives["calls"] += 1
        self.collectives["bytes"] += int(nbytes)

    def all_gather(self, t: torch.Tensor) -> list:
        """``t`` of every rank (same shape on all), in rank order."""
        if self.group is None:
            return [t]
        t = t.contiguous()
        out = [torch.empty_like(t) for _ in range(self.world)]
        self._run(lambda: dist.all_gather(out, t, group=self.group),
                  t.numel() * t.element_size())
        return out

    def all_reduce(self, t: torch.Tensor, op) -> torch.Tensor:
        """``t`` reduced over the ranks with ``op``, in place."""
        if self.group is not None:
            self._run(lambda: dist.all_reduce(t, op=op, group=self.group),
                      t.numel() * t.element_size())
        return t


def make_mesh(n_shards: int = 1, device="cuda", group=None) -> ShardMesh:
    """A mesh of ``n_shards`` shards on ``device``: the CUDA card by
    default, which must exist (pass ``device="cpu"`` for the CPU).

    ``group``: a ``torch.distributed`` process group of R ranks (e.g.
    ``torch.distributed.group.WORLD``); ``n_shards`` must be a multiple
    of R, and each rank owns ``n_shards / R`` of them.  It must be
    initialized, NCCL for a CUDA mesh and gloo for a CPU one, or this
    raises; a CUDA ``device`` without an index is the rank's own card,
    ``cuda:LOCAL_RANK``.  (``torch.distributed.group.WORLD`` is None
    until ``init_process_group`` has run: take it after.)"""
    if group is None:
        return ShardMesh(n_shards, resolve_device(device))
    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("a world mesh needs an initialized "
                           "torch.distributed process group")
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", int(os.environ.get("LOCAL_RANK", 0)))
    backend = str(dist.get_backend(group))
    want = "nccl" if dev.type == "cuda" else "gloo"
    if want not in backend:
        raise ValueError(f"a {dev.type} world mesh needs a {want} process "
                         f"group, got {backend!r}")
    return ShardMesh(n_shards, resolve_device(dev), group)


def _data_axes(mesh) -> tuple:
    return tuple(a for a in ("pod", "data") if a in mesh.shape)


def _n_shards(mesh) -> int:
    n = 1
    for a in _data_axes(mesh):
        n *= mesh.shape[a]
    return n


def _leaves(rep) -> tuple:
    return rep if isinstance(rep, tuple) else (rep,)


def _like(rep, leaves):
    """``leaves`` in the structure of ``rep`` (a tuple or one tensor)."""
    return tuple(leaves) if isinstance(rep, tuple) else leaves[0]


def _device_rows(rows, device) -> torch.Tensor:
    return torch.as_tensor(np.asarray(rows, np.float32)
                           if not isinstance(rows, torch.Tensor)
                           else rows, dtype=torch.float32).to(device)


def _pad_rows(rows, n_shards: int):
    """Pad the leading axis to a multiple of ``n_shards`` by repeating
    the last row (the pad is trimmed off every result)."""
    m = rows.shape[0]
    pad = (-m) % n_shards
    if pad and m:
        rows = torch.cat([rows, rows[-1:].expand(pad, *rows.shape[1:])])
    return rows


# ---------------------------------------------------------------------------
# Row-wise maps and sweeps over contiguous shards
# ---------------------------------------------------------------------------

def _flat_out(o) -> list:
    return list(o) if isinstance(o, (tuple, list)) else [o]


def _like_out(o, leaves):
    """``leaves`` in the structure of ``o`` (a tuple, a list or one
    tensor)."""
    return type(o)(leaves) if isinstance(o, (tuple, list)) else leaves[0]


def _map_gathered(fn, rows, mesh):
    """``fn`` over ``rows`` split into the mesh's S contiguous shards
    (padded to a shard multiple): this rank runs its own shards, one call
    each, and the ranks' blocks are all-gathered, so every rank returns
    the whole output (trimmed to the rows, in ``fn``'s structure)."""
    S, m = _n_shards(mesh), rows.shape[0]
    if not m:
        return fn(rows)
    parts = torch.chunk(_pad_rows(rows, S), S)
    mine = [fn(p) for p in parts[mesh.shard0:mesh.shard0 + mesh.local]]
    leaves = []
    for ls in zip(*(_flat_out(o) for o in mine)):
        blk = torch.cat(ls)
        leaves.append(torch.cat(mesh.all_gather(blk))[:m])
    return _like_out(mine[0], leaves)


def encode_sharded(encoder, dataset, mesh):
    """Encode a (N, T) dataset shard by shard (contiguous row ranges) on
    the ranks' devices; returns the encoder's structure of device tensors
    on this rank's device, bitwise the unsharded ``encoder.encode``."""
    return _map_gathered(encoder.encode,
                         _device_rows(dataset, mesh.device), mesh)


def rowwise_sharded(obj, method: str, rows, mesh):
    """Run ``getattr(obj, method)`` — any row-wise device map with a
    (N, T) input — over ``rows`` split into the mesh's shards (padded to
    a shard multiple, trimmed), and return the same structure (tensor,
    tuple or list) of host arrays.  The map runs once per shard, so the
    output is bitwise the unsharded call's (the index features the split
    tree stores rely on it)."""
    x = _device_rows(rows, mesh.device)
    if x.ndim == 1:
        x = x[None]
    out = _map_gathered(getattr(obj, method), x, mesh)
    return _like_out(out, [t.cpu().numpy() for t in _flat_out(out)])


def _split_rep(rep, n_shards: int):
    """The representation's leaves split into ``n_shards`` contiguous
    row ranges: a list of per-shard reps."""
    chunks = [torch.tensor_split(l, n_shards) for l in _leaves(rep)]
    return [_like(rep, ls) for ls in zip(*chunks)]


def _gather_shard_cols(mesh, blocks: list, widths: list):
    """Every shard's (Q, widths[s]) block, in shard order, concatenated
    along the columns on every rank: this rank gives its own ``blocks``
    (one per owned shard), each padded to ``max(widths)``, and the ranks'
    are all-gathered (without a group, this rank's are all) and trimmed
    back."""
    w = max(widths)
    pad = [torch.nn.functional.pad(b, (0, w - b.shape[1])) for b in blocks]
    full = torch.cat(mesh.all_gather(torch.stack(pad)))   # (S, Q, w)
    return torch.cat([full[s, :, :widths[s]] for s in range(len(widths))],
                     dim=1)


def repr_distances_sharded(encoder, rep_query, rep_data, mesh,
                           pairwise: Callable | None = None):
    """(Q, N) representation bounds, computed shard by shard (contiguous
    row ranges of ``rep_data``) on the ranks' devices, whole on every
    rank."""
    pw = pairwise or encoder.pairwise_distance
    parts = _split_rep(rep_data, _n_shards(mesh))
    widths = [_leaves(r)[0].shape[0] for r in parts]
    return _gather_shard_cols(mesh, [pw(rep_query, parts[s])
                                     for s in mesh.shards], widths)


def _take_smallest(d, k: int):
    """(Q, C) -> the k smallest per row by (value, column), stably."""
    sd, order = torch.sort(d, dim=1, stable=True)
    return sd[:, :k], order[:, :k]


def repr_topk_sharded(encoder, rep_query, rep_data, mesh, *, k: int = 64,
                      pairwise: Callable | None = None):
    """Global top-k candidates (distances (Q, k), global ids (Q, k)):
    each shard keeps its k best, the k * S survivors are all-gathered
    (collective volume O(Q * k * S), never O(N)) and merged.  Ties break
    toward the smaller id (gather order is id order here)."""
    pw = pairwise or encoder.pairwise_distance
    parts = _split_rep(rep_data, _n_shards(mesh))
    widths = [_leaves(r)[0].shape[0] for r in parts]
    los = np.concatenate([[0], np.cumsum(widths)])
    kks = [min(k, w) for w in widths]
    ds, ids = [], []
    for s in mesh.shards:
        cd, ci = _take_smallest(pw(rep_query, parts[s]), kks[s])
        ds.append(cd)
        ids.append(ci + int(los[s]))
    cand_d = _gather_shard_cols(mesh, ds, kks)
    cand_i = _gather_shard_cols(mesh, ids, kks)
    best_d, pos = _take_smallest(cand_d, min(k, cand_d.shape[1]))
    return best_d, torch.gather(cand_i, 1, pos)


def make_matching_service(encoder, dataset, mesh, *, k: int = 64,
                          pairwise: Callable | None = None):
    """Returns (rep_data, query_fn): the sharded encode of ``dataset`` and
    a function from raw queries to their top-k candidates."""
    rep_data = encode_sharded(encoder, dataset, mesh)

    def query_fn(queries):
        rep_q = encoder.encode(_device_rows(queries, mesh.device))
        return repr_topk_sharded(encoder, rep_q, rep_data, mesh, k=k,
                                 pairwise=pairwise)

    return rep_data, query_fn


# ---------------------------------------------------------------------------
# Round-robin device mirror
# ---------------------------------------------------------------------------

class RoundRobinMirror:
    """Append-local device mirror of host rows, laid out round-robin.

    Global row ``i`` lives on shard ``i % S`` at slot ``i // S``; this
    rank holds its own shards ``mesh.shards`` as an ``(S / R, capacity,
    *rest)`` tensor on its device (``buf[s - shard0, slot]``).
    ``append`` of ``d * S`` rows (every rank is handed all of them)
    uploads exactly its own shards' ``d`` slots of them (``h2d_bytes``
    counts those bytes) into slots ``[per_live, per_live + d)``; the
    resident rows are never uploaded again.  Capacity doubles on the
    device (a device copy, no host traffic), on every rank alike.
    ``stage_tail`` places fewer than S rows past the head in slot
    ``per_live`` of the first shards, their round-robin places, without
    making the slot live; their bytes go to ``tail_h2d_bytes``.  Slots
    past the live rows hold zeros (valid symbols), and every consumer
    masks them."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_shards = _n_shards(mesh)
        self.local = mesh.local
        self.shard0 = mesh.shard0
        self.buf: Optional[torch.Tensor] = None
        self.per_live = 0                # whole live slots per shard
        self.n_tail = 0                  # rows staged in slot per_live
        self.h2d_bytes = 0               # head uploads
        self.tail_h2d_bytes = 0          # tail stagings

    @property
    def cap(self) -> int:
        return 0 if self.buf is None else int(self.buf.shape[1])

    @property
    def n_rows(self) -> int:
        """Rows the mirror covers over every rank: the head and the
        staged tail."""
        return self.per_live * self.n_shards + self.n_tail

    @property
    def n_local(self) -> int:
        """Rows this rank holds: its shards' head slots and its share of
        the staged tail."""
        tail = min(max(self.n_tail - self.shard0, 0), self.local)
        return self.per_live * self.local + tail

    def flat(self) -> torch.Tensor:
        """This rank's buffer as ``(S / R * capacity, *rest)``: row ``i``
        of an owned shard at ``(i % S - shard0) * capacity + i // S``."""
        return self.buf.reshape((-1,) + tuple(self.buf.shape[2:]))

    def local_slot(self, ids: torch.Tensor):
        """(owned, flat slot) of global row ids on this rank's device;
        the slot is 0 where the row is not this rank's."""
        s = ids % self.n_shards
        own = (s >= self.shard0) & (s < self.shard0 + self.local)
        slot = (s - self.shard0) * self.cap + ids // self.n_shards
        return own, torch.where(own, slot, torch.zeros_like(slot))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.mesh.device)

    def _reserve(self, slots: int, rest: tuple, dtype) -> None:
        """Capacity for ``slots`` slots per shard, doubling on growth."""
        if self.buf is None:
            self.buf = torch.zeros((self.local, slots) + rest,
                                   dtype=dtype, device=self.mesh.device)
        elif slots > self.cap:
            new = torch.zeros((self.local, max(2 * self.cap, slots))
                              + rest, dtype=dtype, device=self.buf.device)
            new[:, :self.cap] = self.buf
            self.buf = new

    def append(self, rows) -> None:
        """Upload this rank's share of ``rows`` (a multiple of S rows, in
        global row order, continuing the head) into the next free slot of
        each of its shards."""
        rows = np.asarray(rows)
        S = self.n_shards
        if rows.shape[0] % S:
            raise ValueError(f"append of {rows.shape[0]} rows is not a "
                             f"multiple of n_shards={S}")
        d = rows.shape[0] // S
        if d == 0:
            return
        # (d*S, ...) -> (S, d, ...): appended row j*S + s -> shard s,
        # slot per_live + j; this rank keeps its own shards
        mine = rows.reshape((d, S) + rows.shape[1:]).swapaxes(0, 1)[
            self.shard0:self.shard0 + self.local]
        blk = self._upload(mine)
        self.h2d_bytes += mine.nbytes
        if self.buf is None:
            self.buf = blk
        else:
            self._reserve(self.per_live + d, tuple(blk.shape[2:]),
                          blk.dtype)
            self.buf[:, self.per_live:self.per_live + d] = blk
        self.per_live += d
        self.n_tail = 0

    def stage_tail(self, rows) -> None:
        """Place the fewer than S rows past the head in slot ``per_live``
        of shards ``0 .. len(rows) - 1`` (replacing any staged before);
        this rank uploads the rows of its own shards.  Every rank
        reserves the slot, so the capacity stays the same on all."""
        rows = np.asarray(rows)
        if rows.shape[0] >= self.n_shards:
            raise ValueError(f"a tail of {rows.shape[0]} rows is not "
                             f"shorter than n_shards={self.n_shards}")
        self.n_tail = int(rows.shape[0])
        if not self.n_tail:
            return
        self._reserve(self.per_live + 1, tuple(rows.shape[1:]),
                      torch.from_numpy(rows[:0]).dtype)
        mine = rows[self.shard0:self.shard0 + self.local]
        if mine.shape[0]:
            self.buf[:mine.shape[0], self.per_live] = self._upload(mine)
            self.tail_h2d_bytes += mine.nbytes

    def dead_mask(self) -> torch.Tensor:
        """(S / R, capacity) bool: True where a slot of this rank's
        shards holds no row."""
        slot = torch.arange(self.cap, device=self.buf.device)[None, :]
        shard = torch.arange(self.shard0, self.shard0 + self.local,
                             device=self.buf.device)[:, None]
        return (slot > self.per_live) | ((slot == self.per_live)
                                         & (shard >= self.n_tail))


# ---------------------------------------------------------------------------
# Device-ordered candidate stream
# ---------------------------------------------------------------------------

class DeviceOrderedStream:
    """Candidate frontier sorted by (bound, id) once on the device; the
    (Q, N) bound matrix never reaches the host.

    ``core.engine.topk_verify`` drives it with two calls per round:
    ``peek()`` returns the next unverified bound per query ((Q,), the only
    per-round bound transfer) and ``take(aq, batch)`` pops the next
    ``batch`` global ids of the active queries, -1-padded past each
    query's finite frontier.  The order is the host path's stable
    argsort, so the verification schedule is the same; the verified
    top-k is exact for any valid-bound order regardless."""

    def __init__(self, sorted_bounds, sorted_ids, n_fin, width: int):
        self._b = sorted_bounds          # (Q, C) device, ascending
        self._i = sorted_ids             # (Q, C) device int64 global ids
        self._n_fin = np.asarray(n_fin, np.int64)
        self._pos = np.zeros(self._n_fin.shape[0], np.int64)
        self._C = 0 if sorted_bounds is None else int(sorted_bounds.shape[1])
        self.width = int(width)

    @classmethod
    def empty(cls, q_n: int) -> "DeviceOrderedStream":
        return cls(None, None, np.zeros(q_n, np.int64), 0)

    @property
    def n_finite(self) -> np.ndarray:
        """(Q,) finite-bound candidates per query — the trace's
        'generated' count when the matrix never reaches the host."""
        return self._n_fin.copy()

    def peek(self) -> np.ndarray:
        """(Q,) next unverified bound per query; +inf when exhausted."""
        if self._C == 0:
            return np.full(self._pos.shape[0], np.inf)
        dev = self._b.device
        rows = torch.arange(self._pos.shape[0], device=dev)
        cols = torch.as_tensor(np.minimum(self._pos, self._C - 1),
                               device=dev)
        nxt = self._b[rows, cols]
        with span("wait"):
            nxt = nxt.cpu()
        nxt = nxt.numpy().astype(np.float64)
        # a fully finite row clipped at pos == C would leak a finite
        # bound: the exhaustion guard is load-bearing
        return np.where(self._pos < self._n_fin, nxt, np.inf)

    def take(self, aq, batch: int) -> np.ndarray:
        """Pop the next ``batch`` global ids of the active queries ``aq``
        ((len(aq), batch) int64, -1-padded); advances each cursor by the
        number of real ids returned."""
        aq = np.asarray(aq, np.int64)
        if self._C == 0 or len(aq) == 0:
            return np.full((len(aq), batch), -1, np.int64)
        cols = (self._pos[aq][:, None]
                + np.arange(batch, dtype=np.int64)[None, :])
        valid = cols < self._n_fin[aq][:, None]
        dev = self._i.device
        ids = self._i[torch.as_tensor(aq, device=dev)[:, None],
                      torch.as_tensor(np.minimum(cols, self._C - 1),
                                      device=dev)]
        with span("wait"):
            ids = ids.cpu()
        ids = ids.numpy()
        self._pos[aq] += valid.sum(axis=1)
        return np.where(valid, ids, -1).astype(np.int64)


def _keys(b: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """(bound, id) pairs as int64 keys whose order is the pairs' (bound,
    id) order: the f32 bound's bits, made monotone, in the high word and
    the id (below ``_PAD_ID``) in the low word.  -0.0 must have been made
    +0.0 (``_order_stream`` does); NaN has no place."""
    bits = b.to(torch.float32).contiguous().view(torch.int32) \
        .to(torch.int64)
    mono = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return (mono << 32) | i


def _key_bounds(k: np.ndarray) -> np.ndarray:
    """The f32 bounds of ``_keys`` keys, as f64."""
    mono = (k >> 32).astype(np.int32)
    bits = np.where(mono < 0, mono ^ 0x7FFFFFFF, mono).astype(np.int32)
    return bits.view(np.float32).astype(np.float64)


def _gather_keys(mesh, keys: torch.Tensor, k: int):
    """Every rank's (Qa, w) keys, all-gathered: (R, Qa, w) on the host,
    and the k smallest per row over all of them, ascending."""
    every = torch.stack(mesh.all_gather(keys)).cpu().numpy()
    flat = every.transpose(1, 0, 2).reshape(every.shape[1], -1)
    return every, np.sort(flat, axis=1)[:, :k]


class WorldOrderedStream:
    """The exact candidate order over a world of ranks, with the
    :class:`DeviceOrderedStream` API.

    Each rank sorts its own rows' (bound, id) pairs once on its device,
    as int64 keys (``_keys``; :meth:`from_bounds`).  Construction
    all-reduces the ranks' finite counts (SUM, ``n_finite``) and least
    keys (MIN, the first ``peek``).  ``take(aq, batch)`` all-gathers each
    rank's next ``batch + 1`` keys of the active queries, merges them on
    every rank alike, returns the first ``batch`` ids and advances each
    rank's cursor by its own keys among them; the key after a rank's
    last taken one is in the gather, so the next ``peek`` — the least of
    those over the ranks — needs no collective.  The order is the
    single-process stable sort's, ties by id included; a round moves
    O(R * Qa * batch) values in one all-gather, and the (Q, N) matrix
    never reaches the host."""

    def __init__(self, keys: torch.Tensor, n_fin: np.ndarray, mesh,
                 width: int):
        self._k = keys                       # (Q, C) sorted int64 keys
        self._b, self._i = keys, None        # for trace fences
        self.mesh = mesh
        self.width = int(width)
        self._C = int(keys.shape[1])
        self._pos = np.zeros(keys.shape[0], np.int64)
        self._fin = np.asarray(n_fin, np.int64)      # this rank's own
        dev = mesh.device
        self._n_fin = mesh.all_reduce(torch.tensor(
            self._fin, dtype=torch.int64, device=dev),
            dist.ReduceOp.SUM).cpu().numpy()
        first = torch.full((keys.shape[0],), _PAD_KEY, dtype=torch.int64,
                           device=dev)
        if self._C:
            live = torch.as_tensor(self._fin > 0, device=dev)
            first = torch.where(live, keys[:, 0], first)
        self._next = _key_bounds(mesh.all_reduce(
            first, dist.ReduceOp.MIN).cpu().numpy())
        self._span: dict = {}

    @classmethod
    def from_bounds(cls, bounds, ids, mesh, width: int):
        """Sort a rank's (Q, C) bounds of rows ``ids`` ((C,) device
        int64) once as keys.  Adding +0.0 first turns -0.0 into +0.0, as
        :func:`_order_stream` does."""
        b = bounds.to(torch.float32) + 0.0
        keys = torch.sort(_keys(b, ids[None].expand_as(b)), dim=1).values
        return cls(keys, torch.isfinite(b).sum(dim=1).cpu().numpy(), mesh,
                   width)

    @property
    def n_finite(self) -> np.ndarray:
        return self._n_fin.copy()

    def peek(self) -> np.ndarray:
        return self._next.copy()

    def take(self, aq, batch: int) -> np.ndarray:
        aq = np.asarray(aq, np.int64)
        if len(aq) == 0:
            return np.full((0, batch), -1, np.int64)
        dev, w = self.mesh.device, batch + 1
        if self._C:
            if w not in self._span:
                self._span[w] = torch.arange(w, device=dev)
            # one upload: the rows, their cursors and finite counts
            r, pos, fin = torch.as_tensor(np.stack(
                [aq, self._pos[aq], self._fin[aq]]), device=dev)
            cols = pos[:, None] + self._span[w]
            mine = torch.where(cols < fin[:, None],
                               self._k[r[:, None], cols.clamp(
                                   max=self._C - 1)], _PAD_KEY)
        else:
            mine = torch.full((len(aq), w), _PAD_KEY, dtype=torch.int64,
                              device=dev)
        every, best = _gather_keys(self.mesh, mine, batch)
        ids = best & 0xFFFFFFFF
        # each rank's keys are sorted: its taken ones are its real keys up
        # to the last key taken, and the key after them is its next one
        taken = ((every <= best[None, :, -1:]) & (every != _PAD_KEY)) \
            .sum(axis=2)                                   # (R, Qa)
        self._pos[aq] += taken[self.mesh.rank]
        after = every[np.arange(len(every))[:, None],
                      np.arange(len(aq))[None, :], taken]
        self._next[aq] = _key_bounds(after.min(axis=0))
        return np.where(ids != _PAD_ID, ids, -1)


def _order_stream(bounds, ids=None, *, width: int) -> DeviceOrderedStream:
    """One stable device sort of a (Q, C) bound matrix whose column j
    holds id ``ids[j]`` (``ids`` strictly increasing; None: id j).  The
    stable sort then gives the (bound, id) order.  Adding +0.0 first
    turns -0.0 into +0.0, which a radix sort would otherwise order
    before +0.0 where ``np.argsort`` keeps them tied."""
    b = bounds.to(torch.float32) + 0.0
    sb, order = torch.sort(b, dim=1, stable=True)
    si = order if ids is None else torch.as_tensor(
        np.asarray(ids, np.int64), device=b.device)[order]
    n_fin = torch.isfinite(b).sum(dim=1)
    with span("wait"):
        n_fin = n_fin.cpu()
    return DeviceOrderedStream(sb, si, n_fin.numpy(), width)


def host_order_stream(bounds, ids, device="cuda") -> DeviceOrderedStream:
    """Order a host bound matrix on ``device`` (``TreeCandidates``'
    device order: the columns are the union candidate ids, strictly
    increasing).  f64 bounds are rounded DOWN to f32, so every sorted
    bound is still a valid d_ED lower bound."""
    b = np.asarray(bounds)
    if b.dtype != np.float32:
        b32 = b.astype(np.float32)
        over = np.isfinite(b32) & (b32.astype(np.float64) > b)
        b32[over] = np.nextafter(b32[over], np.float32(-np.inf))
        b = b32
    ids = np.asarray(ids, np.int64)
    if ids.size > 1 and not (np.diff(ids) > 0).all():
        raise ValueError("host_order_stream needs strictly increasing ids")
    return _order_stream(torch.from_numpy(np.ascontiguousarray(b)).to(
        resolve_device(device)), ids, width=b.shape[1])


# ---------------------------------------------------------------------------
# The sharded sweep over a SymbolicStore
# ---------------------------------------------------------------------------

def _owned_d2(mesh, rows_flat, q, own, slot) -> np.ndarray:
    """True distances of queries ``q`` (Qa, T) to the candidates whose
    rows sit at ``rows_flat[slot]`` ((Qa, B) device slots) on the rank
    that owns them (``own``): one gathered K1 launch per rank, +inf for
    the candidates of other ranks, an all-reduce MIN over the ranks (the
    reference's ``pmin``; exactly one rank gives each finite value), then
    the square root as ``core.engine.kernel_verifier`` takes it: (Qa, B)
    f32 on the host."""
    d2 = euclid_gather(rows_flat, q, slot)
    d2 = torch.where(own, d2, torch.full_like(d2, float("inf")))
    d2 = mesh.all_reduce(d2, dist.ReduceOp.MIN)
    with span("wait"):
        d2 = d2.cpu()
    return np.sqrt(np.maximum(d2.numpy(), 0.0))


class ShardedRepSweep:
    """Device-resident sharded representation sweep over a
    ``repro_torch.store.SymbolicStore`` under streaming ingestion.

    The store owns the raw rows and the host representation; this class
    keeps round-robin device mirrors of them (:class:`RoundRobinMirror`)
    fresh:

    * ``ingest(rows)`` encodes only the new chunk (``encode_sharded``)
      and appends rows and representation to the store.
    * The next query syncs the mirrors: only the new head-aligned rows
      are uploaded, and the tail is staged in its round-robin slots.
    * ``candidate_stream`` orders the bounds on the device
      (:class:`DeviceOrderedStream`); ``repr_distances`` is the host
      matrix path and counts its bytes in ``host_order_bytes``.
    * With ``mirror_raw=True`` the raw rows are mirrored too, and
      ``make_dist_fn`` verifies candidates on the device
      (``verify="device"``).
    """

    mirror_layout = "round_robin"

    def __init__(self, encoder, mesh, store, *,
                 pairwise: Callable | None = None,
                 mirror_raw: bool = False):
        self.encoder = encoder
        self.mesh = mesh
        self.device = mesh.device
        self.store = store
        self._pw = pairwise or encoder.pairwise_distance
        self.n_shards = _n_shards(mesh)
        self.mirror_raw = bool(mirror_raw)
        if self.mirror_raw and not getattr(store, "store_raw", True):
            raise ValueError("device-resident verification needs raw rows "
                             "in the store (store_raw=True)")
        self._synced_version = -1
        self._synced_n = 0               # row frontier the mirrors cover
        self._sync_lock = threading.Lock()
        self._head = 0
        self._mirrors = None             # per-rep-leaf RoundRobinMirror
        self._raw_mirror = None          # RoundRobinMirror of raw rows
        self.host_order_bytes = 0        # bytes of host bound matrices

    # -- ingest -----------------------------------------------------------
    def _encode_chunk(self, rows: np.ndarray):
        """Sharded one-pass encode of a chunk, as host leaves in the
        encoder's structure — bitwise the unsharded encode."""
        rep = encode_sharded(self.encoder, rows, self.mesh)
        leaves = tuple(l.cpu().numpy() for l in _leaves(rep))
        return _like(rep, leaves)

    def ingest(self, rows) -> np.ndarray:
        """Append rows to the store; only the new chunk is encoded."""
        rows = np.asarray(rows, np.float32)
        if rows.ndim == 1:
            rows = rows[None]
        return self.store.append(rows, rep=self._encode_chunk(rows))

    # -- device mirrors ---------------------------------------------------
    def _sync(self):
        # "synced" means synced to the published epoch: an append raises
        # ``store.version`` before it publishes, and a sync in that gap
        # would only upload the old epoch's rows again
        if self._synced_version == self.store.current_epoch().epoch:
            return
        with self._sync_lock:
            if self._synced_version == self.store.current_epoch().epoch:
                return
            # capture the frontier first: a writer may append while we
            # sync, so everything below is sliced to this (version, n).
            # The published epoch, not ``store.n``: an append raises n
            # before it re-points ``store.data`` at the grown rows, and
            # publishes its epoch last, so rows [0, n) of the epoch are
            # in both the raw rows and the representation
            ep = self.store.current_epoch()
            version, n = ep.epoch, ep.n_rows
            head = (n // self.n_shards) * self.n_shards
            rep = self.store.rep_view()
            leaves = _leaves(rep)
            if self._mirrors is None:
                self._rep_is_tuple = isinstance(rep, tuple)
                self._mirrors = tuple(RoundRobinMirror(self.mesh)
                                      for _ in leaves)
            if self.mirror_raw and self._raw_mirror is None:
                self._raw_mirror = RoundRobinMirror(self.mesh)
            pairs = list(zip(self._mirrors, leaves))
            if self.mirror_raw:
                pairs.append((self._raw_mirror, self.store.data))
            for mir, src in pairs:
                mir.append(src[self._head:head])     # O(chunk)
                mir.stage_tail(src[head:n])
            self._head = head
            self._synced_n = n
            self._synced_version = version

    @property
    def h2d_bytes(self) -> int:
        """Host->device bytes of the head-aligned mirror uploads."""
        mirrors = list(self._mirrors or ()) + (
            [self._raw_mirror] if self._raw_mirror is not None else [])
        return sum(m.h2d_bytes for m in mirrors)

    @property
    def tail_h2d_bytes(self) -> int:
        """Host->device bytes of the staged tails (fewer than S rows per
        sync, uploaded again when their slot fills)."""
        mirrors = list(self._mirrors or ()) + (
            [self._raw_mirror] if self._raw_mirror is not None else [])
        return sum(m.tail_h2d_bytes for m in mirrors)

    def _encode_queries(self, queries_raw):
        q = np.asarray(queries_raw, np.float32)
        if q.ndim == 1:
            q = q[None]
        return self.encoder.encode(torch.from_numpy(
            np.ascontiguousarray(q)).to(self.device)), q.shape[0]

    def _rr_bounds(self, rep_q) -> torch.Tensor:
        """(Q, S / R * capacity) blocked bounds over this rank's mirrors,
        one sweep (one ``pairwise`` call): column ``(s - shard0) *
        capacity + j`` holds global row ``j * S + s``; slots without a
        row are +inf."""
        flat = [m.flat() for m in self._mirrors]
        flat = tuple(flat) if self._rep_is_tuple else flat[0]
        d = self._pw(rep_q, flat)
        mir = self._mirrors[0]
        d = d.reshape(d.shape[0], self.mesh.local, mir.cap)
        d = d.masked_fill(mir.dead_mask()[None], float("inf"))
        return d.reshape(d.shape[0], -1)

    def _to_natural(self, blk, n_blocks: int, first: int):
        """A blocked (Q, n_blocks * cap) matrix of shards ``first ..
        first + n_blocks - 1`` transposed on the device into increasing
        id order (block column b*cap + j -> id j*S + first + b); returns
        it with its (C,) ids."""
        q_n, cap = blk.shape[0], self._mirrors[0].cap
        nat = blk.reshape(q_n, n_blocks, cap).transpose(1, 2)
        ids = (torch.arange(cap, device=self.device)[:, None] * self.n_shards
               + first + torch.arange(n_blocks, device=self.device)[None])
        return nat.reshape(q_n, -1), ids.reshape(-1)

    def _local_bounds(self, rep_q):
        """(Q, n_local) device bounds of this rank's rows in increasing id
        order and their (n_local,) ids (the staged tail lands right after
        the head); without a group, every row in natural id order."""
        b, ids = self._to_natural(self._rr_bounds(rep_q), self.mesh.local,
                                  self.mesh.shard0)
        n_loc = self._mirrors[0].n_local
        return b[:, :n_loc], ids[:n_loc]

    def _natural_bounds(self, rep_q) -> torch.Tensor:
        """(Q, n) device bounds of every row in natural id order, whole
        on every rank: the ranks' blocked matrices all-gathered (the
        matrix path), then transposed on the device."""
        blk = torch.cat(self.mesh.all_gather(self._rr_bounds(rep_q)), dim=1)
        return self._to_natural(blk, self.n_shards, 0)[0][:, :self._synced_n]

    # -- sweeps -----------------------------------------------------------
    def repr_distances(self, queries_raw) -> np.ndarray:
        """(Q, N) bound matrix on the HOST (the matrix path; its bytes
        are counted in ``host_order_bytes``).  Exact top-k uses
        ``candidate_stream`` instead and never pays this."""
        self._sync()
        rep_q, q_n = self._encode_queries(queries_raw)
        if self._synced_n == 0:
            return np.empty((q_n, 0), np.float32)
        arr = self._natural_bounds(rep_q).cpu().numpy()
        self.host_order_bytes += arr.nbytes
        return arr

    def candidates(self, queries_raw, k: int) -> np.ndarray:
        """(Q, k) approximate candidate frontier: the k smallest bounds
        per query by (bound, id): each rank's k smallest, picked on its
        device, all-gathered as keys and merged; -1 where the bound is
        infinite."""
        self._sync()
        rep_q, q_n = self._encode_queries(queries_raw)
        k = min(int(k), self._synced_n)
        if k == 0:
            return np.empty((q_n, 0), np.int64)
        b, ids = self._local_bounds(rep_q)
        kk = min(k, b.shape[1])
        sb, pos = _take_smallest(b, kk)
        mine = torch.full((q_n, k), _PAD_KEY, dtype=torch.int64,
                          device=self.device)
        mine[:, :kk] = _keys(sb + 0.0, ids[pos])
        best = _gather_keys(self.mesh, mine, k)[1]
        return np.where(np.isfinite(_key_bounds(best)), best & 0xFFFFFFFF,
                        -1).astype(np.int64)

    def candidate_stream(self, queries_raw, mask_fn=None):
        """Device-ordered exact candidate frontier over every synced row:
        a :class:`DeviceOrderedStream`, or over a world a
        :class:`WorldOrderedStream` of the ranks' own streams.

        ``mask_fn``, if given, maps an (m,) int64 device vector of row
        ids (this rank's rows) to an (Q, m) or (m,) boolean mask of
        candidates to suppress: their bounds become +inf on the device,
        so they fall past the finite frontier and never reach
        verification (an epoch pin, a self-join's trivial-match zone)."""
        self._sync()
        rep_q, q_n = self._encode_queries(queries_raw)
        if self._synced_n == 0:
            return DeviceOrderedStream.empty(q_n)
        b, ids = self._local_bounds(rep_q)
        if mask_fn is not None and b.shape[1]:
            mask = torch.as_tensor(mask_fn(ids), device=self.device)
            b = b.masked_fill(mask, float("inf"))
        if self.mesh.group is None:          # ids are 0 .. n - 1
            return _order_stream(b, width=self._synced_n)
        return WorldOrderedStream.from_bounds(b, ids, self.mesh,
                                              self._synced_n)

    # -- layout -----------------------------------------------------------
    def shard_ranges(self):
        """Contiguous row ranges of the head — the snapshot manifest's
        per-host unit (``store.snapshot._shard_ranges``), deliberately
        not the device layout (``owned_rows``)."""
        from repro_torch.store.snapshot import _shard_ranges
        return _shard_ranges(self._head, self.n_shards)

    def owned_rows(self, shard: int) -> np.ndarray:
        """Global row ids of the head resident on ``shard`` (row ``i`` on
        shard ``i % n_shards``, held by the rank whose ``mesh.shards``
        has it)."""
        return np.arange(shard, self._head, self.n_shards, dtype=np.int64)

    # -- device-resident verification ---------------------------------------
    def make_dist_fn(self, queries_raw):
        """Device verification closure for one query batch: ``dist(aq,
        cand) -> (Qa, B)`` true d_ED of candidate row ids, one gathered K1
        launch over this rank's flattened raw mirror per call (and an
        all-reduce MIN over a world); only the (Qa, B) distances come
        back.  Ids of -1 or past the synced frontier give +inf
        (``core.engine.topk_verify``'s ``dist_fn`` contract)."""
        if not self.mirror_raw:
            raise ValueError("ShardedRepSweep was built without "
                             "mirror_raw=True; no raw device mirror to "
                             "verify against")
        self._sync()
        q_dev = _device_rows(queries_raw, self.device)
        if q_dev.ndim == 1:
            q_dev = q_dev[None]
        n_syn = self._synced_n

        def dist(aq, cand):
            cand = np.asarray(cand, np.int64)
            valid = (cand >= 0) & (cand < n_syn)
            if not valid.any():
                return np.full(cand.shape, np.inf, np.float32)
            mir = self._raw_mirror
            c = torch.as_tensor(np.where(valid, cand, 0), device=self.device)
            own, slot = mir.local_slot(c)
            own &= torch.as_tensor(valid, device=self.device)
            q = q_dev[torch.as_tensor(np.asarray(aq, np.int64),
                                      device=self.device)]
            d = _owned_d2(self.mesh, mir.flat(), q, own, slot)
            return np.where(valid, d, np.float32(np.inf)).astype(np.float32)

        return dist


def make_engine_service(encoder, dataset, mesh, store=None, *,
                        batch_size: int = 64, verify: str = "auto",
                        pairwise: Callable | None = None,
                        media: str = "ssd", metrics=None):
    """A ``core.engine.MatchEngine`` over a sharded sweep.

    Builds (or adopts) a ``repro_torch.store.SymbolicStore``, encodes
    ``dataset`` shard by shard, and returns an engine whose exact top-k
    orders candidates on the mesh's device
    (``ShardedRepSweep.candidate_stream``) and whose approximate top-k
    takes the sweep's candidate frontier.  ``engine.ingest(rows)``
    encodes only the new chunk, and the next query uploads only it.

    ``store``: a ``SymbolicStore`` (adopted; ``dataset`` may be None to
    serve its rows), a ``RawStore`` (its cost model and rows are
    adopted), or None (a new store with the ``media`` preset).

    ``verify``: "device" mirrors the raw rows beside the representation
    and verifies on the device through K1, moving no raw row to the
    host; "host" is the bitwise-equal host route (store fetch, then the
    same K1); "auto" / "numpy" / "kernel" as in ``core.engine``.

    Over a world mesh (``make_mesh(S, device, group=)``) every rank
    builds this engine with the same arguments and makes the same calls
    in the same order (SPMD): ``engine.ingest`` with the same rows,
    ``engine.topk`` with the same queries.  The engine loop
    (``core.engine.topk_verify``) then runs on every rank, and each of
    its decisions — which queries stay active, which ids a round takes,
    their distances — comes from a collective result that is identical
    on all ranks (``WorldOrderedStream``, the all-reduced verification),
    so the loops stay in step and every rank returns the same answer,
    bitwise the single-process engine's at the same S.  With
    ``verify="host"`` each rank fetches from its own whole store and
    verifies with no collective.  Calls from several threads at once
    are not supported over a world: their collectives would not line
    up across ranks.
    """
    from repro_torch.core.engine import MatchEngine
    from repro_torch.store import SymbolicStore

    if isinstance(store, SymbolicStore):
        sym = store
        if dataset is not None and sym.n:
            raise ValueError(
                "both a non-empty SymbolicStore and a dataset were given; "
                "pass dataset=None to serve the store's rows, or "
                "engine.ingest(dataset) explicitly to append them")
    elif store is not None:              # RawStore: adopt its cost model
        sym = SymbolicStore(encoder, seek_s=store.seek_s,
                            read_bps=store.read_bps, device=mesh.device)
        if dataset is None and store.data.shape[0]:
            dataset = store.data         # ...and its rows
    else:
        sym = SymbolicStore(encoder, media=media, device=mesh.device)

    device_verify = verify == "device"
    sweep = ShardedRepSweep(encoder, mesh, sym, pairwise=pairwise,
                            mirror_raw=device_verify)
    if dataset is not None and sym.n == 0:
        sweep.ingest(np.asarray(dataset, np.float32))

    engine = MatchEngine(encoder, sym, batch_size=batch_size,
                         verify=verify, pairwise=pairwise,
                         repr_fn=sweep.repr_distances,
                         cand_fn=sweep.candidates,
                         stream_factory=sweep.candidate_stream,
                         dist_factory=(sweep.make_dist_fn
                                       if device_verify else None),
                         metrics=metrics, device=mesh.device)
    engine.sweep = sweep
    engine.ingest = sweep.ingest
    return engine


class ShardedWindowSweep:
    """Sharded window sweep and device-resident window verification for
    ``repro_torch.subseq.SubseqEngine``.

    * The (Q, n_windows) sweep is an inner :class:`ShardedRepSweep` over
      the view's representation store: window-representation rows ARE
      window ids, so ``candidate_stream`` feeds ``topk_verify`` without
      a host matrix.
    * ``make_dist_fn`` verifies candidate WINDOWS on the device: the
      view's SOURCE rows are mirrored round-robin; each round cuts its
      windows from the flattened mirror, z-normalizes them with
      ``core.normalize.znormalize`` (the definition the host's
      ``znorm_windows`` shares) and distances them in one gathered K1
      launch.  No window value reaches the host.  Over a world each rank
      mirrors the source rows of its own shards and verifies the windows
      cut from them; an all-reduce MIN combines the ranks.
    """

    mirror_layout = "round_robin"

    def __init__(self, view, mesh, *, pairwise: Callable | None = None,
                 mirror_raw: bool = True):
        self.view = view
        self.mesh = mesh
        self.device = mesh.device
        self.rep_sweep = ShardedRepSweep(view.encoder, mesh, view.rep_store,
                                         pairwise=pairwise)
        self.n_shards = self.rep_sweep.n_shards
        self.mirror_raw = bool(mirror_raw)
        self._raw_mirror = None          # RoundRobinMirror of SOURCE rows
        self._head_rows = 0
        self._rows_synced = -1

    def repr_distances(self, queries_z) -> np.ndarray:
        """(Q, n_windows) host bound matrix for z-normalized queries (the
        exclusion path masks its columns)."""
        return self.rep_sweep.repr_distances(queries_z)

    def candidate_stream(self, queries_z, mask_fn=None):
        """Device-ordered window candidate stream (global window ids)."""
        return self.rep_sweep.candidate_stream(queries_z, mask_fn=mask_fn)

    @property
    def h2d_bytes(self) -> int:
        total = self.rep_sweep.h2d_bytes
        if self._raw_mirror is not None:
            total += self._raw_mirror.h2d_bytes
        return total

    @property
    def host_order_bytes(self) -> int:
        return self.rep_sweep.host_order_bytes

    def _sync_raw(self):
        """Incremental round-robin mirror of the source rows (an
        append-only corpus: its row count is a complete freshness
        test)."""
        n_rows = self.view.n_rows
        if n_rows == self._rows_synced:
            return
        if self._raw_mirror is None:
            self._raw_mirror = RoundRobinMirror(self.mesh)
        data = self.view.source.data
        head = (n_rows // self.n_shards) * self.n_shards
        self._raw_mirror.append(np.asarray(data[self._head_rows:head],
                                           np.float32))
        self._raw_mirror.stage_tail(np.asarray(data[head:n_rows],
                                               np.float32))
        self._head_rows = head
        self._rows_synced = n_rows

    def make_dist_fn(self, queries_z):
        """Device window verification closure for one z-normalized query
        batch (``core.engine.topk_verify``'s ``dist_fn`` contract over
        window ids): one gathered K1 launch per call over the windows of
        this rank's source rows (and an all-reduce MIN over a world)."""
        if not self.mirror_raw:
            raise ValueError("ShardedWindowSweep was built without "
                             "mirror_raw=True")
        from repro_torch.core.normalize import znormalize
        self._sync_raw()
        q_dev = _device_rows(queries_z, self.device)
        if q_dev.ndim == 1:
            q_dev = q_dev[None]
        view = self.view
        nw, stride, m = view.windows_per_row, view.stride, view.m
        n_wid = self._rows_synced * nw
        span = torch.arange(m, device=self.device)

        def dist(aq, cand):
            cand = np.asarray(cand, np.int64)
            valid = (cand >= 0) & (cand < n_wid)
            if not valid.any():
                return np.full(cand.shape, np.inf, np.float32)
            mir = self._raw_mirror
            src = mir.flat()                    # (S / R * cap, T_src)
            c = torch.as_tensor(np.where(valid, cand, 0), device=self.device)
            row, start = c // nw, (c % nw) * stride
            own, slot = mir.local_slot(row)
            own &= torch.as_tensor(valid, device=self.device)
            at = (slot * src.shape[1] + start)[..., None] + span
            w = znormalize(src.reshape(-1)[at]).reshape(-1, m)
            gather = torch.arange(w.shape[0], device=self.device).reshape(
                cand.shape)
            q = q_dev[torch.as_tensor(np.asarray(aq, np.int64),
                                      device=self.device)]
            d = _owned_d2(self.mesh, w, q, own, gather)
            return np.where(valid, d, np.float32(np.inf)).astype(np.float32)

        return dist
