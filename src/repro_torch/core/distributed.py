"""Sharded matching engine on virtual shards of one device.

The JAX package maps the paper's pipeline onto a device mesh: the
dataset's N series are sharded over the ("pod", "data") axes and each
stage runs once per shard.  Here the shard axis is a leading tensor axis
on ONE device (``ShardMesh``, made by :func:`make_mesh`): every stage
runs its per-shard work on the mesh's device, and the results are the
unsharded call's bit for bit — the shard count changes the layout only,
never the bits, because every per-(query, row) quantity is a row-wise
map:

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
``(S, capacity, *rest)`` tensor.  An append of ``d * S`` rows lands in
slots ``[per_live, per_live + d)`` of every shard, so an append uploads
only its chunk and the resident rows never move; capacity doubles on the
device.  The largest S-divisible prefix (the "head") fills whole slots;
the fewer than S rows past it (the "tail") are staged in their own
round-robin places, slot ``per_live`` of shards ``0 .. tail - 1``, and
are overwritten in place by the append that completes the slot.  So one
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
"""

from __future__ import annotations

import threading
from typing import Callable, Optional

import numpy as np
import torch

from repro_torch.core.engine import resolve_device
from repro_torch.kernels.euclid import euclid_gather


# ---------------------------------------------------------------------------
# The mesh
# ---------------------------------------------------------------------------

class ShardMesh:
    """``n_shards`` virtual shards of one device.  ``shape`` maps the data
    axis to the shard count, as a JAX mesh's does, so code reading
    ``mesh.shape[a]`` for the data axes works unchanged."""

    def __init__(self, n_shards: int, device):
        if int(n_shards) < 1:
            raise ValueError(f"n_shards must be >= 1, got {n_shards}")
        self.n_shards = int(n_shards)
        self.device = torch.device(device)
        self.shape = {"data": self.n_shards}


def make_mesh(n_shards: int = 1, device="cuda") -> ShardMesh:
    """A mesh of ``n_shards`` virtual shards on ``device``: the CUDA card
    by default, which must exist (pass ``device="cpu"`` for the CPU)."""
    return ShardMesh(n_shards, resolve_device(device))


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

def _shard_map(fn, rows, mesh) -> list:
    """``fn`` over ``rows`` split into the mesh's contiguous shards
    (padded to a shard multiple); one output per shard."""
    S = _n_shards(mesh)
    parts = torch.chunk(_pad_rows(rows, S), S) if rows.shape[0] else (rows,)
    return [fn(p) for p in parts]


def encode_sharded(encoder, dataset, mesh):
    """Encode a (N, T) dataset shard by shard (contiguous row ranges) on
    the mesh's device; returns the encoder's structure of device tensors,
    bitwise the unsharded ``encoder.encode``."""
    x = _device_rows(dataset, mesh.device)
    parts = _shard_map(encoder.encode, x, mesh)
    leaves = [torch.cat(ls)[:x.shape[0]]
              for ls in zip(*(_leaves(p) for p in parts))]
    return _like(parts[0], leaves)


def rowwise_sharded(obj, method: str, rows, mesh):
    """Run ``getattr(obj, method)`` — any row-wise device map with a
    (N, T) input — over ``rows`` split into the mesh's shards on its
    device (padded to a shard multiple, trimmed), and return the same
    structure (tensor, tuple or list) of host arrays.  The map runs once
    per shard on the same device, so the output is bitwise the unsharded
    call's (the index features the split tree stores rely on it)."""
    x = _device_rows(rows, mesh.device)
    if x.ndim == 1:
        x = x[None]
    outs = _shard_map(getattr(obj, method), x, mesh)

    def host(ts):
        return torch.cat(ts)[:x.shape[0]].cpu().numpy()
    if isinstance(outs[0], (tuple, list)):
        return type(outs[0])(host(ts) for ts in zip(*outs))
    return host(outs)


def _split_rep(rep, n_shards: int):
    """The representation's leaves split into ``n_shards`` contiguous
    row ranges: a list of per-shard reps."""
    chunks = [torch.tensor_split(l, n_shards) for l in _leaves(rep)]
    return [_like(rep, ls) for ls in zip(*chunks)]


def repr_distances_sharded(encoder, rep_query, rep_data, mesh,
                           pairwise: Callable | None = None):
    """(Q, N) representation bounds, computed shard by shard (contiguous
    row ranges of ``rep_data``) on the mesh's device."""
    pw = pairwise or encoder.pairwise_distance
    return torch.cat([pw(rep_query, r) for r in
                      _split_rep(rep_data, _n_shards(mesh))], dim=1)


def _take_smallest(d, k: int):
    """(Q, C) -> the k smallest per row by (value, column), stably."""
    sd, order = torch.sort(d, dim=1, stable=True)
    return sd[:, :k], order[:, :k]


def repr_topk_sharded(encoder, rep_query, rep_data, mesh, *, k: int = 64,
                      pairwise: Callable | None = None):
    """Global top-k candidates (distances (Q, k), global ids (Q, k)):
    each shard keeps its k best, the k * S survivors are merged.  Ties
    break toward the smaller id (gather order is id order here)."""
    pw = pairwise or encoder.pairwise_distance
    ds, ids, lo = [], [], 0
    for r in _split_rep(rep_data, _n_shards(mesh)):
        d = pw(rep_query, r)
        kk = min(k, d.shape[1])
        cd, ci = _take_smallest(d, kk)
        ds.append(cd)
        ids.append(ci + lo)
        lo += d.shape[1]
    cand_d, cand_i = torch.cat(ds, dim=1), torch.cat(ids, dim=1)
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

    Global row ``i`` lives at ``buf[i % S, i // S]`` of an ``(S,
    capacity, *rest)`` tensor on the mesh's device.  ``append`` of ``d *
    S`` rows uploads exactly those rows (``h2d_bytes`` counts them) into
    slots ``[per_live, per_live + d)`` of every shard; the resident rows
    are never uploaded again.  Capacity doubles on the device (a device
    copy, no host traffic).  ``stage_tail`` places fewer than S rows past
    the head in slot ``per_live`` of the first shards, their round-robin
    places, without making the slot live; their bytes go to
    ``tail_h2d_bytes``.  Slots past the live rows hold zeros (valid
    symbols), and every consumer masks them."""

    def __init__(self, mesh):
        self.mesh = mesh
        self.n_shards = _n_shards(mesh)
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
        """Rows the mirror holds: the head and the staged tail."""
        return self.per_live * self.n_shards + self.n_tail

    def flat(self) -> torch.Tensor:
        """The buffer as ``(S * capacity, *rest)``: row ``i`` at
        ``(i % S) * capacity + i // S``."""
        return self.buf.reshape((-1,) + tuple(self.buf.shape[2:]))

    def _upload(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(
            self.mesh.device)

    def _reserve(self, slots: int, rest: tuple, dtype) -> None:
        """Capacity for ``slots`` slots per shard, doubling on growth."""
        if self.buf is None:
            self.buf = torch.zeros((self.n_shards, slots) + rest,
                                   dtype=dtype, device=self.mesh.device)
        elif slots > self.cap:
            new = torch.zeros((self.n_shards, max(2 * self.cap, slots))
                              + rest, dtype=dtype, device=self.buf.device)
            new[:, :self.cap] = self.buf
            self.buf = new

    def append(self, rows) -> None:
        """Upload ``rows`` (a multiple of S rows, in global row order,
        continuing the head) into the next free slot of every shard."""
        rows = np.asarray(rows)
        S = self.n_shards
        if rows.shape[0] % S:
            raise ValueError(f"append of {rows.shape[0]} rows is not a "
                             f"multiple of n_shards={S}")
        d = rows.shape[0] // S
        if d == 0:
            return
        # (d*S, ...) -> (S, d, ...): appended row j*S + s -> shard s,
        # slot per_live + j
        blk = self._upload(rows.reshape((d, S) + rows.shape[1:])
                           .swapaxes(0, 1))
        self.h2d_bytes += rows.nbytes
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
        of shards ``0 .. len(rows) - 1`` (replacing any staged before)."""
        rows = np.asarray(rows)
        if rows.shape[0] >= self.n_shards:
            raise ValueError(f"a tail of {rows.shape[0]} rows is not "
                             f"shorter than n_shards={self.n_shards}")
        self.n_tail = int(rows.shape[0])
        if not self.n_tail:
            return
        dev = self._upload(rows)
        self._reserve(self.per_live + 1, tuple(dev.shape[1:]), dev.dtype)
        self.buf[:self.n_tail, self.per_live] = dev
        self.tail_h2d_bytes += rows.nbytes

    def dead_mask(self) -> torch.Tensor:
        """(S, capacity) bool: True where a slot holds no row."""
        slot = torch.arange(self.cap, device=self.buf.device)[None, :]
        shard = torch.arange(self.n_shards, device=self.buf.device)[:, None]
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
        nxt = self._b[rows, cols].cpu().numpy().astype(np.float64)
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
                                      device=dev)].cpu().numpy()
        self._pos[aq] += valid.sum(axis=1)
        return np.where(valid, ids, -1).astype(np.int64)


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
    n_fin = torch.isfinite(b).sum(dim=1).cpu().numpy()
    return DeviceOrderedStream(sb, si, n_fin, width)


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

def _rows_d2(rows_flat, q, slot) -> np.ndarray:
    """Squared distances of queries ``q`` (Qa, T) to ``rows_flat[slot]``
    ((Qa, B) device slots) through one gathered K1 launch, square-rooted
    as ``core.engine.kernel_verifier`` does: (Qa, B) f32 on the host."""
    d2 = euclid_gather(rows_flat, q, slot)
    return np.sqrt(np.maximum(d2.cpu().numpy(), 0.0))


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
        """(Q, S * capacity) blocked bounds over the mirrors, one sweep
        (one ``pairwise`` call): column ``s * capacity + j`` holds global
        row ``j * S + s``; slots without a row are +inf."""
        flat = [m.flat() for m in self._mirrors]
        flat = tuple(flat) if self._rep_is_tuple else flat[0]
        d = self._pw(rep_q, flat)
        mir = self._mirrors[0]
        d = d.reshape(d.shape[0], self.n_shards, mir.cap)
        d = d.masked_fill(mir.dead_mask()[None], float("inf"))
        return d.reshape(d.shape[0], -1)

    def _natural_bounds(self, rep_q) -> torch.Tensor:
        """(Q, n) device bounds in natural id order: the blocked matrix
        transposed on the device (block column s*cap + j -> id j*S + s;
        the staged tail lands right after the head)."""
        blk = self._rr_bounds(rep_q)
        q_n, cap = blk.shape[0], self._mirrors[0].cap
        nat = blk.reshape(q_n, self.n_shards, cap).transpose(1, 2)
        return nat.reshape(q_n, -1)[:, :self._synced_n]

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
        per query by (bound, id), picked on the device; -1 where the
        bound is infinite."""
        self._sync()
        rep_q, q_n = self._encode_queries(queries_raw)
        k = min(int(k), self._synced_n)
        if k == 0:
            return np.empty((q_n, 0), np.int64)
        sb, ids = _take_smallest(self._natural_bounds(rep_q), k)
        ids = torch.where(torch.isfinite(sb), ids, -1)
        return ids.cpu().numpy().astype(np.int64)

    def candidate_stream(self, queries_raw,
                         mask_fn=None) -> DeviceOrderedStream:
        """Device-ordered exact candidate frontier over every synced row.

        ``mask_fn``, if given, maps the (n,) int64 device id vector to a
        (Q, n) or (n,) boolean mask of candidates to suppress: their
        bounds become +inf on the device, so they fall past the finite
        frontier and never reach verification (an epoch pin, a
        self-join's trivial-match zone)."""
        self._sync()
        rep_q, q_n = self._encode_queries(queries_raw)
        if self._synced_n == 0:
            return DeviceOrderedStream.empty(q_n)
        b = self._natural_bounds(rep_q)
        if mask_fn is not None:
            ids = torch.arange(self._synced_n, device=self.device)
            mask = torch.as_tensor(mask_fn(ids), device=self.device)
            b = b.masked_fill(mask, float("inf"))
        return _order_stream(b, width=self._synced_n)

    # -- layout -----------------------------------------------------------
    def shard_ranges(self):
        """Contiguous row ranges of the head — the snapshot manifest's
        per-host unit (``store.snapshot._shard_ranges``), deliberately
        not the device layout (``owned_rows``)."""
        from repro_torch.store.snapshot import _shard_ranges
        return _shard_ranges(self._head, self.n_shards)

    def owned_rows(self, shard: int) -> np.ndarray:
        """Global row ids of the head resident on ``shard`` (row ``i`` on
        shard ``i % n_shards``)."""
        return np.arange(shard, self._head, self.n_shards, dtype=np.int64)

    # -- device-resident verification ---------------------------------------
    def make_dist_fn(self, queries_raw):
        """Device verification closure for one query batch: ``dist(aq,
        cand) -> (Qa, B)`` true d_ED of candidate row ids, one gathered K1
        launch over the flattened raw mirror per call; only the (Qa, B)
        distances come back.  Ids of -1 or past the synced frontier give
        +inf (``core.engine.topk_verify``'s ``dist_fn`` contract)."""
        if not self.mirror_raw:
            raise ValueError("ShardedRepSweep was built without "
                             "mirror_raw=True; no raw device mirror to "
                             "verify against")
        self._sync()
        q_dev = _device_rows(queries_raw, self.device)
        if q_dev.ndim == 1:
            q_dev = q_dev[None]
        n_syn, S = self._synced_n, self.n_shards

        def dist(aq, cand):
            cand = np.asarray(cand, np.int64)
            valid = (cand >= 0) & (cand < n_syn)
            if not valid.any():
                return np.full(cand.shape, np.inf, np.float32)
            mir = self._raw_mirror
            c = torch.as_tensor(np.where(valid, cand, 0), device=self.device)
            slot = (c % S) * mir.cap + c // S
            q = q_dev[torch.as_tensor(np.asarray(aq, np.int64),
                                      device=self.device)]
            d = _rows_d2(mir.flat(), q, slot)
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
      launch.  No window value reaches the host.
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

    def candidate_stream(self, queries_z,
                         mask_fn=None) -> DeviceOrderedStream:
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
        window ids): one gathered K1 launch per call."""
        if not self.mirror_raw:
            raise ValueError("ShardedWindowSweep was built without "
                             "mirror_raw=True")
        from repro_torch.core.normalize import znormalize
        self._sync_raw()
        q_dev = _device_rows(queries_z, self.device)
        if q_dev.ndim == 1:
            q_dev = q_dev[None]
        view, S = self.view, self.n_shards
        nw, stride, m = view.windows_per_row, view.stride, view.m
        n_wid = self._rows_synced * nw
        span = torch.arange(m, device=self.device)

        def dist(aq, cand):
            cand = np.asarray(cand, np.int64)
            valid = (cand >= 0) & (cand < n_wid)
            if not valid.any():
                return np.full(cand.shape, np.inf, np.float32)
            mir = self._raw_mirror
            src = mir.flat()                          # (S * cap, T_src)
            c = torch.as_tensor(np.where(valid, cand, 0), device=self.device)
            row, start = c // nw, (c % nw) * stride
            slot = (row % S) * mir.cap + row // S
            at = (slot * src.shape[1] + start)[..., None] + span
            w = znormalize(src.reshape(-1)[at]).reshape(-1, m)
            gather = torch.arange(w.shape[0], device=self.device).reshape(
                cand.shape)
            q = q_dev[torch.as_tensor(np.asarray(aq, np.int64),
                                      device=self.device)]
            d = _rows_d2(w, q, gather)
            return np.where(valid, d, np.float32(np.inf)).astype(np.float32)

        return dist
