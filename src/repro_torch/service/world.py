"""The matching service over a ``torch.distributed`` world of ranks: one
leader rank serves, the others replay its engine calls in order.

The JAX package has no counterpart of this module.  There one process
drives every device of the mesh (GSPMD), so any thread of
``MatchSession`` — the coalescing queue's dispatcher, the replica
workers, an ingest writer, the caller's oracle — may call a multi-device
engine.  Over a world of ranks (``core.distributed.make_mesh(S, device,
group=)``) every rank must make the same engine calls in the same order
(SPMD), and collectives issued from several threads do not line up
across ranks.  So the service runs on rank 0 only, and the engine calls
it makes are replayed by the other ranks:

* **Leader (rank 0).** :class:`WorldChannel` wraps each engine the
  session calls — the primary, each replica, the ``selfjoin`` engine — in
  an :class:`EngineFront`.  A front passes attribute reads (``store``,
  ``view``, ``encoder``, ``metrics``, ``mesh`` ...) through to its
  engine, so ``MatchSession``'s auto-detection and host reads work
  unchanged.  Every call that can issue a collective or mutate a rank's
  store or mirrors (``topk``, ``topk_approx``, ``ingest``, ``profile``,
  ``build_index``) is queued to the channel's one thread,
  which broadcasts one op record — engine slot, method, the queries as
  the bucketed numpy array, k, ``source`` / ``use_index``, ``collect``,
  the epoch pin as its ``n_rows`` int, whether a trace is on, the ingest
  rows — then makes the call itself with exactly the record's arguments
  and hands the result back to the caller's thread.  So the leader's
  collectives and device work all come from one thread, as on a
  follower (collectives of a gloo group issued from several threads of
  one rank aborted a CPU world at exit now and then).
* **Followers (ranks >= 1).** They build the same engines with the same
  arguments, then :meth:`WorldChannel.follow` loops in one thread:
  receive an op, make the same call on the same engine slot (with a
  fresh ``Trace`` when the leader traced), hash the result, repeat until
  the stop op.
* **Shared state is decided on rank 0 only.**  The queue, the planner,
  coalescing, deadlines and sheds, replica placement and
  ``kill_replica`` are never broadcast; a shed request issues no op.

**The invariant.**  Every mutation of a rank's store, mirrors, index and
self-join profile cache happens inside an op, and ops run in the same
order on every rank.  So at each op every rank has the same live
frontier, the same epoch ledger and the same index, and
``ShardedRepSweep._sync`` (which reads the live epoch) and
``SelfJoinEngine``'s profile cache (keyed on the live corpus) see the
same state everywhere.  Nothing may ingest, append or build an index
outside the channel once it is open.

**Timing the planner learns.**  ``MatchSession._run_group`` times the
engine call for the planner; through a front that time also holds the
op's wait in the channel's queue.  The planner learns the call plus the
wait: its estimates decide deadline downgrades, and a deadline is met
or missed on what the client waits, queue included.  The channel
reports the waits apart (``stats["wait_s"]``).

**Replicas lose their concurrency.**  Replica workers still run on their
own threads on the leader, but their calls serialize in the channel, so
over a world a second replica adds failover, not throughput.

**Failure.**  An engine call that raises does so on every rank at the
same op (the inputs are the same): the leader's caller gets the error
(the session resolves its requests with it) and followers record it and
keep following.  An idle leader sends a keep-alive op every
``keepalive_s``, so a follower waiting for the next op never reaches the
channel group's timeout while the leader is merely idle; a rank that
dies ends the others with that timeout's (or the transport's) error,
never a hang.  :meth:`WorldChannel.close` broadcasts the stop op; then
every rank all-gathers its hash of every op's result and its stores'
epoch ledgers, and a follower whose hash differs from rank 0's raises.
"""

from __future__ import annotations

import functools
import hashlib
import queue
import threading
import time
from concurrent.futures import Future
from datetime import timedelta
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.index import SeriesIndex
from repro_torch.store.symbolic import epoch_rows

#: op kinds of a record's first field
CALL, KEEPALIVE, STOP = "call", "keepalive", "stop"


def _digest(h, obj) -> None:
    """Fold a result into ``h``: arrays by dtype, shape and bytes;
    dataclasses field by field (a trace is left out: its spans carry
    wall times); numbers and strings by ``repr``; a split-tree index
    (what ``build_index`` returns) by its item and node counts.  Any
    other type raises ``TypeError``, so a result the hash cannot see
    into never passes as equal across ranks."""
    if isinstance(obj, np.ndarray):
        h.update(str((obj.dtype, obj.shape)).encode())
        h.update(np.ascontiguousarray(obj).tobytes())
    elif hasattr(obj, "__dataclass_fields__"):
        for name in obj.__dataclass_fields__:
            if name != "trace":
                h.update(name.encode())
                _digest(h, getattr(obj, name))
    elif isinstance(obj, (tuple, list)):
        for x in obj:
            _digest(h, x)
    elif obj is None or isinstance(obj, (int, float, str, np.generic)):
        h.update(repr(obj).encode())
    elif isinstance(obj, SeriesIndex):
        h.update(repr(("index", len(obj), obj.n_nodes)).encode())
    else:
        raise TypeError(f"the world channel cannot hash a "
                        f"{type(obj).__name__} result")


def engine_mesh(engine):
    """The ``core.distributed.ShardMesh`` an engine runs on (its own,
    or its sweep's: ``MatchEngine.sweep``, ``SelfJoinEngine._sweep``),
    or None."""
    mesh = getattr(engine, "mesh", None)
    for sweep in ("sweep", "_sweep"):
        if mesh is None:
            mesh = getattr(getattr(engine, sweep, None), "mesh", None)
    return mesh


class EngineFront:
    """The leader's stand-in for one engine slot: calls that can issue a
    collective or mutate state go through the channel; every other
    attribute is the engine's own."""

    def __init__(self, channel: "WorldChannel", slot: int, engine):
        self._channel = channel
        self._slot = slot
        self._engine = engine

    def __getattr__(self, name):
        return getattr(self.__dict__["_engine"], name)

    def _call(self, method: str, *args, **kw):
        return self._channel.call(self._slot, method, *args, **kw)

    def topk(self, queries, k: int = 1, **kw):
        return self._call("topk", queries, k=k, **kw)

    def topk_approx(self, queries, k: int = 1, **kw):
        return self._call("topk_approx", queries, k=k, **kw)

    def ingest(self, rows):
        return self._call("ingest", rows)

    def profile(self, **kw):
        return self._call("profile", **kw)

    def build_index(self, **kw):
        """Build the split-tree index of the engine's store or view."""
        return self._call("view.build_index" if hasattr(self._engine, "view")
                          else "store.build_index", **kw)


class WorldChannel:
    """The ordered op channel of one world (see module doc).

    Every rank makes one, at the same point and with its own engines in
    the same slot order (``None`` for an empty slot): it creates a gloo
    group over ``group``'s ranks, so control records never go through
    NCCL's stream.  Rank 0 then serves through :attr:`fronts` and ends
    with :meth:`close`; the other ranks call :meth:`follow`, which
    returns after the stop op.

    On rank 0 one thread of the channel makes every op: the callers'
    threads (the session's dispatcher and replica workers, a writer, the
    oracle) queue their calls and wait for the results, so all of the
    leader's collectives and device work come from one thread, as on the
    followers, and that thread sets the engines' mesh device as its CUDA
    device.  ``timeout_s``: the channel group's timeout, how long a
    follower waits for the next op before it fails.  ``keepalive_s``
    (default a tenth of it): how long the leader stays silent before it
    sends a keep-alive op."""

    def __init__(self, engines: Sequence, group, *,
                 timeout_s: float = 300.0,
                 keepalive_s: Optional[float] = None):
        self.engines = list(engines)
        self.rank = dist.get_rank(group)
        self.world = dist.get_world_size(group)
        mesh = engine_mesh(next(e for e in self.engines if e is not None))
        self.device = None if mesh is None else torch.device(mesh.device)
        self.group = dist.new_group(dist.get_process_group_ranks(group),
                                    backend="gloo",
                                    timeout=timedelta(seconds=timeout_s))
        self._src = dist.get_global_rank(self.group, 0)
        self.keepalive_s = (float(keepalive_s) if keepalive_s is not None
                            else timeout_s / 10)
        self.stats = {"ops": 0, "keepalives": 0, "errors": 0,
                      "broadcast_s": 0.0, "bytes": 0, "wait_s": 0.0,
                      "by_method": {}}
        self._hash = hashlib.sha256()
        self._error: Optional[BaseException] = None
        self._closed = False
        self._every = None
        self.fronts = []
        if self.rank == 0:
            self.fronts = [None if e is None else EngineFront(self, i, e)
                           for i, e in enumerate(self.engines)]
            self._ops = queue.Queue()
            self._admit = threading.Lock()
            self._thread = threading.Thread(target=self._lead,
                                            name="world-leader", daemon=True)
            self._thread.start()

    # -- leader ------------------------------------------------------------
    def call(self, slot: int, method: str, *args, **kw):
        """Make one op on every rank (from rank 0) and return rank 0's
        result, or raise its error."""
        if self.rank != 0:
            raise RuntimeError("only rank 0 calls through the channel; the "
                               "other ranks follow()")
        args = tuple(np.ascontiguousarray(a, np.float32)
                     if isinstance(a, (np.ndarray, list)) else a
                     for a in args)
        if kw.get("epoch") is not None:
            kw["epoch"] = epoch_rows(kw["epoch"])
        fut = Future()
        with self._admit:
            if self._closed or self._error is not None:
                raise RuntimeError("the world channel is closed") \
                    from self._error
            self._ops.put((slot, method, args, kw, fut, time.perf_counter()))
        return fut.result()

    def _lead(self) -> None:
        """The leader's one thread: broadcast each queued op and make it
        here; a keep-alive when no op came for ``keepalive_s``; the stop
        op and the summaries at close."""
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        seq = 0
        while True:
            try:
                item = self._ops.get(timeout=self.keepalive_s)
            except queue.Empty:
                if not self._send((KEEPALIVE,), None):
                    return
                self.stats["keepalives"] += 1
                continue
            if item is None:
                if self._send((STOP,), None):
                    self._every = self._finish()
                return
            slot, method, args, kw, fut, t_put = item
            seq += 1
            trace = kw.pop("trace", None)
            rec = (CALL, seq, slot, method, args, kw,
                   None if trace is None else trace.name)
            wait = time.perf_counter() - t_put
            t0 = time.perf_counter()
            if not self._send(rec, fut):
                return
            m = self.stats["by_method"].setdefault(
                method, {"ops": 0, "broadcast_s": 0.0, "bytes": 0})
            for st in (self.stats, m):
                st["ops"] += 1
                st["broadcast_s"] += time.perf_counter() - t0
                st["bytes"] += sum(a.nbytes for a in args
                                   if isinstance(a, np.ndarray))
            self.stats["wait_s"] += wait
            try:
                fut.set_result(self._apply(
                    rec, kw if trace is None else dict(kw, trace=trace)))
            except Exception as err:     # noqa: BLE001 — the caller's
                fut.set_exception(err)   # to handle, as without a world

    def _send(self, rec, fut) -> bool:
        """Broadcast ``rec``; on failure (a rank died, the group timed
        out) fail ``fut`` and every queued op with the error and close
        the channel."""
        try:
            dist.broadcast_object_list([rec], src=self._src,
                                       group=self.group)
            return True
        except Exception as err:     # noqa: BLE001 — handed to callers
            with self._admit:
                self._error = err
            pending = [fut] if fut is not None else []
            while not self._ops.empty():
                item = self._ops.get()
                if item is not None:
                    pending.append(item[4])
            for f in pending:
                f.set_exception(RuntimeError(
                    f"the world channel failed: {err}"))
            return False

    def close(self) -> list:
        """End the world's service (after its session has closed and
        drained its queue): broadcast the stop op and gather every
        rank's summary (:meth:`summary`); returns them in rank order."""
        with self._admit:
            self._closed = True
            if self._error is None:
                self._ops.put(None)
        self._thread.join()
        if self._every is None:
            raise RuntimeError("the world channel failed") from self._error
        return self._every

    # -- followers ---------------------------------------------------------
    def follow(self) -> list:
        """Replay the leader's ops until the stop op, then gather every
        rank's summary; raises when this rank's op hash differs from
        rank 0's."""
        if self.rank == 0:
            raise RuntimeError("rank 0 leads; it does not follow")
        from repro_torch.obs import Trace
        while True:
            box = [None]
            dist.broadcast_object_list(box, src=self._src, group=self.group)
            rec = box[0]
            if rec[0] == KEEPALIVE:
                self.stats["keepalives"] += 1
                continue
            if rec[0] == STOP:
                break
            kw = dict(rec[5])
            if rec[6] is not None:
                kw["trace"] = Trace(rec[6])
            self.stats["ops"] += 1
            try:
                self._apply(rec, kw)
            except Exception:       # noqa: BLE001 — raised on every rank
                pass                # alike: counted and hashed in _apply
        every = self._finish()
        if every[self.rank]["hash"] != every[0]["hash"]:
            raise RuntimeError(
                f"[world] rank {self.rank}: the results of its "
                f"{self.stats['ops']} ops differ from rank 0's")
        return every

    # -- both --------------------------------------------------------------
    def _apply(self, rec, kw):
        """Make op ``rec`` on this rank and fold its result (or its
        error's type) into the op hash."""
        _, seq, slot, method, args, _, _ = rec
        fn = functools.reduce(getattr, method.split("."), self.engines[slot])
        self._hash.update(repr((seq, slot, method)).encode())
        try:
            out = fn(*args, **kw)
        except Exception as err:
            self.stats["errors"] += 1
            self._hash.update(f"raised {type(err).__name__}".encode())
            raise
        _digest(self._hash, out)
        return out

    def summary(self) -> dict:
        """This rank's op count, error count, op hash and the epoch
        ``(epoch, n_rows)`` of each slot's store or view."""
        ledger = []
        for eng in self.engines:       # the store or window view of each
            corpus = getattr(eng, "view", None) or getattr(eng, "store", None)
            ep = getattr(corpus, "current_epoch", None)
            ledger.append(None if ep is None
                          else (int(ep().epoch), int(ep().n_rows)))
        return {"rank": self.rank, "ops": self.stats["ops"],
                "errors": self.stats["errors"],
                "hash": self._hash.hexdigest(), "epochs": ledger}

    def _finish(self) -> list:
        every = [None] * self.world
        dist.all_gather_object(every, self.summary(), group=self.group)
        return every


def ranks_agree(every: list) -> bool:
    """Every rank's op hash and epoch ledger equal rank 0's."""
    return all(s["hash"] == every[0]["hash"]
               and s["epochs"] == every[0]["epochs"] for s in every)
