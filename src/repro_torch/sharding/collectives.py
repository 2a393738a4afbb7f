"""The sharded step's collectives and local slices over one mesh: the one
place the port issues them.

A tensor's layout is its ``DTensor`` placements, one per mesh dim
(``specs.placements``): ``Shard(d)`` on a mesh dim splits tensor dim
``d`` evenly over that dim's ranks, several mesh dims sharding one tensor
dim split it major to minor (mesh order), as ``DTensor`` does.

On a runtime ``DeviceMesh`` the calls run over the mesh dims' process
groups; a mesh dim of size 1 issues nothing, so on a world of one every
call is a copy or a no-op.  On a mesh description (``launch.mesh.
MeshSpec``, the dry-run's) nothing runs: each call returns a meta tensor
of the shape rank 0 would get and adds the collective to ``counts``,
bytes by kind (all-gather: its output; reduce-scatter: its input;
all-reduce: its tensor) and one to ``count``.  So the dry-run's
collective bytes are what this code issues, not a formula kept beside it.
"""

from __future__ import annotations

import contextlib
import math

import torch

from repro_torch.sharding.specs import mesh_axes

KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all",
         "collective-permute")


def _gather_into(out, x, group):
    """All-gather along dim 0 (``all_gather_single`` where torch has it,
    its older name ``all_gather_into_tensor`` before)."""
    import torch.distributed as dist
    fn = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    fn(out, x, group=group)


def _scatter_into(out, x, group):
    """Sum-reduce-scatter along dim 0 (``reduce_scatter_single``, or
    ``reduce_scatter_tensor`` before it)."""
    import torch.distributed as dist
    fn = getattr(dist, "reduce_scatter_single", None) or \
        dist.reduce_scatter_tensor
    fn(out, x, group=group)


def _nbytes(shape, dtype) -> int:
    return math.prod(shape) * torch.empty((), dtype=dtype).element_size()


class Collectives:
    def __init__(self, mesh):
        from torch.distributed.device_mesh import DeviceMesh
        self.mesh = mesh
        self.sizes = tuple(mesh_axes(mesh).values())
        self.record = not isinstance(mesh, DeviceMesh)
        self.counts = dict.fromkeys(KINDS, 0)
        self.counts["count"] = 0
        # the part of ``counts`` the model issues (``BatchGroup``): once
        # per microbatch, where the rest is once per step
        self.model_counts = dict(self.counts)
        self._in_model = False
        if not self.record:
            import torch.distributed as dist
            if mesh.size() != dist.get_world_size():
                raise ValueError(f"mesh of {mesh.size()} ranks over a world "
                                 f"of {dist.get_world_size()}")

    # -- where this rank sits ------------------------------------------
    def coord(self, i: int) -> int:
        """This rank's index along mesh dim ``i`` (rank 0's when
        recording)."""
        return 0 if self.record else self.mesh.get_local_rank(i)

    def owns(self, placements) -> bool:
        """Whether this rank holds the first copy of its shard: index 0
        along every mesh dim that replicates it (so a sum over ranks
        counts each element once)."""
        return all(p.is_shard() or self.coord(i) == 0
                   for i, p in enumerate(placements))

    def device(self) -> torch.device:
        if self.record:
            return torch.device("meta")
        if self.mesh.device_type == "cuda":
            return torch.device("cuda", torch.cuda.current_device())
        return torch.device(self.mesh.device_type)

    # -- no communication ----------------------------------------------
    def local(self, full, placements, skip=()):
        """This rank's shard of ``full`` (a view where it can be): the
        slices of every ``Shard`` placement, mesh dims in order, except
        those in ``skip``."""
        x = full
        for i, p in enumerate(placements):
            if i in skip or not p.is_shard() or self.sizes[i] == 1:
                continue
            n, d = self.sizes[i], p.dim
            size = x.shape[d] // n
            x = x.narrow(d, self.coord(i) * size, size)
        return x

    # -- collectives ---------------------------------------------------
    def _log(self, kind: str, nbytes: int):
        for c in (self.counts, self.model_counts)[:1 + self._in_model]:
            c[kind] += nbytes
            c["count"] += 1

    @contextlib.contextmanager
    def in_model(self):
        """Collectives issued inside count in ``model_counts`` too."""
        self._in_model = True
        try:
            yield
        finally:
            self._in_model = False

    def _group(self, i):
        return self.mesh.get_group(i)

    def _all_gather(self, x, d: int, i: int):
        n = self.sizes[i]
        shape = list(x.shape)
        shape[d] *= n
        if self.record:
            self._log("all-gather", _nbytes(shape, x.dtype))
            return torch.empty(shape, dtype=x.dtype, device="meta")
        xt = x.movedim(d, 0).contiguous()
        out = torch.empty((n * xt.shape[0],) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _gather_into(out, xt, self._group(i))
        return out.movedim(0, d)

    def _reduce_scatter(self, x, d: int, i: int):
        n = self.sizes[i]
        shape = list(x.shape)
        shape[d] //= n
        if self.record:
            self._log("reduce-scatter", _nbytes(x.shape, x.dtype))
            return torch.empty(shape, dtype=x.dtype, device="meta")
        xt = x.movedim(d, 0).contiguous()
        out = torch.empty((xt.shape[0] // n,) + tuple(xt.shape[1:]),
                          dtype=x.dtype, device=x.device)
        _scatter_into(out, xt, self._group(i))
        return out.movedim(0, d)

    def all_reduce(self, x, dims=None):
        """The sum of ``x`` over mesh dims ``dims`` (all of them, as one
        collective over the world, when None).  In place when ``x`` is
        contiguous."""
        dims = range(len(self.sizes)) if dims is None else dims
        if math.prod(self.sizes[i] for i in dims) == 1:
            return x
        if self.record:
            self._log("all-reduce", _nbytes(x.shape, x.dtype))
            return torch.empty(x.shape, dtype=x.dtype, device="meta")
        import torch.distributed as dist
        x = x.contiguous()
        if len(dims) == len(self.sizes):
            dist.all_reduce(x)
        else:
            for i in dims:
                if self.sizes[i] > 1:
                    dist.all_reduce(x, group=self._group(i))
        return x

    def gather(self, local, placements):
        """The full tensor from this rank's shard: an all-gather on each
        sharding mesh dim, minor to major."""
        x = local
        for i in reversed(range(len(placements))):
            p = placements[i]
            if p.is_shard() and self.sizes[i] > 1:
                x = self._all_gather(x, p.dim, i)
        return x

    def reduce_sum(self, g, over, placements=None):
        """The sum of ``g`` over the ranks of mesh dims ``over`` (the
        batch's).  Without placements: the full sum (all-reduces).  With
        them: this rank's shard of the sum, by a reduce-scatter on each
        dim of ``over`` that shards it and an all-reduce on the others,
        then a local slice on the remaining sharding dims; a dim outside
        ``over`` holds identical copies, which are sliced, never summed."""
        scattered = set()
        for i in over:
            if self.sizes[i] == 1:
                continue
            p = None if placements is None else placements[i]
            if p is not None and p.is_shard():
                g = self._reduce_scatter(g, p.dim, i)
                scattered.add(i)
            else:
                g = self.all_reduce(g, (i,))
        if placements is not None:
            g = self.local(g, placements, skip=scattered)
        return g


class BatchGroup:
    """The ranks a global batch is split over: mesh dims ``over`` of
    ``comm``'s mesh, ``n`` ranks, this one the ``rank``-th in row order
    (mesh dims major to minor, as :meth:`Collectives.local` slices rows).
    A model that reads statistics of the whole batch (the loss's label
    count, the MoE's capacity positions and aux terms) takes them from
    here, so every rank computes the global batch's value."""

    def __init__(self, comm: Collectives, over):
        from torch.distributed.tensor import Replicate, Shard
        self.comm, self.over = comm, tuple(over)
        self.n, self.rank = 1, 0
        for i in self.over:
            self.n *= comm.sizes[i]
            self.rank = self.rank * comm.sizes[i] + comm.coord(i)
        self._rows = tuple(Shard(0) if i in self.over else Replicate()
                           for i in range(len(comm.sizes)))

    def sum(self, x):
        """The sum of ``x`` over the batch ranks, detached."""
        with self.comm.in_model():
            return self.comm.all_reduce(x.detach().clone(), self.over)

    def total(self, x):
        """The sum of ``x`` over the batch ranks, its gradient this rank's
        own term's: the value is the same on every rank, and the ranks'
        gradients add up to the gradient of the sum."""
        return self.sum(x) + (x - x.detach())

    def gather(self, x):
        """(n, *x.shape): every batch rank's ``x``, detached, in row
        order."""
        with self.comm.in_model():
            return self.comm.gather(x.detach()[None].contiguous(),
                                    self._rows)


def distribute(full, named):
    """``full`` placed by ``named`` (``NamedPlacements`` on a runtime
    mesh): this rank's shard, on the mesh's device, as a ``DTensor``."""
    comm = Collectives(named.mesh)
    local = comm.local(full, named.placements).to(comm.device()).contiguous()
    return wrap(local, named, tuple(full.shape))


def wrap(local, named, shape):
    """This rank's shard ``local`` of a tensor of global ``shape`` as a
    ``DTensor`` (no communication)."""
    from torch.distributed.tensor import DTensor
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local, named.mesh, named.placements,
                              run_check=False, shape=torch.Size(shape),
                              stride=stride)


def to_local(x):
    """A ``DTensor``'s local shard; any other tensor as it is."""
    from torch.distributed.tensor import DTensor
    return x.to_local() if isinstance(x, DTensor) else x
