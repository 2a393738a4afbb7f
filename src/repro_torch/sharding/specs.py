"""Logical-axis -> mesh-axis sharding rules, as the JAX package's
``sharding/specs.py``.

Every tensor in the system is annotated with *logical* dims ("d", "ff",
"qdim", "batch", ...).  ``ShardingRules`` maps logical dims to mesh axes and
enforces divisibility: a logical dim is only sharded when its size divides the
product of the mapped mesh axes (an uneven shard is refused, as under jit).
This is what lets one rule table drive ten architectures with awkward head
counts.  The tables, the divisibility rule and the one-mesh-axis-per-tensor
rule are the JAX package's, and so is every ``PartitionSpec`` they give.

Default production mapping (single pod, mesh ("data", "model")):
    batch  -> ("data",)           data parallel
    d      -> ("data",)           FSDP: parameters' d_model dim sharded over dp
    qdim/kvdim/ff/ffe/vocab/d_inner/rflat -> ("model",)
    experts -> ("model",)
    seq    -> ()                  (set to ("data",) for batch-1 long decode)

Multi-pod adds "pod" in front of batch (pure DP across pods) and optionally
into the FSDP axes (ZeRO across pods) — see ``for_mesh``.

A mesh is anything that names its axes and their sizes: a runtime
``torch.distributed.device_mesh.DeviceMesh`` (``mesh_dim_names`` and a
``shape`` tuple) or an allocation-free description such as
``launch.mesh.MeshSpec`` (``axis_names`` and a ``shape`` mapping), so the
rules of a 512-device mesh need no world of 512.

The port places *storage* by the rules: :func:`placements` turns a
tensor's pspec into ``DTensor`` placements, one per mesh dim.  Compute is
data parallel with gather at use (``sharding.collectives``), so
:func:`constrain` is the identity on the full tensors a rank computes
with.
"""

from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from repro_torch.models.transformer import tree_map


class PartitionSpec(tuple):
    """One entry per tensor dim: ``None`` (replicated), a mesh axis name,
    or a tuple of names (major to minor); trailing ``None`` dropped.
    Equal, entry for entry, to the JAX package's ``PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axes(mesh) -> dict:
    """``{axis name: size}`` of a ``DeviceMesh`` or a mesh description, in
    the mesh's order."""
    names = getattr(mesh, "axis_names", None) or mesh.mesh_dim_names
    shape = mesh.shape
    if isinstance(shape, dict):
        return {a: int(shape[a]) for a in names}
    return dict(zip(names, (int(n) for n in shape)))


def _axes_size(mesh, axes: tuple) -> int:
    sizes = mesh_axes(mesh)
    n = 1
    for a in axes:
        n *= sizes[a]
    return n


@dataclass(frozen=True)
class ShardingRules:
    mesh: object
    # logical dim -> tuple of mesh axes (in major-to-minor order)
    table: dict = field(default_factory=dict)
    # >1 => group-local MoE dispatch with this many groups (aligned with
    # the data axes; see models/moe._moe_mlp_grouped)
    moe_groups: int = 0
    # the batch ranks (``collectives.BatchGroup``) a rank's model takes
    # batch-wide statistics over, set by the sharded step; None: the
    # model sees the whole batch
    batch: object = field(default=None, compare=False)

    @staticmethod
    def for_mesh(mesh, *, seq_sharded: bool = False,
                 zero_over_pod: bool = True,
                 fsdp: bool = True) -> "ShardingRules":
        axes = set(mesh_axes(mesh))
        has_pod = "pod" in axes
        batch = (("pod", "data") if has_pod else ("data",))
        dp = ("data",)
        if has_pod and zero_over_pod:
            dp = ("pod", "data")
        tp = ("model",)
        table = {
            "batch": batch,
            "seq": dp if seq_sharded else (),
            "d": dp if fsdp else (),          # FSDP on parameter d_model dim
            "vocab": tp,
            "qdim": tp,
            "kvdim": tp,
            "ff": tp,
            "ffe": (),                        # per-expert ff dim (E already EP)
            "experts": tp,
            "d_inner": tp,                    # mamba channels
            "rflat": tp,                      # rwkv flattened head dim (H*hd)
            "heads": (),                      # raw head counts rarely divisible
            "kvheads": tp,                    # kv cache heads (when divisible)
            "rheads": tp,                     # rwkv state heads
            "hd": tp,                         # fallback: head_dim (used-axis
                                              # tracking keeps one of the two)
            "cache_seq": dp if seq_sharded else (),
            "layers": (),
            "cap": (),
            "dt": (),
            "state": (),
            "conv": (),
            "lora": (),
            "frames": (),
            "prefix": (),
            "seq_act": (),
            "seq_tok": (),
            "d_act": (),
            "vec": (),
            "groups": dp,                     # MoE dispatch groups
        }
        return ShardingRules(mesh=mesh, table=table)

    def with_overrides(self, **kv) -> "ShardingRules":
        t = dict(self.table)
        extra = {}
        if "moe_groups" in kv:
            extra["moe_groups"] = kv.pop("moe_groups")
        t.update(kv)
        return replace(self, table=t, **extra)

    # ------------------------------------------------------------------
    def axes_for(self, dim_name: str, size: int):
        """Mesh axes for one logical dim, honoring divisibility."""
        axes = self.table.get(dim_name, ())
        if not axes:
            return None
        if size % _axes_size(self.mesh, tuple(axes)) != 0:
            return None                     # would be uneven -> replicate
        return tuple(axes) if len(axes) > 1 else axes[0]

    def pspec(self, dims: tuple, shape: tuple) -> PartitionSpec:
        if len(dims) != len(shape):
            raise ValueError(f"dims {dims} do not match shape {shape}")
        used = set()
        out = []
        for dim_name, size in zip(dims, shape):
            ax = self.axes_for(dim_name, size)
            # one mesh axis may shard only one dim of a tensor
            flat = ax if isinstance(ax, tuple) else (ax,) if ax else ()
            if ax is None or any(a in used for a in flat):
                out.append(None)
            else:
                used.update(flat)
                out.append(ax)
        while out and out[-1] is None:
            out.pop()
        return PartitionSpec(*out)


def pspec_for(rules: Optional[ShardingRules], dims: tuple,
              shape: tuple) -> PartitionSpec:
    if rules is None:
        return PartitionSpec()
    return rules.pspec(dims, shape)


def spec_placements(mesh, spec: PartitionSpec) -> tuple:
    """``DTensor`` placements of ``spec`` on ``mesh``, one per mesh dim: a
    tensor dim mapped to ``("pod", "data")`` is ``Shard(d)`` on both mesh
    dims (major to minor, which must be the mesh's order); every mesh dim
    no entry names is ``Replicate()``."""
    from torch.distributed.tensor import Replicate, Shard
    names = list(mesh_axes(mesh))
    out = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        if entry is None:
            continue
        axes = entry if isinstance(entry, tuple) else (entry,)
        idx = [names.index(a) for a in axes]
        if idx != sorted(idx):
            raise ValueError(f"{spec}: axes {axes} are not in the mesh's "
                             f"order {tuple(names)}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


def placements(rules: ShardingRules, dims: tuple, shape: tuple) -> tuple:
    """``DTensor`` placements on ``rules.mesh`` for a tensor of logical
    ``dims`` and ``shape`` (its pspec, see :func:`spec_placements`)."""
    return spec_placements(rules.mesh, rules.pspec(dims, shape))


@dataclass(frozen=True)
class NamedPlacements:
    """A tensor's layout: the mesh and its ``DTensor`` placements, one per
    mesh dim (the port's counterpart of JAX's ``NamedSharding``)."""

    mesh: object
    placements: tuple


def to_named(rules: ShardingRules, ps_tree):
    """A tree of ``PartitionSpec`` as a tree of :class:`NamedPlacements`
    on ``rules.mesh``."""
    return tree_map(lambda ps: NamedPlacements(
        rules.mesh, spec_placements(rules.mesh, ps)), ps_tree,
        is_leaf=lambda x: isinstance(x, PartitionSpec))


def constrain(x, rules: Optional[ShardingRules], dims: tuple):
    """The JAX package's ``with_sharding_constraint`` against the logical
    dims.  The identity here: every rank computes with full tensors (data
    parallel, parameters gathered at use), so there is nothing to
    constrain; kept for API parity."""
    return x
