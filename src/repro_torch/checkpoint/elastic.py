"""Elastic re-sharding: restore a checkpoint onto a different mesh, as the
JAX package's ``checkpoint/elastic.py``.

Checkpoints store logically unsharded leaves (``ckpt.py``), so scaling
the data-parallel degree up or down is a restore with new placements:
the same checkpoint serves any mesh, and what changes is the placements
tree handed to ``restore_checkpoint``.  ``elastic_restore`` restores
onto the mesh a launcher actually got; with the data pipeline re-split
by the new data-parallel rank, that is the elastic story for the DP /
FSDP axes.  Changing the *model* axis degree would change the padding of
vocab-sharded tables, and is refused.
"""

from __future__ import annotations

from repro_torch.sharding.specs import ShardingRules, mesh_axes, to_named
from repro_torch.train.state import train_state_pspecs


def state_shardings_for_mesh(cfg, mesh):
    """The train state's ``NamedPlacements`` tree on ``mesh`` (a runtime
    ``DeviceMesh``), from the default rules."""
    rules = ShardingRules.for_mesh(mesh)
    return to_named(rules, train_state_pspecs(cfg, rules))


def elastic_restore(directory: str, cfg, mesh, abstract_state):
    """Restore the latest checkpoint re-sharded onto ``mesh``: each rank
    keeps its shards, as ``DTensor``.  Returns (state, manifest)."""
    from repro_torch.checkpoint.ckpt import restore_checkpoint
    sh = state_shardings_for_mesh(cfg, mesh)
    return restore_checkpoint(directory, abstract_state, shardings=sh)


def reshard_checkpoint(directory: str, cfg, old_mesh, new_mesh,
                       abstract_state):
    """Validate old -> new mesh compatibility and load re-sharded.  The
    old mesh may be a description (``launch.mesh.MeshSpec``)."""
    if mesh_axes(old_mesh).get("model", 1) != \
            mesh_axes(new_mesh).get("model", 1):
        raise ValueError(
            "elastic scaling changes only data-parallel axes; the model "
            "axis degree is fixed by table padding")
    return elastic_restore(directory, cfg, new_mesh, abstract_state)
