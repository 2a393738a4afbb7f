"""Meshes: descriptions of the production meshes, and the runtime mesh of
the ``torch.distributed`` world a process was started in.

``make_production_mesh`` and ``make_debug_mesh`` return a
:class:`MeshSpec`, axis names and sizes only: sharding rules, pspecs and
the dry-run's accounting need nothing more, so a 256- or 512-device mesh
is described without a world of that size.  Single pod: 16x16 = 256
devices ("data", "model"); multi-pod: 2x16x16 = 512 ("pod", "data",
"model"), the leading axis the cross-pod data-parallel one.

``init_world`` joins the world (``torch.distributed.run``'s environment,
or a world of one) and ``make_device_mesh`` lays a ``DeviceMesh`` over it.
Importing this module touches no device and no process group.
"""

from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class MeshSpec:
    """A mesh by its axis names and sizes (what sharding rules read):
    ``shape`` maps each name to its size, in order, as a JAX mesh's
    does."""

    axis_names: tuple
    sizes: tuple

    def __post_init__(self):
        if len(self.axis_names) != len(self.sizes):
            raise ValueError(f"axes {self.axis_names} vs sizes {self.sizes}")

    @property
    def shape(self) -> dict:
        return dict(zip(self.axis_names, self.sizes))


def make_production_mesh(*, multi_pod: bool = False) -> MeshSpec:
    if multi_pod:
        return MeshSpec(("pod", "data", "model"), (2, 16, 16))
    return MeshSpec(("data", "model"), (16, 16))


def make_debug_mesh(n_devices: int | None = None, *,
                    model: int = 2) -> MeshSpec:
    """A small ("data", "model") mesh over ``n_devices`` (default: the
    current world's size, 1 outside one)."""
    import torch.distributed as dist
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    if n % model:
        raise ValueError(f"{n} devices do not split into model={model}")
    return MeshSpec(("data", "model"), (n // model, model))


def init_world(device) -> tuple[int, int]:
    """Join the ``torch.distributed`` world this process was started in
    and return (rank, world size): the world ``torch.distributed.run``
    describes in the environment (``RANK``, ``WORLD_SIZE``,
    ``MASTER_ADDR``, ``MASTER_PORT``), else a world of one.  NCCL for a
    CUDA ``device`` (each rank on the card ``LOCAL_RANK`` names), gloo
    for the CPU.  A failed initialisation raises; nothing falls back to
    a run outside the world."""
    import torch
    import torch.distributed as dist
    dev = torch.device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    if dev.type == "cuda":
        torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
    if "WORLD_SIZE" in os.environ:
        dist.init_process_group(backend, init_method="env://")
    else:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    return dist.get_rank(), dist.get_world_size()


def make_device_mesh(shape, axes, *, device="cuda"):
    """A ``DeviceMesh`` of ``shape`` named ``axes`` over the current
    world (whose size must be ``prod(shape)``), on ``device``'s type."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(torch.device(device).type, tuple(shape),
                            mesh_dim_names=tuple(axes))
