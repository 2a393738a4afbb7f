from repro_torch.sharding.specs import (  # noqa: F401
    NamedPlacements, PartitionSpec, ShardingRules, constrain, mesh_axes,
    placements, pspec_for, spec_placements, to_named,
)
