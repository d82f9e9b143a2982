"""repro_torch.parallel — logical sharding rules as DTensor placements,
parameter and cache partition specs (the JAX package's ``repro.parallel``)."""

from .sharding import (
    P,
    current_mesh,
    default_rules,
    logical_to_spec,
    place_sharded_pack,
    shard_activation,
    sharded_pack_pspecs,
    to_placements,
    use_sharding,
)

__all__ = [
    "P",
    "current_mesh",
    "default_rules",
    "logical_to_spec",
    "place_sharded_pack",
    "shard_activation",
    "sharded_pack_pspecs",
    "to_placements",
    "use_sharding",
]
