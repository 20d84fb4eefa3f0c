"""Distributed runtime: sharding rules, collectives, gradient compression and
fault hooks (the counterparts of ``repro.runtime``).

``sharding`` and ``collectives`` work over a mesh of one process per card
(``launch.mesh``); importing them touches no process group."""

from .collectives import (
    all_to_all_combine,
    all_to_all_experts,
    flash_decode_psum,
    hierarchical_pmean,
    shard_map_moe_dispatch,
)
from .sharding import (
    LOGICAL_AXES,
    NamedSharding,
    PartitionSpec,
    ShardingRules,
    current_mesh,
    current_rules,
    explicit_spec,
    logical_to_spec,
    named_sharding,
    serve_rules,
    shard,
    sharding_report,
    train_rules,
    use_rules,
)

__all__ = [
    "LOGICAL_AXES",
    "NamedSharding",
    "PartitionSpec",
    "ShardingRules",
    "all_to_all_combine",
    "all_to_all_experts",
    "current_mesh",
    "current_rules",
    "explicit_spec",
    "flash_decode_psum",
    "hierarchical_pmean",
    "logical_to_spec",
    "named_sharding",
    "serve_rules",
    "shard",
    "shard_map_moe_dispatch",
    "sharding_report",
    "train_rules",
    "use_rules",
]
