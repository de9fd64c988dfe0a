"""Sharding rules of the port: logical axis names to `DeviceMesh`
placements (`rules.py`), with the reference's spec rules entry for
entry."""
from repro_torch.sharding.rules import (  # noqa: F401
    ShardingRules,
    batch_axes,
    logical_to_physical,
    zero1_shard,
    make_rules,
)
