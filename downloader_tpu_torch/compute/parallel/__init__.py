"""Device mesh, partition rules, process groups, and host<->device
transfers with hop billing."""

from .mesh import MeshPlan, make_global, make_mesh, shard_batch, shard_params
from .partition import (
    UPSCALER_RULES, match_partition_rules, rule_audit, spec_for,
)
from .transfer import HopSink, TransferQueue, timed_hop

__all__ = [
    "HopSink", "MeshPlan", "TransferQueue", "UPSCALER_RULES", "make_global",
    "make_mesh", "match_partition_rules", "rule_audit", "shard_batch",
    "shard_params", "spec_for", "timed_hop",
]
