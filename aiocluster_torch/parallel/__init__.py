"""Owner-axis sharding of the simulator's state (the port of the
reference's ``parallel/``): a mesh of devices along the "owners" axis,
the state held as column blocks of the owners, one per device entry."""

from .mesh import (
    AXIS,
    PARTITION_RULES,
    Mesh,
    gather_state,
    init_blocks,
    make_mesh,
    match_partition_rules,
    shard_state,
    sharded_chunk_fn,
    sharded_metrics_fn,
    sharded_tracked_chunk_fn,
    state_partition_spec,
)

__all__ = (
    "AXIS",
    "PARTITION_RULES",
    "Mesh",
    "gather_state",
    "init_blocks",
    "make_mesh",
    "match_partition_rules",
    "shard_state",
    "sharded_chunk_fn",
    "sharded_metrics_fn",
    "sharded_tracked_chunk_fn",
    "state_partition_spec",
)
