"""Owner-axis sharding of the simulator's state (the port of the
reference's ``parallel/``): a mesh of devices along the "owners" axis,
the state held as column blocks of the owners, one per device entry
(``mesh``), and a mesh across processes over ``torch.distributed``
(``multihost``)."""

from .mesh import (
    AXIS,
    PARTITION_RULES,
    Mesh,
    collectives,
    gather_state,
    init_blocks,
    init_sweep_blocks,
    make_mesh,
    match_partition_rules,
    shard_state,
    shard_sweep_state,
    sharded_chunk_fn,
    sharded_metrics_fn,
    sharded_sweep_chunk_fn,
    sharded_sweep_metrics_fn,
    sharded_tracked_chunk_fn,
    state_partition_spec,
    sweep_state_partition_spec,
)

__all__ = (
    "AXIS",
    "PARTITION_RULES",
    "Mesh",
    "collectives",
    "gather_state",
    "init_blocks",
    "init_sweep_blocks",
    "make_mesh",
    "match_partition_rules",
    "shard_state",
    "shard_sweep_state",
    "sharded_chunk_fn",
    "sharded_metrics_fn",
    "sharded_sweep_chunk_fn",
    "sharded_sweep_metrics_fn",
    "sharded_tracked_chunk_fn",
    "state_partition_spec",
    "sweep_state_partition_spec",
)
