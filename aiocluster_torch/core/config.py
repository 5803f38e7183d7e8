"""Runtime cluster configuration (the port's own copy of the reference's
``core/config.py``: ``FailureDetectorConfig``, ``PersistenceConfig``,
``Config`` and ``DEFAULT_MAX_PAYLOAD_SIZE``).

The port runs no asyncio runtime; it keeps this copy because the twin's
autotuner (twin/autotune.py) returns its recommendation as a runtime
``Config``. Field names, order and defaults are the reference's, so a
recommendation means the same thing to either package. ``fault_plan``
takes the port's ``FaultPlan`` and ``heterogeneity`` the port's
``models.Heterogeneity``.
"""

from __future__ import annotations

import ssl
from dataclasses import dataclass, field
from datetime import timedelta
from typing import TYPE_CHECKING

from ..faults.plan import FaultPlan
from .identity import Address, NodeId

if TYPE_CHECKING:
    from ..models.topology import Heterogeneity

# The default delta MTU: the cap on one encoded delta payload (the
# classic UDP-payload maximum; the transport is TCP, so 65,507 only
# bounds delta payloads). The one copy of the number in the port: the
# CLI's default budget is converted from it (sim/bytes.py).
DEFAULT_MAX_PAYLOAD_SIZE = 65_507


@dataclass(frozen=True, slots=True, eq=True)
class FailureDetectorConfig:
    """Phi-accrual tuning (the ``phi_threshhold`` spelling is kept for
    API compatibility)."""

    phi_threshhold: float = 8.0
    sampling_window_size: int = 1_000
    max_interval: timedelta = timedelta(seconds=10)
    initial_interval: timedelta = timedelta(seconds=5)
    dead_node_grace_period: timedelta = timedelta(hours=24)


@dataclass(frozen=True, slots=True, eq=True)
class PersistenceConfig:
    """Durable node state of the runtime: ``path`` is the node's private
    store directory; a snapshot every ``snapshot_interval_rounds``
    initiated rounds or once the intent log outgrows ``log_max_bytes``;
    ``restore_peers`` also persists the peer view (as hints);
    ``fsync_writes`` fsyncs the log on every owner write."""

    path: str
    snapshot_interval_rounds: int = 64
    log_max_bytes: int = 1 << 20
    restore_peers: bool = True
    fsync_writes: bool = False


@dataclass(frozen=True, slots=True, eq=True)
class Config:
    """Runtime configuration for one cluster node (the reference's fields,
    in its order, with its defaults)."""

    node_id: NodeId
    cluster_id: str = "default-cluster"
    gossip_interval: float = 1.0  # seconds between gossip rounds
    gossip_count: int = 3  # live peers contacted per round
    seed_nodes: list[Address] = field(default_factory=list)
    marked_for_deletion_grace_period: int = 3600 * 2  # seconds
    failure_detector: FailureDetectorConfig = field(
        default_factory=FailureDetectorConfig,
    )
    max_payload_size: int = DEFAULT_MAX_PAYLOAD_SIZE  # delta MTU, encoded bytes
    connect_timeout: float = 3.0
    read_timeout: float = 3.0
    write_timeout: float = 3.0
    max_concurrent_gossip: int = 32
    hook_queue_maxsize: int = 10_000
    drain_hooks_on_shutdown: bool = True
    hook_shutdown_timeout: float = 5.0
    tls_server_context: ssl.SSLContext | None = None
    tls_client_context: ssl.SSLContext | None = None
    tls_server_hostname: str | None = None
    # Fraction of gossip_interval used as random startup jitter.
    gossip_jitter: float = 0.0
    # Persistent peer channels (a per-peer pool; False: connect and
    # tear down per round).
    persistent_connections: bool = True
    pool_max_idle_per_peer: int = 2
    pool_idle_timeout: float = 60.0
    # Adaptive per-peer timeouts: mean + k * stddev of the measured RTT,
    # clamped to [adaptive_timeout_min, read_timeout].
    adaptive_timeouts: bool = True
    adaptive_timeout_k: float = 4.0
    adaptive_timeout_min: float = 0.25
    # Per-peer circuit breaker: quarantine after this many consecutive
    # handshake failures, redial on a jittered exponential backoff
    # measured in gossip intervals.
    circuit_breaker: bool = True
    breaker_failure_threshold: int = 3
    breaker_base_backoff_intervals: float = 2.0
    breaker_max_backoff_intervals: float = 64.0
    # Deterministic fault injection (faults/plan.py).
    fault_plan: FaultPlan | None = None
    # Heterogeneity classes (models/topology.py).
    heterogeneity: "Heterogeneity | None" = None
    # The zero-copy wire data plane (byte-identical frames either way).
    wire_fastpath: bool = True
    # Durable node state; None keeps the amnesiac restart.
    persistence: PersistenceConfig | None = None
    # Wire-level span context on every handshake packet.
    trace_context: bool = False
    # Seconds between gossip-borne health digests (None: none).
    telemetry_interval: float | None = None
