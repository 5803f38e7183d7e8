"""Static configuration for the PyTorch gossip simulator.

A field-for-field copy of the reference ``SimConfig`` (field names,
defaults and ``__post_init__`` validation), so a config written for the
JAX package means the same thing here. ``fault_plan`` and
``heterogeneity`` take the port's own copies of the reference's types
(``aiocluster_torch.faults.FaultPlan``,
``aiocluster_torch.models.Heterogeneity``), checked as the reference
checks them.

In the port, ``use_pallas="auto"`` and ``use_pallas_fd="auto"`` mean
"the state lives on a CUDA device": the hand-written CUDA kernels
(ops/csrc/) serve the round there, and the plain PyTorch versions serve
it on the CPU.
"""

from __future__ import annotations

from dataclasses import dataclass

from ..faults.plan import FaultPlan
from ..models.topology import Heterogeneity

# budget_from_mtu(65_507) of the reference (sim/bytes.py): key-versions
# that fit one maximal UDP payload at the headline workload's key/value
# widths. The port has no wire encoder yet, so it keeps the number; a
# test pins it to the reference's computation.
HEADLINE_BUDGET = 2618


@dataclass(frozen=True, slots=True, eq=True)
class SimConfig:
    """Static shape/tuning parameters for one simulated cluster."""

    n_nodes: int
    keys_per_node: int = 16
    fanout: int = 3  # gossip_count
    budget: int = 64  # key-versions per exchange (the "MTU")
    writes_per_round: int = 0  # ongoing owner writes per node per tick

    # Failure detection (tick-time phi-accrual).
    track_failure_detector: bool = True
    phi_threshold: float = 8.0
    prior_mean_ticks: float = 5.0  # initial_interval in rounds
    prior_weight: float = 5.0
    max_interval_ticks: int = 10
    window_ticks: int = 1000  # caps the sample count like the ring buffer

    # Churn: per-tick probability that an alive node dies / a dead node
    # rejoins.
    death_rate: float = 0.0
    revival_rate: float = 0.0

    # Two-stage dead-node lifecycle in ticks (None disables it).
    dead_grace_ticks: int | None = None

    # Peer selection for pairing="choice": "alive" or "view".
    peer_mode: str = "alive"

    # Pairing of one sub-exchange: "matching" (a random involution drawn
    # from the 8-row-group family when n % 128 == 0), "permutation" or
    # "choice".
    pairing: str = "matching"

    # Storage dtypes of the (N, N) knowledge matrices (the memory-ladder
    # rungs): watermarks, heartbeat knowledge, FD interval means.
    version_dtype: str = "int32"
    heartbeat_dtype: str = "int32"
    fd_dtype: str = "float32"

    # Failure-detector bookkeeping rungs.
    icount_dtype: str = "int16"
    live_bits: bool = False

    # How an exchange's key-version budget is split across stale owners.
    budget_policy: str = "proportional"

    # Heartbeat knowledge matrix; required by the failure detector.
    track_heartbeats: bool = True

    # Deterministic fault injection (faults/plan.py, lowered by
    # faults/sim.py), the breaker quarantine of the choice draw, and
    # heterogeneity classes (models/topology.py).
    fault_plan: FaultPlan | None = None
    quarantine: bool = False
    quarantine_open_after: int = 3
    heterogeneity: Heterogeneity | None = None

    # Kernel switches, named as in the reference so configs carry
    # across. "auto": the CUDA kernels serve the round when the state is
    # on a CUDA device; True asks for them (on CPU tensors the wrappers
    # take their plain versions); False pins the plain PyTorch path.
    use_pallas: bool | str = "auto"
    pallas_variant: str = "auto"
    use_pallas_fd: bool | str = "auto"

    def __post_init__(self) -> None:
        if self.n_nodes < 2:
            raise ValueError("need at least 2 nodes")
        if self.peer_mode not in ("alive", "view"):
            raise ValueError(f"unknown peer_mode: {self.peer_mode}")
        if self.peer_mode == "view" and not self.track_failure_detector:
            raise ValueError("peer_mode='view' requires track_failure_detector")
        if self.pairing not in ("permutation", "matching", "choice"):
            raise ValueError(f"unknown pairing: {self.pairing}")
        if self.version_dtype not in ("int32", "int16", "int8", "u4r"):
            raise ValueError(f"unknown version_dtype: {self.version_dtype}")
        if self.heartbeat_dtype not in ("int32", "int16", "int8"):
            raise ValueError(f"unknown heartbeat_dtype: {self.heartbeat_dtype}")
        if self.fd_dtype not in ("float32", "bfloat16"):
            raise ValueError(f"unknown fd_dtype: {self.fd_dtype}")
        if self.icount_dtype not in ("int16", "int8"):
            raise ValueError(f"unknown icount_dtype: {self.icount_dtype}")
        # The update increments the sample counter BEFORE clamping to
        # the cap, so window_ticks + 1 must also fit the counter dtype.
        if self.window_ticks >= 2**15 - 1:
            raise ValueError("window_ticks must fit the int16 sample counter")
        if self.icount_dtype == "int8" and self.window_ticks >= 2**7 - 1:
            raise ValueError(
                "window_ticks must fit the int8 sample counter "
                "(icount_dtype='int8' needs window_ticks <= 126)"
            )
        if self.version_dtype == "u4r":
            if self.pairing == "choice":
                raise ValueError(
                    "version_dtype='u4r' requires pairing='matching' or "
                    "'permutation' (the choice scatter path is unpacked-only)"
                )
            if self.budget_policy != "proportional":
                raise ValueError(
                    "version_dtype='u4r' requires budget_policy="
                    "'proportional' (greedy's owner-order cumsum has no "
                    "byte-space form)"
                )
            if self.dead_grace_ticks is not None:
                raise ValueError(
                    "version_dtype='u4r' does not support the dead-node "
                    "lifecycle (forgetting rewrites w outside the "
                    "residual range)"
                )
            if self.n_nodes % 2 != 0:
                raise ValueError(
                    "version_dtype='u4r' packs two owners per byte; "
                    "n_nodes must be even"
                )
        if self.live_bits:
            if not self.track_failure_detector:
                raise ValueError("live_bits requires track_failure_detector")
            if self.peer_mode == "view":
                raise ValueError(
                    "live_bits with peer_mode='view' is unsupported (the "
                    "view draw samples from bool live rows)"
                )
            if self.n_nodes % 8 != 0:
                raise ValueError(
                    "live_bits packs eight owners per byte; n_nodes must "
                    "be a multiple of 8"
                )
        if self.peer_mode == "view" and self.pairing != "choice":
            raise ValueError(
                "peer_mode='view' requires pairing='choice' (a matching "
                "cannot honour per-node live views)"
            )
        if self.budget_policy not in ("proportional", "greedy"):
            raise ValueError(f"unknown budget_policy: {self.budget_policy}")
        if self.fault_plan is not None:
            if not isinstance(self.fault_plan, FaultPlan):
                raise ValueError("fault_plan must be a faults.FaultPlan")
            self.fault_plan.check_sim_compatible()
            if self.fault_plan.byzantine and self.version_dtype == "u4r":
                raise ValueError(
                    "byzantine fault kinds are unpacked-only (the guard "
                    "masks are owner-column selects with no byte-space "
                    "form); version_dtype='u4r' cannot run them"
                )
            amnesia = any(
                cr.recovery == "amnesia" for cr in self.fault_plan.crashes
            )
            if amnesia and self.version_dtype == "u4r":
                raise ValueError(
                    "recovery='amnesia' crash windows are unpacked-only "
                    "(the knowledge-row reset writes w=0, which in "
                    "residual space is a per-owner value, not a "
                    "constant); version_dtype='u4r' cannot run them — "
                    "use recovery='warm' or a wider rung"
                )
            if amnesia and self.live_bits:
                raise ValueError(
                    "recovery='amnesia' crash windows do not support "
                    "live_bits (the live-view row reset has no packed "
                    "form); use recovery='warm' or live_bits=False"
                )
        if self.quarantine:
            if self.pairing != "choice":
                raise ValueError(
                    "quarantine requires pairing='choice' (the matching/"
                    "permutation pairings draw over all nodes; only the "
                    "choice draw can honour a per-peer quarantine mask)"
                )
            if self.peer_mode != "alive":
                raise ValueError(
                    "quarantine requires peer_mode='alive' (the view-mode "
                    "Gumbel-max draw carries its own belief mask)"
                )
            if self.quarantine_open_after < 0:
                raise ValueError("quarantine_open_after must be >= 0")
            if self.heterogeneity is not None and any(
                k != 1 for k in self.heterogeneity.gossip_every
            ):
                raise ValueError(
                    "quarantine cannot combine with heterogeneity cadence "
                    "classes: a class-k initiator accumulates its "
                    "failures-to-open k times slower, but the mask opens "
                    "at a fixed start+open_after for every initiator — "
                    "the sim would quarantine more than the runtime does"
                )
        if self.heterogeneity is not None:
            if not isinstance(self.heterogeneity, Heterogeneity):
                raise ValueError(
                    "heterogeneity must be a models.topology.Heterogeneity"
                )
            if self.heterogeneity.zone_bias > 0 and self.pairing != "choice":
                raise ValueError(
                    "zone_bias requires pairing='choice' (a global "
                    "matching cannot honour per-node zone preference)"
                )
            if self.heterogeneity.zone_bias > 0 and self.peer_mode != "alive":
                raise ValueError(
                    "zone_bias requires peer_mode='alive' (the view-mode "
                    "Gumbel-max draw carries no zone bias; refusing "
                    "beats silently sampling unbiased)"
                )
        if self.track_failure_detector and not self.track_heartbeats:
            raise ValueError("failure detector requires track_heartbeats")
        if self.dead_grace_ticks is not None:
            if not self.track_failure_detector:
                raise ValueError(
                    "dead_grace_ticks requires track_failure_detector"
                )
            if self.dead_grace_ticks < 2:
                raise ValueError("dead_grace_ticks must be >= 2")
        # Identity checks, not `in (True, False, "auto")`: equality would
        # admit 1/0/np.bool_.
        if not (
            self.use_pallas is True
            or self.use_pallas is False
            or self.use_pallas == "auto"
        ):
            raise ValueError(f"unknown use_pallas: {self.use_pallas!r}")
        if self.pallas_variant not in ("auto", "m8", "pairs"):
            raise ValueError(f"unknown pallas_variant: {self.pallas_variant!r}")
        if not (
            self.use_pallas_fd is True
            or self.use_pallas_fd is False
            or self.use_pallas_fd == "auto"
        ):
            raise ValueError(f"unknown use_pallas_fd: {self.use_pallas_fd!r}")


# The memory ladder's named rungs (the reference's sim.memory tables): a
# rung name selects the dtype and packing set of a profile. Horizons:
# int16 versions/ticks < 32768, int8 < 128, u4r at most 15 versions per
# owner (keys_per_node drops to 15), int8 sample counters need
# window_ticks <= 126.
LEAN_RUNGS: dict[str, dict] = {
    "int32": dict(version_dtype="int32"),
    "int16": dict(version_dtype="int16"),
    "int8": dict(version_dtype="int8"),
    "u4r": dict(version_dtype="u4r", keys_per_node=15),
}

FULL_RUNGS: dict[str, dict] = {
    "int32": dict(version_dtype="int32", heartbeat_dtype="int32", fd_dtype="float32"),
    "int16": dict(),  # full_config's defaults
    # int8 sample counters and the live bitmap on int16 matrices.
    "shrunk": dict(icount_dtype="int8", live_bits=True, window_ticks=100),
    # int8 watermarks and ticks on top of the shrunk bookkeeping.
    "deep": dict(
        version_dtype="int8",
        heartbeat_dtype="int8",
        icount_dtype="int8",
        live_bits=True,
        window_ticks=100,
    ),
}


def lean_config(n_nodes: int, rung: str = "int16", **overrides) -> SimConfig:
    """The reference's memory-lean convergence profile (its
    ``sim.memory.lean_config``), used for max-scale runs: no heartbeat
    matrix, no failure detector, watermarks at the named ladder rung
    (``LEAN_RUNGS``). Explicit ``overrides`` win over the rung's. The
    north star is ``lean_config(100_352, budget=2618)``."""
    defaults = dict(
        n_nodes=n_nodes,
        keys_per_node=16,
        fanout=3,
        budget=2048,
        track_failure_detector=False,
        track_heartbeats=False,
    )
    defaults.update(LEAN_RUNGS[rung])
    defaults.update(overrides)
    return SimConfig(**defaults)


def full_config(n_nodes: int, rung: str = "int16", **overrides) -> SimConfig:
    """The reference's full profile (its ``sim.memory.full_config``):
    heartbeats and the phi-accrual failure detector at the named ladder
    rung (``FULL_RUNGS``). "int16" is int16 watermarks and ticks with
    bfloat16 interval means; "shrunk" and "deep" narrow the FD
    bookkeeping (int8 sample counters, the live bitmap) and, for
    "deep", the matrices to int8. Explicit ``overrides`` win."""
    defaults = dict(
        n_nodes=n_nodes,
        keys_per_node=16,
        fanout=3,
        budget=2048,
        version_dtype="int16",
        heartbeat_dtype="int16",
        fd_dtype="bfloat16",
        track_failure_detector=True,
        track_heartbeats=True,
    )
    defaults.update(FULL_RUNGS[rung])
    defaults.update(overrides)
    return SimConfig(**defaults)


def headline_config(n_nodes: int = 10_240) -> SimConfig:
    """The reference bench's headline configuration (bench.py's
    ``SimConfig(n_nodes, keys_per_node=16, fanout=3,
    budget=budget_from_mtu(65_507), int16/int16/bfloat16)``)."""
    return SimConfig(
        n_nodes=n_nodes,
        keys_per_node=16,
        fanout=3,
        budget=HEADLINE_BUDGET,
        version_dtype="int16",
        heartbeat_dtype="int16",
        fd_dtype="bfloat16",
    )
