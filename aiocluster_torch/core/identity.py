"""Node identity (the port's own copy of the reference's
``core/identity.py``: ``Address``, ``NodeId``, ``next_generation_id``
and ``observe_generation``).

A node is identified by a human name plus a ``generation_id`` that
defaults to the boot wall-clock, so a restarted node is a *new* cluster
member and stale replicas of its old incarnation age out instead of
shadowing fresh state. The twin's autotuner returns a runtime ``Config``
whose ``node_id`` is one of these.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field

Address = tuple[str, int]

# Highest generation handed out by this process, guarded for the
# multi-threaded spawn case.
_generation_lock = threading.Lock()
_last_generation = 0


def next_generation_id() -> int:
    """A fresh, strictly increasing generation.

    Wall-clock (``time.time_ns``), NOT ``time.monotonic_ns``: the
    monotonic clock restarts at an arbitrary (typically small) value on
    host reboot, so a rebooted node could come back with a *lower*
    generation than its previous incarnation and lose the
    newer-generation-wins rule. The guard below additionally pins the
    value strictly above every generation this process has issued, so
    in-process restarts (and a backwards-stepping wall clock) still bump
    the generation.
    """
    global _last_generation
    with _generation_lock:
        generation = time.time_ns()
        if generation <= _last_generation:
            generation = _last_generation + 1
        _last_generation = generation
        return generation


def observe_generation(generation: int) -> None:
    """Raise the strictly-increasing guard's floor to a generation issued
    OUTSIDE this process (a persisted one), so ``next_generation_id()``
    returns ``max(persisted + 1, time_ns)`` whatever the clock says."""
    global _last_generation
    with _generation_lock:
        if generation > _last_generation:
            _last_generation = generation


@dataclass(frozen=True, slots=True, eq=True)
class NodeId:
    """Unique identity of one cluster member."""

    name: str
    generation_id: int = field(default_factory=next_generation_id)
    gossip_advertise_addr: Address = ("localhost", 7001)
    tls_name: str | None = None

    def long_name(self) -> str:
        host, port = self.gossip_advertise_addr
        return f"{self.name}-{self.generation_id}-{host}:{port}"
