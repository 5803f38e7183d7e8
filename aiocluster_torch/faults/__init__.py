"""Deterministic fault injection for the simulator (the port of the
reference's ``faults`` package, without its asyncio-runtime parts).

- :mod:`.plan` — the scenario model: seeded, serializable
  :class:`FaultPlan` dataclasses (standard library only).
- :mod:`.scenarios` — the named library (``split_brain``,
  ``flaky_links``, ``rolling_restart``, ``slow_third``,
  ``byzantine_fraction``, ``byzantine_storm``).
- :mod:`.sim` — the per-round link, crash, quarantine and byzantine
  masks in PyTorch (compiled in by ``SimConfig.fault_plan``).
"""

from .plan import (
    ALL_NODES,
    BYZANTINE_KINDS,
    RECOVERY_KINDS,
    ByzantineFault,
    FaultPlan,
    LinkFault,
    NodeCrash,
    NodeSet,
    Partition,
    with_extra_links,
)
from .scenarios import (
    SCENARIOS,
    byzantine_fraction,
    byzantine_storm,
    flaky_links,
    rolling_restart,
    round_robin_groups,
    slow_third,
    split_brain,
)

__all__ = (
    "ALL_NODES",
    "BYZANTINE_KINDS",
    "RECOVERY_KINDS",
    "ByzantineFault",
    "FaultPlan",
    "LinkFault",
    "NodeCrash",
    "NodeSet",
    "Partition",
    "SCENARIOS",
    "byzantine_fraction",
    "byzantine_storm",
    "flaky_links",
    "rolling_restart",
    "round_robin_groups",
    "slow_third",
    "split_brain",
    "with_extra_links",
)
