"""Named fault scenarios (the port's copy of the reference's
``faults/scenarios.py``): the library the fault benchmarks draw from.

Each scenario function returns a plain :class:`FaultPlan` — seeded,
serializable and fraction-addressed, so ``SimConfig.fault_plan`` accepts
it at 10k-100k nodes unchanged. Times are gossip rounds in the sim
(seconds in the reference's runtime, whose 1 s interval makes them
coincide).

``SCENARIOS`` maps names to builders for CLI/tooling lookup.
"""

from __future__ import annotations

from .plan import (
    ALL_NODES,
    ByzantineFault,
    FaultPlan,
    LinkFault,
    NodeCrash,
    NodeSet,
    Partition,
)


def split_brain(
    n_groups: int = 3,
    start: float = 0.0,
    heal: float | None = 30.0,
    *,
    seed: int = 0,
    groups: tuple[tuple[str, ...], ...] = (),
) -> FaultPlan:
    """A clean ``n_groups``-way partition from ``start`` until ``heal``
    (None = never heals). The canonical convergence-under-fault probe:
    cross-island state must stall while partitioned and fully reconverge
    after heal (benchmarks/fault_bench.py measures the reconvergence).
    ``groups`` pins explicit name groups for runtime fleets."""
    return FaultPlan(
        seed=seed,
        partitions=(
            Partition(n_groups=n_groups, start=start, end=heal, groups=groups),
        ),
    )


def flaky_links(
    drop: float = 0.2,
    *,
    delay: float = 0.0,
    delay_prob: float = 0.0,
    duplicate: float = 0.0,
    start: float = 0.0,
    end: float | None = None,
    seed: int = 0,
) -> FaultPlan:
    """Every link drops each operation with probability ``drop`` (plus
    optional delay/duplication). Anti-entropy must still converge —
    just slower; the chaos soak pins this."""
    return FaultPlan(
        seed=seed,
        links=(
            LinkFault(
                drop=drop,
                delay=delay,
                delay_prob=delay_prob,
                duplicate=duplicate,
                start=start,
                end=end,
            ),
        ),
    )


def rolling_restart(
    n_waves: int = 4,
    *,
    start: float = 2.0,
    wave_every: float = 2.0,
    down_for: float = 1.0,
    seed: int = 0,
    recovery: str = "amnesia",
) -> FaultPlan:
    """Restart the cluster one index-fraction wave at a time: wave ``k``
    (nodes in [k/n_waves, (k+1)/n_waves)) goes down at
    ``start + k * wave_every`` for ``down_for``. ``recovery`` picks the
    rejoin semantics (NodeCrash docstring): ``"amnesia"`` reboots empty
    with a bumped generation (the reference's restart — the sim resets
    the wave's knowledge rows at restart), ``"warm"`` reboots from the
    durable store (``Config.persistence``) and catches up by delta —
    ``benchmarks/restart_bench.py`` runs this plan both ways and gates
    the ratio."""
    crashes = tuple(
        NodeCrash(
            nodes=NodeSet(frac=(k / n_waves, (k + 1) / n_waves)),
            at=start + k * wave_every,
            down_for=down_for,
            recovery=recovery,
        )
        for k in range(n_waves)
    )
    return FaultPlan(seed=seed, crashes=crashes)


def slow_third(
    delay: float = 0.5,
    *,
    delay_prob: float = 1.0,
    frac: tuple[float, float] = (0.0, 1.0 / 3.0),
    start: float = 0.0,
    end: float | None = None,
    seed: int = 0,
) -> FaultPlan:
    """A third of the cluster serves and receives slowly: every
    operation touching a slow node in either direction stalls ``delay``
    seconds with probability ``delay_prob`` (asymmetric variants: build
    the one-direction LinkFault yourself). In the sim, a delay >= 1 tick
    turns the slow nodes' exchanges into per-round misses."""
    slow = NodeSet(frac=frac)
    return FaultPlan(
        seed=seed,
        links=(
            LinkFault(
                src=slow, dst=ALL_NODES,
                delay=delay, delay_prob=delay_prob, start=start, end=end,
            ),
            LinkFault(
                src=ALL_NODES, dst=slow,
                delay=delay, delay_prob=delay_prob, start=start, end=end,
            ),
        ),
    )


def byzantine_fraction(
    kind: str = "stale_replay",
    frac: float = 0.25,
    *,
    victims: NodeSet = ALL_NODES,
    rate: float = 1.0,
    amount: int = 1 << 20,
    start: float = 0.0,
    end: float | None = None,
    seed: int = 0,
) -> FaultPlan:
    """The first index-fraction ``frac`` of the cluster turns byzantine
    with one wrong-data ``kind`` (docs/faults.md "byzantine") — the
    attacker window [0, frac) is exactly what a ``byz_frac`` sweep lane
    overrides, so this is the tolerance atlas's base plan
    (benchmarks/byzantine_bench.py)."""
    return FaultPlan(
        seed=seed,
        byzantine=(
            ByzantineFault(
                kind=kind,
                nodes=NodeSet(frac=(0.0, frac)),
                victims=victims,
                rate=rate,
                amount=amount,
                start=start,
                end=end,
            ),
        ),
    )


def byzantine_storm(
    frac: float = 0.25,
    *,
    victims: NodeSet = ALL_NODES,
    start: float = 0.0,
    end: float | None = None,
    seed: int = 0,
) -> FaultPlan:
    """All three byzantine kinds at once from the same attacker
    fraction — the composite worst case the defense guards and the
    atlas are exercised against."""
    attackers = NodeSet(frac=(0.0, frac))
    return FaultPlan(
        seed=seed,
        byzantine=tuple(
            ByzantineFault(
                kind=kind,
                nodes=attackers,
                victims=victims,
                start=start,
                end=end,
            )
            for kind in (
                "stale_replay", "digest_inflation", "owner_violation"
            )
        ),
    )


SCENARIOS = {
    "split_brain": split_brain,
    "flaky_links": flaky_links,
    "rolling_restart": rolling_restart,
    "slow_third": slow_third,
    "byzantine_fraction": byzantine_fraction,
    "byzantine_storm": byzantine_storm,
}


def round_robin_groups(
    names: list[str] | tuple[str, ...], n_groups: int
) -> tuple[tuple[str, ...], ...]:
    """Explicit balanced groups for a runtime fleet (``names[i]`` joins
    group ``i % n_groups``) — the hash-derived buckets are balanced only
    in expectation, which a 6-node test fleet cannot rely on."""
    groups: list[list[str]] = [[] for _ in range(n_groups)]
    for i, name in enumerate(names):
        groups[i % n_groups].append(name)
    return tuple(tuple(g) for g in groups)
