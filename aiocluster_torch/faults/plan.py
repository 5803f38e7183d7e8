"""Deterministic fault plans (the port's own copy of the reference's
``faults/plan.py``, standard library only).

A :class:`FaultPlan` names hostile network conditions — per-link
drop/delay/duplication, timed partitions with heal, asymmetric links,
node crash/restart, slow-peer throttling, byzantine wrong-data kinds —
as seeded, serializable data. The simulator compiles it into per-round
link, crash and guard masks (:mod:`aiocluster_torch.faults.sim`,
``SimConfig.fault_plan``), so the same scenario runs at 10k-100k nodes.
The dataclasses, their checks and their dict/JSON forms are field for
field the reference's, so a plan serialized by either package loads in
the other. Fields that only the asyncio runtime reads (node ``names``,
explicit partition ``groups``, ``duplicate``) are kept for that reason;
``check_sim_compatible`` refuses the name-addressed ones.

Determinism contract: every injected fault is a pure function of
``(plan.seed, tick, src, dst)`` in the sim — the same (seed, plan)
yields the identical schedule on every run.

Time units: plan times are gossip rounds (ticks) in the sim and seconds
in the reference's runtime. The reference's round interval is 1 s, so
the two scales coincide for reference-shaped clusters.

Everything here is hashable (frozen dataclasses over tuples), so a plan
rides inside the static, hashable ``SimConfig``.
"""

from __future__ import annotations

import json
import zlib
from dataclasses import asdict, dataclass, fields, replace


def _frac_of(name: str) -> float:
    """Stable position of a node *name* in [0, 1): the runtime's analogue
    of the sim's index/n coordinate, so fraction-addressed NodeSets mean
    the same thing in both backends (crc32 is stable across processes,
    unlike ``hash``)."""
    return (zlib.crc32(name.encode()) & 0xFFFFFFFF) / 2**32


@dataclass(frozen=True, slots=True, eq=True)
class NodeSet:
    """Which nodes a fault applies to.

    - ``names``: explicit node names (runtime) — exact matches.
    - ``frac``: a half-open [lo, hi) window of the node-coordinate space.
      The sim places node ``i`` at ``i / n``; the runtime places a node
      at ``crc32(name) / 2**32``. Fraction-addressed sets are therefore
      the portable way to say "a third of the cluster" in one plan that
      runs on both backends.
    - both empty/None: matches every node.
    """

    names: tuple[str, ...] = ()
    frac: tuple[float, float] | None = None

    def matches_all(self) -> bool:
        return not self.names and self.frac is None

    def matches_name(self, name: str) -> bool:
        if self.matches_all():
            return True
        if name in self.names:
            return True
        if self.frac is not None:
            lo, hi = self.frac
            return lo <= _frac_of(name) < hi
        return False


ALL_NODES = NodeSet()


@dataclass(frozen=True, slots=True, eq=True)
class LinkFault:
    """Directional link degradation from ``src`` to ``dst`` (asymmetric
    by construction: a plan with one direction only degrades that
    direction).

    Probabilities are per *operation* (a connect attempt, one framed
    read/write) in the runtime and per *sub-exchange direction* in the
    sim:

    - ``drop``: the operation fails — a connect is refused, a framed
      write/read sees a connection reset. In the sim the exchange simply
      does not happen this round.
    - ``delay`` / ``delay_prob``: with probability ``delay_prob`` the
      operation is stalled ``delay`` seconds (slow-peer throttling). In
      the sim a delay of >= 1 tick means the exchange misses its round
      deadline — observationally a drop for that tick; sub-tick delays
      are invisible at tick resolution.
    - ``duplicate``: a framed write is sent twice. Runtime only, and a
      STREAM-CORRUPTION fault, not benign datagram re-delivery: the
      duplicated frame lands where the Syn/SynAck/Ack state machine
      expects the next message, so the responder rejects it and closes
      the connection — the handshake's responder-side merge is lost and
      recovered by a later round/reconnect (the recovery is the point;
      tests/test_faults.py::test_duplicate_frames_desync_but_converge).
      The sim ignores duplication entirely: its connectionless
      max-merge has no stream to corrupt.
    - ``eof``: a framed read sees EOF mid-handshake — the peer appears
      to hang up between our write and its reply.

    ``start``/``end`` bound the active window (``end=None`` = forever).
    """

    src: NodeSet = ALL_NODES
    dst: NodeSet = ALL_NODES
    drop: float = 0.0
    delay: float = 0.0
    delay_prob: float = 0.0
    duplicate: float = 0.0
    eof: float = 0.0
    start: float = 0.0
    end: float | None = None

    def active(self, t: float) -> bool:
        return t >= self.start and (self.end is None or t < self.end)


@dataclass(frozen=True, slots=True, eq=True)
class Partition:
    """A timed partition into ``n_groups`` islands, healing at ``end``.

    Group assignment: explicit ``groups`` (tuples of node labels,
    runtime only) when given; otherwise derived — the sim cuts the
    index space into ``n_groups`` contiguous blocks
    (``i * n_groups // n``), the runtime buckets by the stable name
    hash (``frac * n_groups``). Traffic crossing group boundaries is
    blocked while the window is active; at ``end`` the partition heals
    and anti-entropy reconverges the islands.

    Explicit groups are FAIL-CLOSED: a label not listed in any group is
    isolated from everyone while the partition is active. Runtime plans
    must therefore list each member under BOTH its node name and its
    ``host:port`` — before a peer's first handshake the dialer can only
    label it by address, and bucketing that unresolved label by hash
    could silently land it in the dialer's own group, leaking traffic
    across the cut (``ChaosHarness.name_groups`` builds the aliased
    groups for you).
    """

    n_groups: int = 2
    start: float = 0.0
    end: float | None = None
    groups: tuple[tuple[str, ...], ...] = ()

    def active(self, t: float) -> bool:
        return t >= self.start and (self.end is None or t < self.end)

    def group_of_name(self, name: str) -> int | None:
        """The label's group, or None when explicit groups are given
        and the label is unlisted (fail-closed: an unknown peer is cut
        from every island while the partition is active — see class
        docstring)."""
        if self.groups:
            for g, members in enumerate(self.groups):
                if name in members:
                    return g
            return None
        # Derived assignment: stable hash bucket (total by construction).
        g = int(_frac_of(name) * self.n_groups)
        return min(g, self.n_groups - 1)


RECOVERY_KINDS = ("amnesia", "warm")


@dataclass(frozen=True, slots=True, eq=True)
class NodeCrash:
    """Nodes in ``nodes`` crash at ``at`` and restart ``down_for``
    later. While down, peers' connects to it are refused (runtime) /
    its exchanges no-op and its heartbeat and writes freeze (sim).
    ``recovery`` names what the restart comes back WITH
    (docs/robustness.md "Durability & lifecycle"):

    - ``"amnesia"`` (the default — the reference's restart semantics):
      the node reboots with an empty keyspace. The ChaosHarness boots a
      fresh Cluster with a **bumped generation** (newer-generation-wins
      exercised for real); the sim resets the node's knowledge row at
      the restart tick, so it re-replicates the whole cluster from
      zero — the full-state anti-entropy cost a rolling restart pays.
      (The sim's watermark model has no generations: owner ground truth
      persists and only the replica knowledge resets; the runtime's
      generation bump additionally re-replicates the node's OWN state,
      which the sim does not model.)
    - ``"warm"``: the node reboots with its durable store
      (``Config.persistence`` — the ChaosHarness requires a
      ``persist_root``). The crash itself is an ``abort()`` (no clean
      marker), so the generation still bumps, but the restored
      version/GC watermarks turn rejoin into delta catch-up. In the sim
      the crash window freezes and nothing resets — the watermarks ARE
      the persisted knowledge.
    """

    nodes: NodeSet = ALL_NODES
    at: float = 0.0
    down_for: float = 1.0
    recovery: str = "amnesia"

    def down(self, t: float) -> bool:
        return self.at <= t < self.at + self.down_for


BYZANTINE_KINDS = ("stale_replay", "digest_inflation", "owner_violation")


@dataclass(frozen=True, slots=True, eq=True)
class ByzantineFault:
    """Wrong-data faults: nodes in ``nodes`` actively lie on the wire
    while the window is open (versus everything above, which only
    degrades delivery). The three kinds violate the two assumptions the
    paper's correctness rests on — each node is the sole writer of its
    own keyspace (van Renesse et al.), and advertised state is honest:

    - ``stale_replay``: the attacker re-advertises OLD versions for the
      ``victims``' keys — its digests claim ancient knowledge of them
      (heartbeat included: stale heartbeat adverts are the phi-accrual
      attack surface) and its outbound deltas replay below-floor
      versions while keeping the ``max_version`` stamp, the poison that
      would fast-forward an unguarded receiver past data it never got.
    - ``digest_inflation``: the attacker's digests claim ``max_version``
      for ``victims`` AHEAD of reality by ``amount``, and its outbound
      delta stamps are inflated the same way — honest responders
      withhold the victims' data from it (it "already has" everything),
      and an unguarded receiver of an inflated stamp would skip every
      future legitimate update below it.
    - ``owner_violation``: the attacker ships deltas mutating keyspaces
      it does not own — the ACT03x invariant as a runtime attack:
      fabricated key-values (version ``amount`` past the stamp) replace
      its genuine relays for each victim, including deltas that target
      the receiver's OWN keyspace when it gossips with a victim.

    Defenses land with the kinds (docs/faults.md "byzantine"): the
    apply-delta path rejects self-keyspace writes, below-floor replays,
    over-stamp key-values and unsupported ``max_version`` fast-forwards
    (core/guards.py), counting each in
    ``aiocluster_byzantine_rejected_total{kind}``; the sim lowers the
    guarded outcome as per-round masks (faults/sim.py). A combined
    attack that fabricates a self-consistent future history is
    detectable only by the true owner — that residual surface is what
    the tolerance atlas (benchmarks/byzantine_bench.py) maps.

    ``rate`` is the per-message injection probability (runtime) and the
    per-(src, dst, tick) mask probability (sim). ``amount`` is the
    version-space offset inflation/fabrication uses.
    """

    kind: str
    nodes: NodeSet = ALL_NODES
    victims: NodeSet = ALL_NODES
    rate: float = 1.0
    amount: int = 1 << 20
    start: float = 0.0
    end: float | None = None

    def active(self, t: float) -> bool:
        return t >= self.start and (self.end is None or t < self.end)


@dataclass(frozen=True, slots=True, eq=True)
class FaultPlan:
    """A complete, seeded fault scenario (see module docstring)."""

    seed: int = 0
    links: tuple[LinkFault, ...] = ()
    partitions: tuple[Partition, ...] = ()
    crashes: tuple[NodeCrash, ...] = ()
    byzantine: tuple[ByzantineFault, ...] = ()

    # -- validation -----------------------------------------------------------

    def __post_init__(self) -> None:
        for lf in self.links:
            for name in ("drop", "delay_prob", "duplicate", "eof"):
                p = getattr(lf, name)
                if not 0.0 <= p <= 1.0:
                    raise ValueError(f"LinkFault.{name} must be in [0, 1], got {p}")
            if lf.delay < 0:
                raise ValueError("LinkFault.delay must be >= 0")
        for part in self.partitions:
            if part.n_groups < 2:
                raise ValueError("Partition.n_groups must be >= 2")
            if part.groups and len(part.groups) != part.n_groups:
                raise ValueError("Partition.groups length must equal n_groups")
        for cr in self.crashes:
            if cr.down_for <= 0:
                raise ValueError("NodeCrash.down_for must be > 0")
            if cr.recovery not in RECOVERY_KINDS:
                raise ValueError(
                    f"unknown NodeCrash.recovery {cr.recovery!r} "
                    f"(one of {RECOVERY_KINDS})"
                )
        for bf in self.byzantine:
            if bf.kind not in BYZANTINE_KINDS:
                raise ValueError(
                    f"unknown ByzantineFault.kind {bf.kind!r} "
                    f"(one of {BYZANTINE_KINDS})"
                )
            if not 0.0 <= bf.rate <= 1.0:
                raise ValueError(
                    f"ByzantineFault.rate must be in [0, 1], got {bf.rate}"
                )
            if bf.amount < 1:
                raise ValueError("ByzantineFault.amount must be >= 1")

    def check_sim_compatible(self) -> None:
        """The sim addresses nodes by index fraction only: a plan whose
        NodeSets use explicit ``names`` or whose partitions use explicit
        ``groups`` cannot be compiled to masks. Raise a descriptive
        error instead of silently matching nothing."""
        sets = [(lf.src, "LinkFault.src") for lf in self.links]
        sets += [(lf.dst, "LinkFault.dst") for lf in self.links]
        sets += [(cr.nodes, "NodeCrash.nodes") for cr in self.crashes]
        sets += [(bf.nodes, "ByzantineFault.nodes") for bf in self.byzantine]
        sets += [
            (bf.victims, "ByzantineFault.victims") for bf in self.byzantine
        ]
        for ns, where in sets:
            if ns.names:
                raise ValueError(
                    f"{where} uses explicit names — the sim backend only "
                    "supports fraction-addressed NodeSets (frac=(lo, hi))"
                )
        for part in self.partitions:
            if part.groups:
                raise ValueError(
                    "Partition.groups uses explicit names — the sim "
                    "backend derives groups from contiguous index blocks"
                )

    # -- serialization --------------------------------------------------------

    def to_dict(self) -> dict:
        return asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), sort_keys=True)

    @classmethod
    def from_dict(cls, data: dict) -> "FaultPlan":
        def _nodeset(d: dict) -> NodeSet:
            return NodeSet(
                names=tuple(d.get("names", ())),
                frac=tuple(d["frac"]) if d.get("frac") is not None else None,
            )

        def _load(dc_cls, d: dict, nodeset_keys: tuple[str, ...]):
            kwargs = dict(d)
            for key in nodeset_keys:
                if key in kwargs:
                    kwargs[key] = _nodeset(kwargs[key])
            allowed = {f.name for f in fields(dc_cls)}
            unknown = set(kwargs) - allowed
            if unknown:
                raise ValueError(
                    f"unknown {dc_cls.__name__} fields: {sorted(unknown)}"
                )
            return dc_cls(**kwargs)

        return cls(
            seed=int(data.get("seed", 0)),
            links=tuple(
                _load(LinkFault, d, ("src", "dst"))
                for d in data.get("links", ())
            ),
            partitions=tuple(
                _load(
                    Partition,
                    {**d, "groups": tuple(tuple(g) for g in d.get("groups", ()))},
                    (),
                )
                for d in data.get("partitions", ())
            ),
            crashes=tuple(
                _load(NodeCrash, d, ("nodes",)) for d in data.get("crashes", ())
            ),
            byzantine=tuple(
                _load(ByzantineFault, d, ("nodes", "victims"))
                for d in data.get("byzantine", ())
            ),
        )

    @classmethod
    def from_json(cls, raw: str) -> "FaultPlan":
        return cls.from_dict(json.loads(raw))


def with_extra_links(
    plan: "FaultPlan | None", links: tuple[LinkFault, ...]
) -> "FaultPlan | None":
    """``plan`` with ``links`` appended (a fresh plan when None) — how
    heterogeneity's WAN classes (models/topology.py) fold into the one
    fault-injection machinery on both backends. Appending keeps every
    existing entry's index, so the plan's probabilistic draw streams
    (keyed per link-fault index) are unchanged for the original links."""
    if not links:
        return plan
    if plan is None:
        return FaultPlan(links=tuple(links))
    # dataclasses.replace keeps the copy complete by construction: a
    # future FaultPlan field cannot be silently dropped here.
    return replace(plan, links=plan.links + tuple(links))
