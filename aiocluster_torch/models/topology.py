"""Gossip topologies as padded adjacency arrays (the port's copy of the
reference's ``models/topology.py``, numpy only).

The benchmark configs name explicit topologies — ring-seeded,
random-fanout, scale-free — so the simulator takes an optional
``(N, max_degree)`` adjacency with an ``(N,)`` degree vector and draws
uniform neighbours by gather (``prng.chunk_draws``; ``Simulator(cfg,
topology=...)``). ``None`` means fully-connected random fanout. Every
generator builds the same arrays as the reference's for the same
arguments (the same numpy generator calls in the same order).

Static shapes: adjacency rows are padded to max_degree with self-loops
(sampling a pad slot can't happen because degrees bounds the draw).

``Heterogeneity`` is the reference's model of per-node gossip cadence
classes, WAN latency/loss classes and zone-aware peer bias, lowered by
the simulator onto the fault plan's masks (faults/sim.py) and the choice
draw (ops/prng.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


@dataclass(frozen=True, slots=True, eq=True)
class Heterogeneity:
    """Per-node gossip-cadence classes, WAN latency/loss classes and
    zone-aware peer bias — one hashable model lowered to BOTH backends
    (docs/faults.md "heterogeneity").

    The node-coordinate space is the fault plan's: the sim places node
    ``i`` at ``i / n``, the runtime places a node at
    ``crc32(name) / 2**32`` (faults/plan._frac_of), so classes and
    zones mean the same thing in one config that runs on both.

    - **Cadence classes**: ``class_frac`` cuts the coordinate space
      into consecutive windows (must sum to 1); a class-``k`` node
      initiates gossip every ``gossip_every[k]`` rounds. Runtime: the
      node's ticker interval is scaled by its class
      (``Cluster.effective_gossip_interval``). Sim: a symmetric
      ("matching") pair exchanges when EITHER side is on-cadence this
      tick — a quiet node still responds, as in the reference; the
      directional pairings ("permutation", "choice") gate each
      handshake by its initiator's cadence (responders always serve).
    - **WAN classes**: ``zones`` contiguous coordinate blocks; every
      cross-zone link drops each operation with probability
      ``wan_loss`` and stalls ``wan_delay`` seconds (ticks in the sim —
      a delay >= 1 tick misses the round) with probability 1. Lowered
      as derived :class:`~aiocluster_torch.faults.plan.LinkFault` entries
      appended to the effective fault plan (``wan_link_faults``), so
      one injection machinery serves both backends.
    - **Zone bias**: with probability ``zone_bias`` a peer pick is
      drawn from the node's own zone. Runtime: biases the live-target
      sample (runtime/peers.py). Sim: requires ``pairing="choice"``
      (a global matching cannot honour per-node preference).
    """

    gossip_every: tuple[int, ...] = (1,)
    class_frac: tuple[float, ...] = (1.0,)
    zones: int = 1
    wan_delay: float = 0.0
    wan_loss: float = 0.0
    zone_bias: float = 0.0

    def __post_init__(self) -> None:
        if len(self.gossip_every) != len(self.class_frac):
            raise ValueError(
                "gossip_every and class_frac must have the same length"
            )
        if not self.gossip_every:
            raise ValueError("need at least one cadence class")
        if any(int(g) != g or g < 1 for g in self.gossip_every):
            raise ValueError("gossip_every periods must be integers >= 1")
        if any(f < 0 for f in self.class_frac):
            raise ValueError("class_frac entries must be >= 0")
        if abs(sum(self.class_frac) - 1.0) > 1e-6:
            raise ValueError("class_frac must sum to 1")
        if self.zones < 1:
            raise ValueError("zones must be >= 1")
        if self.wan_delay < 0:
            raise ValueError("wan_delay must be >= 0")
        if not 0.0 <= self.wan_loss <= 1.0:
            raise ValueError("wan_loss must be in [0, 1]")
        if not 0.0 <= self.zone_bias <= 1.0:
            raise ValueError("zone_bias must be in [0, 1]")
        if (self.wan_loss > 0 or self.wan_delay > 0) and self.zones < 2:
            raise ValueError("WAN loss/delay needs zones >= 2")

    # -- coordinate classification (shared by both backends) ------------------

    def class_of_frac(self, frac: float) -> int:
        """Cadence class of a node at coordinate ``frac`` in [0, 1)."""
        cum = 0.0
        for k, f in enumerate(self.class_frac):
            cum += f
            if frac < cum:
                return k
        return len(self.class_frac) - 1

    def zone_of_frac(self, frac: float) -> int:
        """Zone of a node at coordinate ``frac`` — floor(frac * zones),
        the same bucketing Partition uses for derived groups."""
        return min(int(frac * self.zones), self.zones - 1)

    def class_of_name(self, name: str) -> int:
        from ..faults.plan import _frac_of

        return self.class_of_frac(_frac_of(name))

    def zone_of_name(self, name: str) -> int:
        from ..faults.plan import _frac_of

        return self.zone_of_frac(_frac_of(name))

    def gossip_every_of_name(self, name: str) -> int:
        return self.gossip_every[self.class_of_name(name)]

    # -- behaviour predicates -------------------------------------------------

    def cadence_effective(self) -> bool:
        return any(g != 1 for g in self.gossip_every)

    def wan_effective(self) -> bool:
        return self.zones >= 2 and (self.wan_loss > 0 or self.wan_delay > 0)

    def effective(self) -> bool:
        """Whether this model changes ANY behaviour (the all-defaults
        instance is free: nothing is constructed or masked)."""
        return (
            self.cadence_effective()
            or self.wan_effective()
            or self.zone_bias > 0
        )

    # -- WAN lowering ---------------------------------------------------------

    def wan_link_faults(self):
        """The cross-zone degradation as directional LinkFaults over the
        zones' coordinate windows — appended to the effective fault plan
        by both backends (faults.plan.with_extra_links)."""
        from ..faults.plan import LinkFault, NodeSet

        if not self.wan_effective():
            return ()
        z = self.zones

        def window(a: int) -> NodeSet:
            return NodeSet(frac=(a / z, (a + 1) / z))

        return tuple(
            LinkFault(
                src=window(a),
                dst=window(b),
                drop=self.wan_loss,
                delay=self.wan_delay,
                delay_prob=1.0 if self.wan_delay > 0 else 0.0,
            )
            for a in range(z)
            for b in range(z)
            if a != b
        )


@dataclass(frozen=True)
class Topology:
    """Padded adjacency: node i may gossip with adjacency[i, :degrees[i]]."""

    adjacency: np.ndarray  # (N, max_degree) int32
    degrees: np.ndarray  # (N,) int32

    @property
    def n_nodes(self) -> int:
        return self.adjacency.shape[0]


def ring(n: int, neighbors_each_side: int = 1) -> Topology:
    """Ring lattice: each node sees the k nearest nodes on each side —
    BASELINE config 2's 'ring-seeded' shape."""
    offsets = np.concatenate(
        [np.arange(1, neighbors_each_side + 1), -np.arange(1, neighbors_each_side + 1)]
    )
    idx = (np.arange(n)[:, None] + offsets[None, :]) % n
    degrees = np.full(n, len(offsets), np.int32)
    return Topology(idx.astype(np.int32), degrees)


def _from_neighbor_sets(n: int, neighbors: list[set[int]]) -> Topology:
    """Pad per-node neighbor sets into the dense Topology layout
    (self-loop padding; isolated nodes get a degree-1 self edge)."""
    degrees = np.array([max(1, len(s)) for s in neighbors], np.int32)
    width = int(degrees.max())
    adjacency = np.tile(np.arange(n, dtype=np.int32)[:, None], (1, width))
    for i, s in enumerate(neighbors):
        row = sorted(s) if s else [i]
        adjacency[i, : len(row)] = row
    return Topology(adjacency.astype(np.int32), degrees)


def scale_free(
    n: int, attach: int = 3, max_degree: int | None = None, seed: int = 0
) -> Topology:
    """Barabási–Albert preferential attachment — BASELINE config 4's
    'scale-free' shape. Degrees are capped at ``max_degree`` (default
    16*attach) to keep the padded adjacency tensor dense-friendly; the cap
    sheds only the heaviest hub edges."""
    rng = np.random.default_rng(seed)
    cap = max_degree or 16 * attach
    if cap <= attach:
        raise ValueError(f"max_degree ({cap}) must exceed attach ({attach})")
    neighbors: list[set[int]] = [set() for _ in range(n)]
    # Seed clique over the first attach+1 nodes.
    for i in range(attach + 1):
        for j in range(i + 1, attach + 1):
            neighbors[i].add(j)
            neighbors[j].add(i)
    repeated: list[int] = [i for i in range(attach + 1) for _ in neighbors[i]]
    for v in range(attach + 1, n):
        targets: set[int] = set()
        # Preferential picks, bounded; if the degree cap starves the pool
        # (every candidate saturated), fall back to uniform under-cap nodes
        # and accept fewer than ``attach`` edges rather than spinning.
        for _ in range(20 * attach):
            if len(targets) >= attach:
                break
            pick = repeated[rng.integers(len(repeated))] if repeated else int(
                rng.integers(v)
            )
            if pick != v and pick not in targets and len(neighbors[pick]) < cap:
                targets.add(pick)
        if len(targets) < attach:
            under_cap = [
                u for u in range(v)
                if u not in targets and len(neighbors[u]) < cap
            ]
            rng.shuffle(under_cap)
            targets.update(under_cap[: attach - len(targets)])
        for t in targets:
            neighbors[v].add(t)
            neighbors[t].add(v)
            repeated.extend((v, t))
    return _from_neighbor_sets(n, neighbors)


def small_world(
    n: int, neighbors_each_side: int = 2, rewire_p: float = 0.1, seed: int = 0
) -> Topology:
    """Watts–Strogatz small-world graph: a ring lattice with each edge
    rewired to a uniform random endpoint with probability ``rewire_p``.
    Interpolates between config 2's ring (p=0) and random-fanout (p=1) —
    the shape where gossip latency drops from O(N) hops to O(log N) with
    only a few long links, a useful fidelity point between the two
    BASELINE extremes."""
    if not 0.0 <= rewire_p <= 1.0:
        raise ValueError("rewire_p must be in [0, 1]")
    if neighbors_each_side < 1 or 2 * neighbors_each_side >= n:
        raise ValueError(
            "need 1 <= neighbors_each_side and 2*neighbors_each_side < n"
        )
    rng = np.random.default_rng(seed)
    neighbors: list[set[int]] = [set() for _ in range(n)]
    for k in range(1, neighbors_each_side + 1):
        for i in range(n):
            j = (i + k) % n
            if rng.random() < rewire_p:
                # Rewire i--(i+k) to i--random, avoiding self/duplicates.
                for _ in range(8):
                    cand = int(rng.integers(n))
                    if cand != i and cand not in neighbors[i]:
                        j = cand
                        break
            neighbors[i].add(j)
            neighbors[j].add(i)
    return _from_neighbor_sets(n, neighbors)


def hierarchical(
    n: int, rack_size: int = 16, uplinks_per_node: int = 1, seed: int = 0
) -> Topology:
    """Two-level datacenter shape: full connectivity inside each rack of
    ``rack_size`` nodes plus ``uplinks_per_node`` random cross-rack
    links per node. Models gossip whose fast path is rack-local (ToR
    switch) with sparse inter-rack spillover — the regime where the
    reference's seed-node re-gossip (server.py:670-682) matters most,
    because cross-partition links are scarce."""
    if rack_size < 2:
        raise ValueError("rack_size must be >= 2")
    if uplinks_per_node > 0 and n <= rack_size:
        raise ValueError("cross-rack uplinks need more than one rack")
    rng = np.random.default_rng(seed)
    neighbors: list[set[int]] = [set() for _ in range(n)]
    for i in range(n):
        rack = i // rack_size
        lo, hi = rack * rack_size, min((rack + 1) * rack_size, n)
        for j in range(lo, hi):
            if j != i:
                neighbors[i].add(j)
        for _ in range(uplinks_per_node):
            for _ in range(16):
                cand = int(rng.integers(n))
                if cand // rack_size != rack and cand not in neighbors[i]:
                    neighbors[i].add(cand)
                    neighbors[cand].add(i)
                    break
    return _from_neighbor_sets(n, neighbors)
