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
``Heterogeneity`` (the cadence, WAN and zone classes) comes with the
fault plans (ROADMAP.md A10).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np


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
