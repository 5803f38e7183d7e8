"""Cluster topology models for the simulator (ring, small-world,
scale-free, hierarchical racks)."""

from .topology import Topology, hierarchical, ring, scale_free, small_world

__all__ = ("Topology", "hierarchical", "ring", "scale_free", "small_world")
