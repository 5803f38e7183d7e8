"""Cluster topology models for the simulator (ring, small-world,
scale-free, hierarchical racks) and its heterogeneity classes."""

from .topology import Heterogeneity, Topology, hierarchical, ring, scale_free, small_world

__all__ = ("Heterogeneity", "Topology", "hierarchical", "ring", "scale_free", "small_world")
