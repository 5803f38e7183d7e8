"""aiocluster_torch: the batched gossip simulator of aiocluster_tpu,
ported to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The reference package (``aiocluster_tpu``, JAX on a TPU) stays as it is;
this package imports nothing from it, nor JAX. ``Simulator(cfg,
seed=...)`` follows the reference's trajectory round for round on the
same ``SimConfig`` and seed, and ``SweepSimulator(cfg, seeds, ...)``
runs S such scenarios together, one lane each. ``Simulator(cfg,
mesh=parallel.make_mesh(...))`` holds the state as column blocks of the
owners over a mesh's devices (the reference's owner-sharded simulator),
and ``Simulator(cfg, topology=models.scale_free(...))`` draws each
node's peers from an adjacency. Every config of the reference's
simulator runs, fault plans (``aiocluster_torch.faults``) and
heterogeneity classes (``models.Heterogeneity``) included. A run
saves and resumes through the reference's checkpoint file
(``Simulator.save`` / ``Simulator.resume``), reports through
``obs.MetricsRegistry`` and ``obs.TraceWriter`` (``Simulator(metrics=,
trace_writer=)``), and ``SimCluster`` gives it the reference's
key/value surface. Its entry points run on the CUDA device unless the caller passes
``device="cpu"`` (or a mesh of CPU devices), where every kernel wrapper
takes its plain PyTorch version.
"""

from .faults import FaultPlan
from .models import Heterogeneity
from .obs import MetricsRegistry, TraceWriter
from .sim import (
    HEADLINE_BUDGET,
    SimCluster,
    SimConfig,
    SimState,
    Simulator,
    SweepParams,
    SweepResult,
    SweepSimulator,
    full_config,
    headline_config,
    init_state,
    lean_config,
)

__all__ = (
    "FaultPlan",
    "HEADLINE_BUDGET",
    "Heterogeneity",
    "MetricsRegistry",
    "SimCluster",
    "SimConfig",
    "SimState",
    "Simulator",
    "SweepParams",
    "SweepResult",
    "SweepSimulator",
    "TraceWriter",
    "full_config",
    "headline_config",
    "init_state",
    "lean_config",
)
