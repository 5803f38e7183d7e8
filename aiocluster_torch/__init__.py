"""aiocluster_torch: the batched gossip simulator of aiocluster_tpu,
ported to PyTorch with hand-written CUDA kernels for NVIDIA Hopper.

The reference package (``aiocluster_tpu``, JAX on a TPU) stays as it is;
this package imports nothing from it, nor JAX. ``Simulator(cfg,
seed=...)`` follows the reference's trajectory round for round on the
same ``SimConfig`` and seed, and ``SweepSimulator(cfg, seeds, ...)``
runs S such scenarios together, one lane each. Its entry points run on
the CUDA device unless the caller passes ``device="cpu"``, where every
kernel wrapper takes its plain PyTorch version.
"""

from .sim import (
    HEADLINE_BUDGET,
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
    "HEADLINE_BUDGET",
    "SimConfig",
    "SimState",
    "Simulator",
    "SweepParams",
    "SweepResult",
    "SweepSimulator",
    "full_config",
    "headline_config",
    "init_state",
    "lean_config",
)
