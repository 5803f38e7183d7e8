"""The simulator: configuration, tensor state, the chunked runner, the
multi-scenario sweep, checkpoints, the Cluster-shaped ``SimCluster`` and
carrying state across from the reference."""

from .checkpoint import load_state, load_sweep, save_state, save_sweep
from .config import HEADLINE_BUDGET, SimConfig, full_config, headline_config, lean_config
from .simcluster import SimCluster
from .simulator import Simulator
from .state import SimState, SweepParams, init_state
from .sweep import SweepResult, SweepSimulator

__all__ = (
    "HEADLINE_BUDGET",
    "SimCluster",
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
    "load_state",
    "load_sweep",
    "save_state",
    "save_sweep",
)
