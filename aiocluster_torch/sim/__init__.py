"""The simulator: configuration, tensor state, the chunked runner, the
multi-scenario sweep, and carrying state across from the reference."""

from .config import HEADLINE_BUDGET, SimConfig, full_config, headline_config, lean_config
from .simulator import Simulator
from .state import SimState, SweepParams, init_state
from .sweep import SweepResult, SweepSimulator

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
