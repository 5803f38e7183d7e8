"""The simulator: configuration, tensor state, the chunked runner, and
carrying state across from the reference."""

from .config import HEADLINE_BUDGET, SimConfig, full_config, headline_config, lean_config
from .simulator import Simulator
from .state import SimState, init_state

__all__ = (
    "HEADLINE_BUDGET",
    "SimConfig",
    "SimState",
    "Simulator",
    "full_config",
    "headline_config",
    "init_state",
    "lean_config",
)
