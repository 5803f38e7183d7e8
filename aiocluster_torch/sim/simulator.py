"""Host-side runner of the PyTorch gossip simulator.

Keeps the SimState resident on its device and steps it in chunks of
rounds: the draws of a whole chunk (every sub-exchange's grouped
matching) are computed on the device in one batched pass, each round's
kernels are queued without a host sync, and convergence is polled once
per chunk — the counterpart of the reference's jit-compiled chunks.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import counters, prng
from ..ops.gossip import convergence_metrics, pull_phase_engaged, sim_step
from .config import SimConfig
from .state import (
    DTYPES,
    HEARTBEAT_LIMITS,
    VERSION_LIMITS,
    SimState,
    expected_dtypes,
    expected_shapes,
    init_state,
)


class Simulator:
    """Runs one simulated cluster to convergence (or for a fixed number
    of rounds) on ``device`` ("cuda" unless the caller asks otherwise).
    The trajectory depends only on (cfg, seed, tick): it equals the
    reference's ``Simulator(cfg, seed=seed)`` round for round."""

    def __init__(
        self,
        cfg: SimConfig,
        *,
        seed: int = 0,
        chunk: int = 8,
        state: SimState | None = None,
        device: str | torch.device = "cuda",
        mesh=None,
        topology=None,
    ) -> None:
        if mesh is not None or topology is not None:
            counters.refuse(
                "meshes and topologies are not ported yet: ROADMAP.md A15 "
                "(multi-GPU) and A7 (choice pairing over an adjacency)"
            )
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.cfg = cfg
        self.chunk = chunk
        self.seed = seed
        self.device = torch.device(device)
        pull_phase_engaged(cfg, self.device)  # refuse before allocating
        self._key = prng.key(seed)
        self._run_salt = prng.run_salt(self._key)
        self._device_key = self._key.to(self.device)
        if state is None:
            state = init_state(cfg, device=self.device)
        else:
            _check_state(state, cfg, self.device)
        self.state: SimState = state
        # Horizon guard inputs, read once here where a sync is free.
        self._known_max_version = int(state.max_version.max())
        self._host_tick = int(state.tick)
        self._version_base_tick = self._host_tick

    # -- stepping -------------------------------------------------------------

    def _check_horizon(self, rounds: int) -> None:
        """Raise before a narrow rung silently wraps: heartbeats store the
        tick, narrow watermarks store versions. Host arithmetic only."""
        end_tick = self._host_tick + rounds
        hb_limit = HEARTBEAT_LIMITS[self.cfg.heartbeat_dtype]
        if (
            self.cfg.track_heartbeats
            and hb_limit < 2**31
            and end_tick >= hb_limit
        ):
            raise ValueError(
                f"running to tick {end_tick} overflows "
                f"{self.cfg.heartbeat_dtype} heartbeats (heartbeat_dtype "
                f"stores the tick; horizons >= {hb_limit} rounds need a "
                "wider rung)"
            )
        v_limit = VERSION_LIMITS[self.cfg.version_dtype]
        if v_limit < 2**31:
            bound = self._known_max_version + self.cfg.writes_per_round * (
                end_tick - self._version_base_tick
            )
            if bound >= v_limit:
                raise ValueError(
                    f"versions may reach {bound} by tick {end_tick}, "
                    f"overflowing version_dtype='{self.cfg.version_dtype}' "
                    f"(limit {v_limit}; lower writes_per_round/horizon or "
                    "use a wider rung)"
                )

    def _run_chunk(self, m: int, tracked: bool) -> torch.Tensor:
        """Queue ``m`` rounds; returns the device scalar holding the first
        converged tick among them (0 if none; always 0 untracked). The
        chunk's draws and each round are ``torch.profiler`` ranges
        (``aiocluster_torch.draws`` / ``aiocluster_torch.sim_step``)."""
        with record_function("aiocluster_torch.draws"):
            gm, c, p = prng.round_draws(
                self._device_key, self._host_tick + 1, m, self.cfg.n_nodes,
                self.cfg.fanout,
            )
        first = torch.zeros((), dtype=torch.int32, device=self.device)
        for r in range(m):
            with record_function("aiocluster_torch.sim_step"):
                out = sim_step(
                    self.state, self._key, self.cfg,
                    return_converged=tracked, tick=self._host_tick,
                    draws=(gm[r], c[r], p[r]), run_salt=self._run_salt,
                )
            self._host_tick += 1
            if tracked:
                self.state, conv = out
                first = torch.where((first == 0) & conv, self.state.tick, first)
            else:
                self.state = out
        return first

    def run(self, rounds: int) -> None:
        """Advance a fixed number of gossip rounds."""
        self._check_horizon(rounds)
        done = 0
        while done < rounds:
            m = min(self.chunk, rounds - done)
            self._run_chunk(m, tracked=False)
            done += m

    def run_until_converged(self, max_rounds: int = 100_000) -> int | None:
        """Step until every alive node holds every alive owner's full
        keyspace; returns the EXACT first round at which that held (the
        check runs every round, so the count is invariant to ``chunk``),
        or None if max_rounds elapsed. One host sync per chunk."""
        if bool(self.metrics()["all_converged"]):
            return self._host_tick
        while self._host_tick < max_rounds:
            m = min(self.chunk, max_rounds - self._host_tick)
            self._check_horizon(m)
            first = int(self._run_chunk(m, tracked=True))
            if first:
                return first
        return None

    # -- observation ----------------------------------------------------------

    def metrics(self) -> dict[str, np.ndarray]:
        return {
            k: v.cpu().numpy() for k, v in convergence_metrics(self.state).items()
        }

    @property
    def tick(self) -> int:
        return int(self.state.tick)


def _check_state(state: SimState, cfg: SimConfig, device: torch.device) -> None:
    """A provided state must hold this config's rung and live on the
    simulator's device (nothing is moved silently)."""
    want = expected_dtypes(cfg)
    for name, dt in want.items():
        t = getattr(state, name)
        if t.dtype != DTYPES[dt]:
            raise ValueError(f"state.{name} is {t.dtype}, config expects {dt}")
        if t.device.type != device.type:
            raise ValueError(f"state.{name} is on {t.device}, expected {device}")
    for name, shape in expected_shapes(cfg).items():
        got = tuple(getattr(state, name).shape)
        if got != shape:
            raise ValueError(f"state.{name} shape {got} != {shape}")
