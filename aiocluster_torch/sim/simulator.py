"""Host-side runner of the PyTorch gossip simulator.

Keeps the SimState resident on its device (or, with ``mesh=``, as column
blocks of the owners over a mesh's devices: parallel/mesh.py) and steps
it in chunks of rounds: the draws of a whole chunk (the matchings or
permutations, the churn flips, the choice peers: ``prng.chunk_draws``)
are computed on the device in one batched pass, each
round's kernels are queued without a host sync, and convergence is
polled once per chunk — the counterpart of the reference's jit-compiled
chunks.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import prng
from ..ops.gossip import (
    convergence_metrics,
    metrics_sample_blocks,
    pull_phase_engaged,
    run_rounds,
)
from ..parallel.mesh import Mesh, gather_state, init_blocks, shard_state
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
    of rounds) on ``device`` ("cuda" unless the caller asks otherwise),
    or with ``mesh=`` (``parallel.make_mesh``) over the mesh's devices,
    its state held as one column block of the owners per mesh entry
    (the reference's owner-sharded simulator). The trajectory depends
    only on (cfg, seed, tick): it equals the reference's
    ``Simulator(cfg, seed=seed)`` round for round, sharded or not.

    ``topology`` (a ``models.Topology``) restricts each node's peers to
    its adjacency row (the choice path; its arrays go to the device).
    ``cfg.fault_plan`` and ``cfg.heterogeneity`` run as in the reference
    (faults/sim.py), on the mesh too.

    ``state`` is the whole state (with a mesh: gathered, a copy of
    every matrix on the first device); ``blocks`` are the column blocks
    as held (one block, the state itself, without a mesh)."""

    def __init__(
        self,
        cfg: SimConfig,
        *,
        seed: int = 0,
        chunk: int = 8,
        state: SimState | None = None,
        device: str | torch.device | None = None,
        mesh: Mesh | None = None,
        topology=None,
    ) -> None:
        if topology is not None and topology.n_nodes != cfg.n_nodes:
            raise ValueError("topology size != cfg.n_nodes")
        if topology is not None and cfg.version_dtype == "u4r":
            raise ValueError(
                "version_dtype='u4r' does not support topology runs "
                "(the adjacency path's scatter-max is unpacked-only)"
            )
        if (
            topology is not None
            and cfg.heterogeneity is not None
            and cfg.heterogeneity.zone_bias > 0
        ):
            raise ValueError(
                "zone_bias does not support topology runs (the "
                "adjacency draw carries no zone bias; refusing beats "
                "silently sampling unbiased)"
            )
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.cfg = cfg
        self.chunk = chunk
        self.seed = seed
        self.mesh = mesh
        if mesh is None:
            self.device = torch.device("cuda" if device is None else device)
            self._offsets: tuple[int, ...] = (0,)
            n_local = None
        else:
            if device is not None:
                raise ValueError("a mesh places its blocks: list its devices, not device=")
            self.device = mesh.devices[0]
            self._offsets = mesh.offsets(cfg)
            n_local = mesh.n_local(cfg)
        # Refuse before allocating.
        pull_phase_engaged(cfg, self.device, n_local, has_topology=topology is not None)
        self._adj = self._deg = None
        if topology is not None:
            self._adj = torch.as_tensor(np.asarray(topology.adjacency), device=self.device)
            self._deg = torch.as_tensor(np.asarray(topology.degrees), device=self.device)
        self._key = prng.key(seed)
        self._run_salt = prng.run_salt(self._key)
        self._device_key = self._key.to(self.device)
        if state is not None:
            _check_state(state, cfg, None if mesh else self.device)
            blocks = [state] if mesh is None else shard_state(state, mesh)
        elif mesh is None:
            blocks = [init_state(cfg, device=self.device)]
        else:
            blocks = init_blocks(cfg, mesh)
        self._blocks: list[SimState] = blocks
        head = blocks[0]
        # The churn-free 'choice' draw is uniform over ALL nodes (the
        # alive mask is statically all-true for the states such a config
        # produces): a provided state with dead nodes would be sampled
        # wrongly, so it is refused, as the reference does. The view draw
        # samples from live_view instead and takes such states.
        if (
            state is not None
            and cfg.pairing == "choice"
            and cfg.peer_mode == "alive"
            and cfg.death_rate == 0.0
            and cfg.revival_rate == 0.0
            and not bool(head.alive.all())
        ):
            raise ValueError(
                "churn-free 'choice' config resumed with dead nodes in "
                "state.alive — peer sampling would ignore them; run this "
                "state under a config with churn enabled"
            )
        # Horizon guard inputs, read once here where a sync is free.
        self._known_max_version = int(head.max_version.max())
        self._host_tick = int(head.tick)
        self._version_base_tick = self._host_tick

    @property
    def blocks(self) -> list[SimState]:
        """The state as held: the column blocks of a mesh, in mesh order
        (block k holds the owners ``k * n_local ..``), or the one whole
        state."""
        return self._blocks

    @property
    def state(self) -> SimState:
        """The whole state (with a mesh, gathered onto the first device:
        a copy)."""
        if self.mesh is None:
            return self._blocks[0]
        return gather_state(self._blocks)

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
        """Queue ``m`` rounds (``gossip.run_rounds``); returns the
        device scalar holding the first converged tick among them (0 if
        none; always 0 untracked)."""
        self._blocks, first = run_rounds(
            self._blocks, self._key, self.cfg, offsets=self._offsets, m=m,
            tick=self._host_tick, tracked=tracked, run_salt=self._run_salt,
            device_key=self._device_key, adjacency=self._adj, degrees=self._deg,
        )
        self._host_tick += m
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
        """``convergence_metrics`` of the state; with a mesh, the
        reference's sharded bundle (also the version spread and the
        staleness percentiles), reduced over the blocks."""
        if self.mesh is None:
            out = convergence_metrics(self._blocks[0])
        else:
            out = metrics_sample_blocks(self._blocks, self._offsets)
        return {k: v.cpu().numpy() for k, v in out.items()}

    @property
    def tick(self) -> int:
        return int(self._blocks[0].tick)


def _check_state(state: SimState, cfg: SimConfig, device: torch.device | None) -> None:
    """A provided state must hold this config's rung and live on the
    simulator's device (nothing is moved silently; a mesh copies it into
    its blocks, ``device`` None)."""
    want = expected_dtypes(cfg)
    for name, dt in want.items():
        t = getattr(state, name)
        if t.dtype != DTYPES[dt]:
            raise ValueError(f"state.{name} is {t.dtype}, config expects {dt}")
        if device is not None and t.device.type != device.type:
            raise ValueError(f"state.{name} is on {t.device}, expected {device}")
    for name, shape in expected_shapes(cfg).items():
        got = tuple(getattr(state, name).shape)
        if got != shape:
            raise ValueError(f"state.{name} shape {got} != {shape}")
