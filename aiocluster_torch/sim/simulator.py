"""Host-side runner of the PyTorch gossip simulator.

Keeps the SimState resident on its device (or, with ``mesh=``, as column
blocks of the owners over a mesh's devices: parallel/mesh.py) and steps
it in chunks of rounds: the draws of a whole chunk (the matchings or
permutations, the churn flips, the choice peers: ``prng.chunk_draws``)
are computed on the device in one batched pass, each
round's kernels are queued without a host sync, and convergence is
polled once per chunk — the counterpart of the reference's jit-compiled
chunks.

Telemetry (``metrics=`` a ``obs.MetricsRegistry``, ``trace_writer=`` a
``obs.TraceWriter``) samples ``gossip.metrics_sample`` every
``metrics_stride`` rounds at chunk boundaries as device tensors, and
converts them once at ``flush_metrics``: no host sync in the loop.
``save`` / ``resume`` go through sim/checkpoint.py's ``.npz`` container,
the reference's.
"""

from __future__ import annotations

import numpy as np
import torch

from ..obs.registry import MetricsRegistry
from ..obs.sim import SimMetrics
from ..obs.trace import TraceWriter
from ..ops import prng
from ..ops.gossip import (
    metrics_sample_blocks,
    pull_phase_engaged,
    resolve_variant_env,
    row_blocks,
    run_rounds,
)
from ..parallel.mesh import Mesh, gather_state, init_blocks, shard_state
from .bytes import state_bytes
from .checkpoint import load_state, save_state
from .config import SimConfig
from .packed import live_view_bool, watermarks_i32
from .state import (
    DTYPES,
    HEARTBEAT_LIMITS,
    VERSION_LIMITS,
    SimState,
    expected_dtypes,
    expected_shapes,
    init_state,
    state_n_local,
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
    every matrix on the first device); setting it replaces the state
    (re-sharded onto the blocks on a mesh). ``blocks`` are the column
    blocks as held (one block, the state itself, without a mesh).

    ``initial_versions`` gives each owner's starting version count;
    ``trace=True`` appends a row of metrics to ``trace`` each chunk (a
    sync each); ``metrics`` / ``trace_writer`` turn on the stride
    sampler (``obs.SimMetrics``, every ``metrics_stride`` rounds).
    ``AIOCLUSTER_TPU_PALLAS_VARIANT`` steers an "auto" kernel variant
    (``gossip.resolve_variant_env``): read provenance from ``sim.cfg``."""

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
        initial_versions=None,
        trace: bool = False,
        metrics: MetricsRegistry | None = None,
        metrics_stride: int = 64,
        trace_writer: TraceWriter | None = None,
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
        self.cfg = cfg = resolve_variant_env(cfg)
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
            blocks = [init_state(cfg, initial_versions, device=self.device)]
        else:
            blocks = init_blocks(cfg, mesh, initial_versions)
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
        # _version_base_tick stays at the tick read here, so the bound
        # charges writes only for ticks run since (a resumed state's
        # max_version already holds its past writes).
        self._known_max_version = int(head.max_version.max())
        self._host_tick = int(head.tick)
        self._version_base_tick = self._host_tick
        self._trace_enabled = trace
        self.trace: list[dict[str, float]] = []
        # The stride sampler buffers device tensors at chunk boundaries
        # and converts them only at flush_metrics(); start_tick anchors
        # its rounds counter for a resumed state.
        self._obs: SimMetrics | None = None
        if metrics is not None or trace_writer is not None:
            self._obs = SimMetrics(
                metrics, trace_writer, stride=metrics_stride,
                start_tick=self._host_tick, writes_per_round=cfg.writes_per_round,
            )
            self._obs.set_state_bytes(state_bytes(cfg))

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

    @state.setter
    def state(self, state: SimState) -> None:
        """Replace the whole state (checked against the config's rung; on
        a mesh, re-sharded onto the blocks). It must be at the
        simulator's tick: the host tick is not re-read. Callers that
        raise max_version report it (``note_max_version_increase``)."""
        _check_state(state, self.cfg, None if self.mesh else self.device)
        self._blocks = [state] if self.mesh is None else shard_state(state, self.mesh)

    def _owners(self, k: int) -> torch.Tensor:
        """The global owner ids of block ``k``'s columns."""
        blk = self._blocks[k]
        return self._offsets[k] + torch.arange(state_n_local(blk), device=blk.w.device)

    def watermark(self, observer: int, owner: int) -> int:
        """``observer``'s watermark on ``owner``, read from the block that
        holds the owner (no gathered copy; one small sync)."""
        k = max(i for i, off in enumerate(self._offsets) if off <= owner)
        row = watermarks_i32(self._blocks[k], self._owners(k), rows=slice(observer, observer + 1))
        return int(row[0, owner - self._offsets[k]])

    def column_minima(self) -> np.ndarray:
        """(N,) int64: each owner's smallest watermark over every observer
        (its own diagonal included), read block by block."""
        parts = []
        for k, blk in enumerate(self._blocks):
            owners = self._owners(k)
            lo = torch.full(owners.shape, torch.iinfo(torch.int32).max, dtype=torch.int32,
                            device=owners.device)
            for r0, r1 in row_blocks(self.cfg.n_nodes, owners.shape[0]):
                lo = torch.minimum(lo, watermarks_i32(blk, owners, rows=slice(r0, r1)).amin(dim=0))
            parts.append(lo.cpu())
        return torch.cat(parts).numpy().astype(np.int64)

    def live_row(self, observer: int) -> np.ndarray:
        """(N,) bool: ``observer``'s live view of every owner, unpacked
        block by block."""
        return torch.cat([
            live_view_bool(b, rows=slice(observer, observer + 1))[0].cpu() for b in self._blocks
        ]).numpy()

    # -- stepping -------------------------------------------------------------

    def note_max_version_increase(self, delta: int) -> None:
        """Host-side writers that raise ``max_version`` directly on the
        state (SimCluster's write flush) report the largest per-node
        bump here so the narrow rungs' horizon guard stays sound."""
        self._known_max_version += int(delta)

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
        self._maybe_sample()
        if self._trace_enabled:
            self._record_trace()
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

    def _sample(self) -> dict[str, torch.Tensor]:
        """The metrics bundle as device tensors (no sync): the
        convergence metrics, the version spread and the staleness
        percentiles, reduced over the blocks on a mesh."""
        return metrics_sample_blocks(self._blocks, self._offsets)

    def _maybe_sample(self) -> None:
        if self._obs is not None and self._obs.due(self._host_tick):
            self._obs.record(self._host_tick, self._sample())

    def flush_metrics(self) -> list[dict]:
        """Convert the buffered samples (one transfer), update the
        registry's gauges, emit the trace events; returns the sampled
        series ([] without telemetry). The series is closed at the
        run's current tick."""
        if self._obs is None:
            return []
        if self._obs.last_tick != self._host_tick:
            self._obs.record(self._host_tick, self._sample())
        return self._obs.flush()

    def _record_trace(self) -> None:
        m = self.metrics()
        self.trace.append({
            "tick": float(self._host_tick),
            "converged_owners": float(m["converged_owners"]),
            "min_fraction": float(m["min_fraction"]),
            "mean_fraction": float(m["mean_fraction"]),
            "alive_count": float(m["alive_count"]),
        })

    def metrics(self) -> dict[str, np.ndarray]:
        """The metrics bundle on the host: ``convergence_metrics``, the
        version spread and the staleness percentiles (the reference's
        ``_metrics_sample``), reduced over the blocks on a mesh."""
        return {k: v.cpu().numpy() for k, v in self._sample().items()}

    @property
    def tick(self) -> int:
        return int(self._blocks[0].tick)

    # -- checkpoint / resume ---------------------------------------------------

    def save(self, path) -> None:
        """Checkpoint the state (with a mesh, copied to the host one
        column block at a time), plus the seed and the topology flag
        needed to continue the trajectory."""
        save_state(path, self._blocks, self.cfg, seed=self.seed,
                   has_topology=self._adj is not None)

    @classmethod
    def resume(
        cls,
        path,
        *,
        seed: int | None = None,
        mesh: Mesh | None = None,
        topology=None,
        chunk: int = 8,
        trace: bool = False,
        device: str | torch.device | None = None,
    ) -> "Simulator":
        """Continue a checkpointed run (either package's file) on any
        layout: ``device`` (the card unless asked), or a mesh's column
        blocks; the round's randomness depends only on (seed, tick). The
        stored seed is used unless overridden."""
        if mesh is not None and device is not None:
            raise ValueError("a mesh places its blocks: list its devices, not device=")
        where = mesh.devices[0] if mesh is not None else ("cuda" if device is None else device)
        state, cfg, meta = load_state(path, device=where)
        if meta["has_topology"] and topology is None:
            raise ValueError(
                "checkpoint was taken with a topology; pass the same "
                "topology to resume (adjacency is not persisted)"
            )
        return cls(
            cfg, seed=meta["seed"] if seed is None else seed, mesh=mesh, topology=topology,
            chunk=chunk, trace=trace, state=state, device=None if mesh is not None else where,
        )


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
