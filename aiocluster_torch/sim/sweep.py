"""Multi-scenario sweeps: S simulated clusters stepped together over a
lane axis (the port of the reference's ``sim/sweep.py``).

``SweepSimulator(cfg, seeds, ...)`` runs one lane per seed, each with its
own values of the sweepable scalars (``fanout``, ``phi_threshold``,
``writes_per_round``, the fault plan's ``fault_seeds`` and the byzantine
attacker fraction ``byz_frac``; ``SweepParams``). Lane s is
bit-identical to ``Simulator(replace(cfg, <lane values>),
seed=seeds[s])``; a fault seed is ``replace(plan, seed=...)`` and an
attacker fraction the plan with every byzantine entry's attackers at
[0, byz_frac). The lanes'
state is one ``SimState`` with a leading lane axis on the device; each
chunk draws every lane's matchings, churn flips and choice peers in one
batched pass and builds every
lane's salts on the device, and on the pairs forms each sub-exchange is
one lane launch of the pair-fused kernels for all lanes
(``ops.gossip.sweep_step``). Per-lane first-converged ticks accumulate
on the device; the host reads one scalar a chunk. Results come back as a
``SweepResult`` table.

A plan that injects link, crash or byzantine behaviour runs every lane's
round plain, as the reference serves it with XLA
(``counters.fallbacks["fault_plan"]``); cadence classes keep the lane
launches.

``mesh=`` (``parallel.make_mesh``, or ``parallel.multihost.global_mesh``
across processes) holds the lanes as column blocks of the owners, (S, N,
n_local) each (parallel/mesh.py): the lane launches run at each block's
owner offset and every collective reduces per lane over the blocks
(``ops.gossip.sweep_blocks``); each lane equals the unsharded sweep's.

``metrics=`` (an ``obs.MetricsRegistry``) exports each lane's converged
round and version spread (``obs.SweepMetrics``) when the host reads
them; ``save`` / ``resume`` write and read the reference's sweep
checkpoint (sim/checkpoint.py; a mesh's blocks are copied to the host
one at a time).
"""

from __future__ import annotations


import numpy as np
import torch

from ..obs.profiling import span
from ..obs.registry import MetricsRegistry
from ..obs.sim import SweepMetrics
from ..ops import prng
from ..ops.gossip import (
    lane_fanouts,
    lane_salt_table,
    metrics_sample,
    pull_phase_engaged,
    resolve_variant_env,
    run_sweep_rounds,
)
from ..parallel.mesh import (
    Mesh,
    collectives,
    gather_state,
    init_sweep_blocks,
    shard_sweep_state,
    sharded_sweep_metrics_fn,
)
from .checkpoint import load_sweep, refuse_across_processes, save_sweep
from .config import SimConfig
from .state import (
    HEARTBEAT_LIMITS,
    VERSION_LIMITS,
    SimState,
    SweepParams,
    check_lanes,
    init_lanes,
    lane,
)


class SweepResult:
    """Per-lane results table of one sweep (plain host data)."""

    def __init__(
        self,
        *,
        seeds: list[int],
        params: dict[str, list],
        rounds_to_convergence: list[int | None],
        metrics: dict[str, np.ndarray],
    ) -> None:
        self.lanes = len(seeds)
        self.seeds = list(seeds)
        self.params = {k: list(v) for k, v in params.items()}
        self.rounds_to_convergence = list(rounds_to_convergence)
        self.version_spread = np.asarray(metrics["version_spread"]).tolist()
        self.converged_owners = np.asarray(metrics["converged_owners"]).tolist()
        self.mean_fraction = np.asarray(metrics["mean_fraction"]).tolist()
        self.min_fraction = np.asarray(metrics["min_fraction"]).tolist()
        self.alive_count = np.asarray(metrics["alive_count"]).tolist()
        fp = metrics.get("fd_false_positive_fraction")
        self.fd_false_positive_fraction = None if fp is None else np.asarray(fp).tolist()

    def rows(self) -> list[dict]:
        """One dict per lane: the table a bench or CLI prints."""
        out = []
        for s in range(self.lanes):
            row = {
                "lane": s,
                "seed": self.seeds[s],
                "rounds_to_convergence": self.rounds_to_convergence[s],
                "version_spread": self.version_spread[s],
                "converged_owners": self.converged_owners[s],
                "mean_fraction": self.mean_fraction[s],
                "min_fraction": self.min_fraction[s],
                "alive_count": self.alive_count[s],
            }
            if self.fd_false_positive_fraction is not None:
                row["fd_false_positive_fraction"] = self.fd_false_positive_fraction[s]
            for name, values in self.params.items():
                row[name] = values[s]
            out.append(row)
        return out

    def summary(self) -> dict:
        conv = [r for r in self.rounds_to_convergence if r]
        return {
            "lanes": self.lanes,
            "lanes_converged": len(conv),
            "rounds_to_convergence_min": min(conv) if conv else None,
            "rounds_to_convergence_max": max(conv) if conv else None,
            "swept": sorted(self.params),
        }

    def evaluate(self, objective) -> list:
        """``objective(row) -> float | None`` of every lane's row (None: the
        lane is infeasible under the objective)."""
        return [objective(row) for row in self.rows()]

    def best_lane(self, objective) -> tuple[int, float] | None:
        """The feasible lane minimising ``objective`` as ``(lane, score)``,
        or None when no lane is feasible; ties go to the lower lane."""
        best: tuple[int, float] | None = None
        for s, score in enumerate(self.evaluate(objective)):
            if score is not None and (best is None or score < best[1]):
                best = (s, float(score))
        return best


class SweepSimulator:
    """Runs S simulated scenarios together on ``device`` ("cuda" unless
    the caller asks otherwise), or with ``mesh=`` over the mesh's
    devices, the lanes held as column blocks of the owners. ``seeds``
    declares the lanes; ``fanout`` (each <= cfg.fanout),
    ``phi_threshold`` and ``writes_per_round`` give per-lane values, each
    of length S when given. Lane s equals ``Simulator(replace(cfg, <lane
    values>), seed=seeds[s])`` round for round, sharded or not.

    ``states`` is the whole lane-batched state (with a mesh, gathered:
    a copy); ``blocks`` the column blocks as held."""

    def __init__(
        self,
        cfg: SimConfig,
        seeds,
        *,
        fanout=None,
        phi_threshold=None,
        writes_per_round=None,
        fault_seeds=None,
        byz_frac=None,
        mesh: Mesh | None = None,
        chunk: int = 8,
        initial_versions=None,
        states: SimState | None = None,
        metrics: MetricsRegistry | None = None,
        device: str | torch.device | None = None,
    ) -> None:
        self.cfg = cfg = resolve_variant_env(cfg)
        self.chunk = chunk
        self.seeds = [int(s) for s in seeds]
        lanes = len(self.seeds)
        if lanes < 1:
            raise ValueError("need at least one sweep lane (seed)")
        if any(not (0 <= s < 2**32) for s in self.seeds):
            raise ValueError("sweep seeds must be in [0, 2**32)")

        def lane_list(name, values, lo=None, hi=None):
            if values is None:
                return None
            values = list(values)
            if len(values) != lanes:
                raise ValueError(
                    f"{name} must have one value per lane ({len(values)} != {lanes})"
                )
            if lo is not None and any(v < lo for v in values):
                raise ValueError(f"{name} values must be >= {lo}")
            if hi is not None and any(v > hi for v in values):
                raise ValueError(f"{name} values must be <= {hi}")
            return values

        # cfg.fanout is the static sub-exchange bound; lanes at a lower
        # value void their excess sub-exchanges (ops/gossip.sweep_step).
        fanout = lane_list("fanout", fanout, lo=0, hi=cfg.fanout)
        if fanout is not None and cfg.pairing == "choice":
            raise ValueError(
                "fanout sweeps require pairing='matching' or 'permutation' "
                "(sim_step's contract)"
            )
        phi_threshold = lane_list("phi_threshold", phi_threshold)
        if phi_threshold is not None and not cfg.track_failure_detector:
            raise ValueError("phi_threshold sweep requires the failure detector")
        writes_per_round = lane_list("writes_per_round", writes_per_round, lo=0)
        fault_seeds = lane_list("fault_seeds", fault_seeds)
        if fault_seeds is not None and cfg.fault_plan is None:
            raise ValueError("fault_seeds sweep requires cfg.fault_plan")
        byz_frac = lane_list("byz_frac", byz_frac, lo=0.0, hi=1.0)
        if byz_frac is not None and not (
            cfg.fault_plan is not None and cfg.fault_plan.byzantine
        ):
            raise ValueError(
                "byz_frac sweep requires a cfg.fault_plan with byzantine "
                "entries (the lane value overrides their attacker windows)"
            )
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
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
        pull_phase_engaged(cfg, self.device, n_local)  # refuse before allocating

        self.params: dict[str, list] = {}
        for name, values in (
            ("fanout", fanout),
            ("phi_threshold", phi_threshold),
            ("writes_per_round", writes_per_round),
            ("fault_seeds", fault_seeds),
            ("byz_frac", byz_frac),
        ):
            if values is not None:
                self.params[name] = values
        dev = self.device
        self._sweep = SweepParams(
            fanout=None if fanout is None else torch.tensor(fanout, dtype=torch.int64, device=dev),
            phi_threshold=(
                None if phi_threshold is None
                else torch.tensor(phi_threshold, dtype=torch.float32, device=dev)
            ),
            writes_per_round=(
                None if writes_per_round is None
                else torch.tensor(writes_per_round, dtype=torch.int32, device=dev)
            ),
            fault_seed=(
                None if fault_seeds is None
                else torch.tensor([int(v) & 0xFFFFFFFF for v in fault_seeds], dtype=torch.int64)
            ),
            byz_frac=None if byz_frac is None else torch.tensor(byz_frac, dtype=torch.float32),
        )
        # The horizon guard charges the fastest-writing lane.
        self._max_wpr = max(writes_per_round) if writes_per_round else cfg.writes_per_round
        self._keys = prng.keys(self.seeds)
        self._device_keys = self._keys.to(dev)
        run_salts = prng.run_salts(self._keys)
        self._run_salts = run_salts.tolist()
        self._device_run_salts = run_salts.to(dev)
        self._lane_fanout = lane_fanouts(cfg, self._sweep, lanes, dev)
        self._active = None
        if fanout is not None:
            self._active = (
                torch.arange(cfg.fanout, device=dev)[:, None] < self._lane_fanout[None, :]
            )
        if states is not None:
            check_lanes(states, cfg, lanes, None if mesh else dev)
            blocks = [states] if mesh is None else shard_sweep_state(states, mesh)
        elif mesh is None:
            blocks = [init_lanes(cfg, lanes, initial_versions, device=dev)]
        else:
            blocks = init_sweep_blocks(cfg, mesh, lanes, initial_versions)
        self._blocks: list[SimState] = blocks
        self._sharded_metrics = None if mesh is None else sharded_sweep_metrics_fn(mesh)
        states = blocks[0]
        with span("aiocluster_torch.sync"):
            ticks = states.tick.tolist()
            self._known_max_version = int(states.max_version.max())
        if len(set(ticks)) != 1:
            raise ValueError(f"provided states' lanes are at different ticks: {ticks}")
        self._host_tick = ticks[0]
        self._version_base_tick = self._host_tick
        self._first = torch.zeros(lanes, dtype=torch.int32, device=dev)
        self._obs = SweepMetrics(metrics) if metrics is not None else None

    @property
    def lanes(self) -> int:
        return len(self.seeds)

    @property
    def blocks(self) -> list[SimState]:
        """The lanes as held: a mesh's column blocks, in mesh order, or
        the one whole lane-batched state."""
        return self._blocks

    @property
    def states(self) -> SimState:
        """The whole lane-batched state (with a mesh, gathered onto the
        first device: a copy)."""
        if self.mesh is None:
            return self._blocks[0]
        refuse_across_processes(self.mesh)
        return gather_state(self._blocks)

    # -- stepping -------------------------------------------------------------

    def _check_horizon(self, rounds: int) -> None:
        """``Simulator._check_horizon`` with the worst lane's write rate
        (host arithmetic only)."""
        end_tick = self._host_tick + rounds
        cfg = self.cfg
        hb_limit = HEARTBEAT_LIMITS[cfg.heartbeat_dtype]
        if cfg.track_heartbeats and hb_limit < 2**31 and end_tick >= hb_limit:
            raise ValueError(
                f"running to tick {end_tick} overflows {cfg.heartbeat_dtype} heartbeats"
            )
        v_limit = VERSION_LIMITS[cfg.version_dtype]
        if v_limit < 2**31:
            bound = self._known_max_version + self._max_wpr * (
                end_tick - self._version_base_tick
            )
            if bound >= v_limit:
                raise ValueError(
                    f"versions may reach {bound} by tick {end_tick}, overflowing "
                    f"version_dtype='{cfg.version_dtype}' (limit {v_limit})"
                )

    def _run_chunk(self, m: int, tracked: bool) -> None:
        """Queue ``m`` rounds of every lane: the chunk's draws and salts
        in one pass each, then each round (``torch.profiler`` ranges
        ``aiocluster_torch.draws`` / ``aiocluster_torch.sweep_step``);
        tracked, the lanes' first converged ticks accumulate on the
        device."""
        cfg, first_tick = self.cfg, self._host_tick + 1
        with span("aiocluster_torch.draws"):
            draws = prng.chunk_draws(
                self._device_keys, first_tick, m, cfg, alive=self._blocks[0].alive
            )
            salts = lane_salt_table(
                first_tick, m, cfg.fanout, self._lane_fanout, self._device_run_salts
            )
        with collectives(self.mesh):
            self._blocks, first = run_sweep_rounds(
                self._blocks, self._keys, cfg, self._sweep, offsets=self._offsets, m=m,
                tick=self._host_tick, draws=draws, salts=salts, run_salts=self._run_salts,
                active=self._active, first=self._first if tracked else None,
            )
        self._host_tick += m
        if tracked:
            self._first = first

    def run(self, rounds: int) -> None:
        """Advance every lane by a fixed number of gossip rounds."""
        self._check_horizon(rounds)
        done = 0
        while done < rounds:
            m = min(self.chunk, rounds - done)
            self._run_chunk(m, tracked=False)
            done += m

    def run_until_converged(self, max_rounds: int = 100_000) -> list[int | None]:
        """Step all lanes until each has held full convergence once (or
        ``max_rounds`` elapsed); returns each lane's EXACT first converged
        round (None: never converged). One host sync a chunk."""
        conv0 = self.metrics()["all_converged"]
        if conv0.any():
            with span("aiocluster_torch.sync"):
                first = self._first.cpu().numpy().copy()
            mask = (first == 0) & conv0
            first[mask] = self._host_tick
            self._first = torch.from_numpy(first).to(self.device)
        while self._host_tick < max_rounds:
            with span("aiocluster_torch.sync"):
                done = bool((self._first != 0).all())
            if done:
                break
            m = min(self.chunk, max_rounds - self._host_tick)
            self._check_horizon(m)
            self._run_chunk(m, tracked=True)
        with span("aiocluster_torch.sync"):
            first = self._first.tolist()
        out = [int(f) if f else None for f in first]
        if self._obs is not None:
            self._obs.update(out)
        return out

    # -- observation ----------------------------------------------------------

    def metrics(self) -> dict[str, np.ndarray]:
        """Per-lane convergence metrics, version spread and staleness
        percentiles: a dict of (S,) host arrays. On a mesh, the
        reference's sharded bundle: each lane's convergence metrics and
        version spread, reduced over the blocks."""
        if self._sharded_metrics is not None:
            sample = self._sharded_metrics(self._blocks)
        else:
            lanes = [metrics_sample(lane(self._blocks[0], s)) for s in range(self.lanes)]
            sample = {k: torch.stack([m[k] for m in lanes]) for k in lanes[0]}
        with span("aiocluster_torch.sync"):
            return {k: v.cpu().numpy() for k, v in sample.items()}

    def result(self) -> SweepResult:
        """The per-lane results table at the current state
        (rounds-to-convergence as ``run_until_converged`` has seen it)."""
        with span("aiocluster_torch.sync"):
            first = self._first.tolist()
        rounds = [int(f) if f else None for f in first]
        metrics = self.metrics()
        if self._obs is not None:
            self._obs.update(rounds, metrics["version_spread"])
        return SweepResult(
            seeds=self.seeds, params=self.params, rounds_to_convergence=rounds,
            metrics=metrics,
        )

    @property
    def tick(self) -> int:
        return self._host_tick

    # -- checkpoint / resume --------------------------------------------------

    def save(self, path) -> None:
        """Checkpoint all lanes (copied to the host; a mesh's blocks one at
        a time), plus the seeds, the sweep values and the convergence
        accumulator."""
        if self.mesh is not None:
            refuse_across_processes(self.mesh)
        save_sweep(path, self._blocks, self.cfg, seeds=self.seeds, params=self.params,
                   first=self._first, host_tick=self._host_tick)

    @classmethod
    def resume(
        cls,
        path,
        *,
        mesh: Mesh | None = None,
        chunk: int = 8,
        metrics: MetricsRegistry | None = None,
        device: str | torch.device | None = None,
    ) -> "SweepSimulator":
        """Continue a checkpointed sweep (either package's file) on any
        layout: ``device`` (the card unless asked), or a mesh's column
        blocks; lane randomness is keyed by (seed, tick), like the
        single-scenario resume."""
        if mesh is not None and device is not None:
            raise ValueError("a mesh places its blocks: list its devices, not device=")
        where = mesh.devices[0] if mesh is not None else ("cuda" if device is None else device)
        states, cfg, meta = load_sweep(path, device=where)
        params = meta["params"]
        sim = cls(
            cfg, meta["seeds"], fanout=params.get("fanout"),
            phi_threshold=params.get("phi_threshold"),
            writes_per_round=params.get("writes_per_round"),
            fault_seeds=params.get("fault_seeds"), byz_frac=params.get("byz_frac"),
            mesh=mesh, chunk=chunk, states=states, metrics=metrics,
            device=None if mesh is not None else where,
        )
        sim._first = torch.as_tensor(meta["first"], dtype=torch.int32).to(sim.device)
        sim._host_tick = int(meta["host_tick"])
        # The guard charges writes only for ticks run since the
        # checkpoint: its max_version already holds its past writes.
        sim._version_base_tick = sim._host_tick
        return sim
