"""Multi-scenario sweeps: S simulated clusters stepped together over a
lane axis (the port of the reference's ``sim/sweep.py``).

``SweepSimulator(cfg, seeds, ...)`` runs one lane per seed, each with its
own values of the sweepable scalars (``fanout``, ``phi_threshold``,
``writes_per_round``; ``SweepParams``). Lane s is bit-identical to
``Simulator(replace(cfg, <lane values>), seed=seeds[s])``. The lanes'
state is one ``SimState`` with a leading lane axis on the device; each
chunk draws every lane's matchings in one batched pass and builds every
lane's salts on the device, and on the pairs forms each sub-exchange is
one lane launch of the pair-fused kernels for all lanes
(``ops.gossip.sweep_step``). Per-lane first-converged ticks accumulate
on the device; the host reads one scalar a chunk. Results come back as a
``SweepResult`` table.

Not ported yet, refused by name: ``mesh=`` (ROADMAP.md A15),
``metrics=`` (A18), ``save`` / ``resume`` (A12). ``fault_seeds=`` and
``byz_frac=`` raise the reference's own errors, since the port's config
carries no fault plan (A10).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.profiler import record_function

from ..ops import counters, prng
from ..ops.gossip import (
    lane_fanouts,
    lane_salt_table,
    metrics_sample,
    pull_phase_engaged,
    sweep_step,
)
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
    the caller asks otherwise). ``seeds`` declares the lanes; ``fanout``
    (each <= cfg.fanout), ``phi_threshold`` and ``writes_per_round`` give
    per-lane values, each of length S when given. Lane s equals
    ``Simulator(replace(cfg, <lane values>), seed=seeds[s])`` round for
    round."""

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
        mesh=None,
        chunk: int = 8,
        initial_versions=None,
        states: SimState | None = None,
        metrics=None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.cfg = cfg
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
        if lane_list("fault_seeds", fault_seeds) is not None:
            raise ValueError("fault_seeds sweep requires cfg.fault_plan")
        if lane_list("byz_frac", byz_frac, lo=0.0, hi=1.0) is not None:
            raise ValueError(
                "byz_frac sweep requires a cfg.fault_plan with byzantine "
                "entries (the lane value overrides their attacker windows)"
            )
        if mesh is not None:
            counters.refuse(
                "sweeps over a mesh are not ported yet: ROADMAP.md A15 (multi-GPU)"
            )
        if metrics is not None:
            counters.refuse(
                "SweepSimulator(metrics=) is not ported yet: ROADMAP.md A18 "
                "(the telemetry surface)"
            )
        if chunk < 1:
            raise ValueError("chunk must be >= 1")
        self.device = torch.device(device)
        pull_phase_engaged(cfg, self.device)  # refuse before allocating

        self.params: dict[str, list] = {}
        for name, values in (
            ("fanout", fanout),
            ("phi_threshold", phi_threshold),
            ("writes_per_round", writes_per_round),
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
        if states is None:
            states = init_lanes(cfg, lanes, initial_versions, device=dev)
        else:
            check_lanes(states, cfg, lanes, dev)
        self.states: SimState = states
        ticks = states.tick.tolist()
        if len(set(ticks)) != 1:
            raise ValueError(f"provided states' lanes are at different ticks: {ticks}")
        self._host_tick = ticks[0]
        self._version_base_tick = self._host_tick
        self._known_max_version = int(states.max_version.max())
        self._first = torch.zeros(lanes, dtype=torch.int32, device=dev)

    @property
    def lanes(self) -> int:
        return len(self.seeds)

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
        with record_function("aiocluster_torch.draws"):
            gm, c, p = prng.round_draws(
                self._device_keys, first_tick, m, cfg.n_nodes, cfg.fanout
            )
            salts = lane_salt_table(
                first_tick, m, cfg.fanout, self._lane_fanout, self._device_run_salts
            )
        for r in range(m):
            with record_function("aiocluster_torch.sweep_step"):
                out = sweep_step(
                    self.states, self._keys, cfg, self._sweep, tick=self._host_tick,
                    draws=(gm[r], c[r], p[r]), salts=salts[r], run_salts=self._run_salts,
                    active=self._active, return_converged=tracked,
                )
            self._host_tick += 1
            if tracked:
                self.states, conv = out
                self._first = torch.where(
                    (self._first == 0) & conv, self._host_tick, self._first
                )
            else:
                self.states = out

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
            first = self._first.cpu().numpy().copy()
            mask = (first == 0) & conv0
            first[mask] = self._host_tick
            self._first = torch.from_numpy(first).to(self.device)
        while self._host_tick < max_rounds:
            if bool((self._first != 0).all()):
                break
            m = min(self.chunk, max_rounds - self._host_tick)
            self._check_horizon(m)
            self._run_chunk(m, tracked=True)
        return [int(f) if f else None for f in self._first.tolist()]

    # -- observation ----------------------------------------------------------

    def metrics(self) -> dict[str, np.ndarray]:
        """Per-lane convergence metrics, version spread and staleness
        percentiles: a dict of (S,) host arrays."""
        samples = [metrics_sample(lane(self.states, s)) for s in range(self.lanes)]
        return {
            k: torch.stack([m[k] for m in samples]).cpu().numpy() for k in samples[0]
        }

    def result(self) -> SweepResult:
        """The per-lane results table at the current state
        (rounds-to-convergence as ``run_until_converged`` has seen it)."""
        rounds = [int(f) if f else None for f in self._first.tolist()]
        return SweepResult(
            seeds=self.seeds, params=self.params, rounds_to_convergence=rounds,
            metrics=self.metrics(),
        )

    @property
    def tick(self) -> int:
        return self._host_tick

    # -- checkpoint / resume --------------------------------------------------

    def save(self, path) -> None:
        counters.refuse("sweep checkpoints (save/resume) are not ported yet: ROADMAP.md A12")

    @classmethod
    def resume(cls, path, **kwargs) -> "SweepSimulator":
        counters.refuse("sweep checkpoints (save/resume) are not ported yet: ROADMAP.md A12")
