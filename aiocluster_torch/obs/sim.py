"""Simulator instrumentation: stride-sampled, deferred-sync metrics (the
port of the reference's ``obs/sim.py``).

The simulator's hot loop never pays a device-to-host sync for
telemetry (one sync per round would serialise the host and the card).
The contract:

- ``due(tick)`` decides on the host, from tick arithmetic alone, whether
  this chunk boundary is a sample point (every ``stride`` rounds).
- ``record(tick, sample)`` takes the sample's metrics as *device
  tensors* (``gossip.metrics_sample``) and buffers them. Nothing is
  converted, so the queued kernels stay asynchronous.
- ``flush()`` converts everything buffered with one transfer (every
  buffered scalar stacked as float64, then one ``.cpu()``), pushes the
  latest values into the registry gauges, emits
  one ``sim_round`` trace event per sample, and returns the series as
  plain dicts.

Wall-clock: ``record`` stamps ``perf_counter`` at dispatch time, so the
per-round wall time derived between consecutive samples measures the
asynchronous dispatch cadence; over a steady run backpressure makes it
converge on the device's time a round.

The engine label is ``"torch"``. The fallback gauge reads the deltas of
``ops.counters.fallbacks``, which counts rounds (the reference's ledger
counts traced configs). The reference's compiled-chunk cache gauge has
no counterpart: the port compiles no chunk.
"""

from __future__ import annotations

import time

import torch

from ..ops import counters
from .profiling import span
from .registry import MetricsRegistry
from .trace import TraceWriter

# Percentiles the staleness tensor is compressed to: THE single source
# for both the sampler keys (``staleness_p<label>``, computed on the
# device by ops.gossip.staleness_percentiles, which imports this) and
# the ``aiocluster_sim_staleness_rounds{pct=}`` gauge export below.
# "100" is the max — version_spread in round units.
STALENESS_PCTS = (("50", 0.50), ("99", 0.99), ("100", 1.0))

ENGINE = "torch"

_SAMPLE_GAUGES = (
    ("aiocluster_sim_tick", "Current simulated gossip round"),
    ("aiocluster_sim_mean_fraction", "Mean replicated fraction over alive pairs"),
    ("aiocluster_sim_min_fraction", "Worst replicated fraction over alive pairs"),
    ("aiocluster_sim_converged_owners", "Owners fully replicated to all alive nodes"),
    ("aiocluster_sim_alive_nodes", "Nodes currently alive in the simulation"),
    ("aiocluster_sim_version_spread", "Worst key-version lag over alive pairs"),
    (
        "aiocluster_sim_fd_false_positive_fraction",
        "Alive off-diagonal pairs the observer believes dead "
        "(FD liveness quality; present when the FD is tracked)",
    ),
)

# Sample key -> the gauge the latest sample sets.
_GAUGE_OF = (
    ("tick", "aiocluster_sim_tick"),
    ("mean_fraction", "aiocluster_sim_mean_fraction"),
    ("min_fraction", "aiocluster_sim_min_fraction"),
    ("converged_owners", "aiocluster_sim_converged_owners"),
    ("alive_count", "aiocluster_sim_alive_nodes"),
    ("version_spread", "aiocluster_sim_version_spread"),
    ("fd_false_positive_fraction", "aiocluster_sim_fd_false_positive_fraction"),
)


class SimMetrics:
    """Stride sampler + registry/trace bridge for one simulator run."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        trace: TraceWriter | None = None,
        stride: int = 64,
        engine: str = ENGINE,
        bytes_per_kv: float = 35.0,
        start_tick: int = 0,
        writes_per_round: int = 0,
    ) -> None:
        if stride < 1:
            raise ValueError("metrics stride must be >= 1")
        # No registry -> a PRIVATE one (trace-only runs), never the
        # process default: a study must not inject stale series into a
        # registry some other component reads.
        self.registry = registry if registry is not None else MetricsRegistry()
        self.trace = trace
        self.stride = stride
        self.engine = engine
        # Wire cost of one replicated key-version for the delta-bytes
        # ESTIMATE (the headline workload's 8-byte keys/values under
        # proto3 framing, as in the reference).
        self.bytes_per_kv = bytes_per_kv
        self._gauges = {
            name: self.registry.gauge(name, help_text, labels=("engine",)).labels(engine)
            for name, help_text in _SAMPLE_GAUGES
        }
        self._rounds = self.registry.counter(
            "aiocluster_sim_rounds_total",
            "Simulated gossip rounds advanced",
            labels=("engine",),
        ).labels(engine)
        self._step_seconds = self.registry.histogram(
            "aiocluster_sim_step_seconds",
            "Per-round wall time, derived between metric samples",
            labels=("engine",),
            buckets=(1e-5, 1e-4, 1e-3, 0.01, 0.1, 1.0, 10.0),
        ).labels(engine)
        self._delta_kvs = self.registry.counter(
            "aiocluster_sim_delta_key_versions_total",
            "Key-versions replicated by gossip (sampled between windows)",
            labels=("engine",),
        ).labels(engine)
        self._delta_bytes = self.registry.counter(
            "aiocluster_sim_delta_bytes_total",
            "Estimated delta bytes moved (key-versions x wire cost)",
            labels=("engine",),
        ).labels(engine)
        # Staleness normalization: the staleness tensor counts
        # key-versions behind; at a steady write rate of w versions per
        # owner per round, lag/w IS rounds-behind (w <= 1 leaves the raw
        # lag). A host-side divide at flush, so the device values stay
        # exact integers.
        self._staleness_scale = max(int(writes_per_round), 1)
        self._staleness = self.registry.gauge(
            "aiocluster_sim_staleness_rounds",
            "Fleet staleness distribution: per-node rounds-behind-"
            "owner-max-version (the staleness tensor's nearest-rank "
            "percentile; pct=100 is the max — version_spread in round "
            "units)",
            labels=("engine", "pct"),
        )
        self._state_bytes = self.registry.gauge(
            "aiocluster_sim_state_bytes",
            "Planned resident SimState bytes for this run's memory-"
            "ladder rung (sim.bytes.state_bytes; set once at construction)",
            labels=("engine",),
        ).labels(engine)
        self._fallback_rounds = self.registry.gauge(
            "aiocluster_sim_pallas_fallbacks",
            "Rounds that asked for the kernels but ran a phase as plain "
            "PyTorch ops, by reason: the deltas of ops.counters.fallbacks "
            "(one count a round) since this sampler was constructed, "
            "exported at flush, so an earlier run in the process cannot "
            "masquerade as this run's; deliberately NOT engine-labelled",
            labels=("reason",),
        )
        self._fallbacks_base = dict(counters.fallbacks)
        self._pending: list[tuple[int, float, dict]] = []
        # Rounds run before the sampler existed (a resumed checkpoint's
        # tick) must not inflate the rounds counter at the first sample.
        self._start_tick = start_tick
        self._last_tick: int | None = None
        self.samples: list[dict] = []

    @property
    def last_tick(self) -> int | None:
        """Tick of the most recent sample (None before the first): the
        the simulator uses it to close the series at the run's final state."""
        return self._last_tick

    def set_state_bytes(self, n: int) -> None:
        """Simulator hook: the run's planned resident state bytes (host
        arithmetic only)."""
        self._state_bytes.set(n)

    def _export_fallbacks(self) -> None:
        """Mirror the fallback counts into the labelled gauge as deltas
        against the construction-time snapshot (max(0): a
        ``counters.reset()`` in between reads as no new fallback)."""
        for reason, count in counters.fallbacks.items():
            delta = count - self._fallbacks_base.get(reason, 0)
            self._fallback_rounds.labels(reason).set(max(delta, 0))

    def due(self, tick: int) -> bool:
        """Host-side stride gate: true when ``tick`` crossed into a new
        stride window since the last sample (chunked steppers land on
        chunk boundaries, so "crossed" rather than "equals a multiple")."""
        if self._last_tick is None:
            return True
        return tick // self.stride > self._last_tick // self.stride

    def record(self, tick: int, sample: dict) -> None:
        """Buffer one sample. ``sample`` values are device tensors (or
        host numbers); they are NOT converted here."""
        now = time.perf_counter()
        prev = self._start_tick if self._last_tick is None else self._last_tick
        if tick > prev:
            self._rounds.inc(tick - prev)
        self._pending.append((tick, now, dict(sample)))
        self._last_tick = tick

    def _convert_pending(self) -> list[list[float]]:
        """Every buffered sample's values as host floats, in one transfer
        (float64 holds each float32 value and each count exactly)."""
        vals = [torch.as_tensor(v) for _, _, raw in self._pending for v in raw.values()]
        if not vals:
            return [[] for _ in self._pending]
        dev = vals[0].device
        stacked = torch.stack([v.to(dev, torch.float64).reshape(()) for v in vals])
        with span("aiocluster_torch.sync"):
            flat = stacked.cpu().tolist()
        out, i = [], 0
        for _, _, raw in self._pending:
            out.append(flat[i : i + len(raw)])
            i += len(raw)
        return out

    def flush(self) -> list[dict]:
        """Convert buffered samples (the one deliberate sync), update
        gauges to the latest values, emit trace events, and return the
        full series accumulated so far."""
        prev_tick = prev_wall = prev_kv = None
        if self.samples:
            prev_tick = self.samples[-1]["tick"]
            prev_wall = self.samples[-1]["_wall"]
            prev_kv = self.samples[-1].get("kv_known")
        for (tick, wall, raw), values in zip(self._pending, self._convert_pending()):
            sample = {"tick": int(tick), "_wall": wall}
            sample.update(zip(raw.keys(), values))
            if prev_tick is not None and tick > prev_tick:
                per_round = (wall - prev_wall) / (tick - prev_tick)
                sample["step_seconds"] = round(per_round, 9)
                self._step_seconds.observe(per_round)
            kv = sample.get("kv_known")
            if kv is not None and prev_kv is not None:
                moved = max(kv - prev_kv, 0.0)
                sample["delta_key_versions"] = moved
                sample["delta_bytes_est"] = round(moved * self.bytes_per_kv)
                self._delta_kvs.inc(moved)
                self._delta_bytes.inc(moved * self.bytes_per_kv)
            prev_kv = kv if kv is not None else prev_kv
            prev_tick, prev_wall = tick, wall
            self.samples.append(sample)
            if self.trace is not None:
                self.trace.emit(
                    "sim_round",
                    engine=self.engine,
                    **{k: v for k, v in sample.items() if k != "_wall"},
                )
        self._pending.clear()
        if self.samples:
            last = self.samples[-1]
            for short, gauge in _GAUGE_OF:
                if short in last:
                    self._gauges[gauge].set(last[short])
            for pct, _ in STALENESS_PCTS:
                key = f"staleness_p{pct}"
                if key in last:
                    self._staleness.labels(self.engine, pct).set(
                        last[key] / self._staleness_scale
                    )
        self._export_fallbacks()
        return [{k: v for k, v in s.items() if k != "_wall"} for s in self.samples]


def _owner_column(state, owner: int) -> torch.Tensor:
    """(N,) int32: every observer's watermark on ``owner`` (the packed
    rung decoded from its byte column alone)."""
    from ..sim.packed import is_packed_w, unpack_u4

    if is_packed_w(state.w):
        r = unpack_u4(state.w[:, owner // 2 : owner // 2 + 1])[:, owner % 2]
        return state.max_version[owner].to(torch.int32) - r
    return state.w[:, owner].to(torch.int32)


def marked_write_state(cfg, owner: int = 0, *, device="cuda"):
    """A fully converged fleet the instant after ``owner`` published ONE
    new version: the sim-side analogue of a marked write on a settled
    fleet.

    Built from ``init_state`` (heartbeats/FD fields at their boot
    values) with the watermark matrix overridden to full convergence at
    the old versions and ``max_version[owner]`` bumped by one. Supports
    every rung: the packed u4 residual form is residual 0 everywhere
    except the owner's column (one version behind off-diagonal)."""
    from ..sim.packed import pack_u4
    from ..sim.state import DTYPES, VERSION_LIMITS, init_state

    n = cfg.n_nodes
    if not 0 <= owner < n:
        raise ValueError(f"owner {owner} outside [0, {n})")
    keys = cfg.keys_per_node
    if keys + 1 >= VERSION_LIMITS[cfg.version_dtype]:
        raise ValueError(
            f"marked write would overflow version_dtype="
            f"{cfg.version_dtype} (keys_per_node={keys})"
        )
    state = init_state(cfg, device=device)
    dev = state.w.device
    mv = torch.full((n,), keys, dtype=torch.int32, device=dev)
    mv[owner] += 1
    if cfg.version_dtype == "u4r":
        # Residual space: converged = 0; the marked write leaves every
        # non-owner observer exactly one version behind the owner.
        idx = torch.arange(n, device=dev)
        col = idx[None, :] == owner
        row = idx[:, None] == owner
        w = pack_u4((col & ~row).to(torch.int32))
    else:
        w = torch.full((n, n), keys, dtype=DTYPES[cfg.version_dtype], device=dev)
        w[owner, owner] = keys + 1
    return state.replace(w=w, max_version=mv)


def wavefront_series(
    cfg,
    *,
    owner: int = 0,
    seed: int = 0,
    max_rounds: int = 512,
    threshold: float = 0.99,
    device="cuda",
) -> dict:
    """The marked write's epidemic wavefront: fraction of alive nodes
    that see owner's new version, measured after EVERY round, so twin
    comparisons line up *curves*, not just convergence round counts.

    A study helper, not a hot loop: it steps a chunk=1 Simulator and
    syncs one (N,) column per round. Returns ``{"fractions": [...],
    "rounds_to_threshold": r | None, "threshold": t}`` where
    ``fractions[k]`` is visibility after k rounds (``fractions[0]`` is
    the pre-gossip state: just the owner)."""
    from ..sim.simulator import Simulator

    if not 0.0 < threshold <= 1.0:
        raise ValueError("threshold must be in (0, 1]")
    state = marked_write_state(cfg, owner, device=device)
    sim = Simulator(cfg, seed=seed, chunk=1, state=state, device=device)
    target = int(cfg.keys_per_node) + 1

    def fraction() -> float:
        st = sim.state
        seen = (_owner_column(st, owner) >= target) & st.alive
        counts = torch.stack([seen.sum(), st.alive.sum()]).tolist()
        return float(counts[0]) / float(max(counts[1], 1))

    fractions = [fraction()]
    rounds_to_threshold = None
    for rnd in range(1, max_rounds + 1):
        sim.run(1)
        fractions.append(fraction())
        if fractions[-1] >= threshold:
            rounds_to_threshold = rnd
            break
    return {
        "fractions": fractions,
        "rounds_to_threshold": rounds_to_threshold,
        "threshold": threshold,
    }


class SweepMetrics:
    """Per-lane gauges for one multi-scenario sweep (sim/sweep.py).

    The sweep's hot loop never syncs for telemetry; this bridge is fed
    host-side values at result time (one conversion of each lane-axis
    array, never a per-lane ``int(x[lane])`` loop)."""

    def __init__(
        self,
        registry: MetricsRegistry | None = None,
        engine: str = ENGINE,
    ) -> None:
        self.registry = registry if registry is not None else MetricsRegistry()
        self.engine = engine
        self._lanes = self.registry.gauge(
            "aiocluster_sim_sweep_lanes",
            "Scenario lanes in the current sweep",
            labels=("engine",),
        ).labels(engine)
        self._lanes_converged = self.registry.gauge(
            "aiocluster_sim_sweep_lanes_converged",
            "Sweep lanes whose convergence tick has been observed",
            labels=("engine",),
        ).labels(engine)
        self._lane_rounds = self.registry.gauge(
            "aiocluster_sim_lane_rounds_to_convergence",
            "First round at which the lane held full convergence "
            "(absent until observed)",
            labels=("engine", "lane"),
        )
        self._lane_spread = self.registry.gauge(
            "aiocluster_sim_lane_version_spread",
            "Worst key-version lag over alive pairs, per sweep lane",
            labels=("engine", "lane"),
        )

    def update(self, rounds_to_convergence, version_spread=None) -> None:
        """Push per-lane series (host values: lists/np arrays; None or 0
        rounds = lane not converged yet)."""
        rounds = list(rounds_to_convergence)
        self._lanes.set(len(rounds))
        self._lanes_converged.set(sum(1 for r in rounds if r))
        for lane, r in enumerate(rounds):
            if r:
                self._lane_rounds.labels(self.engine, str(lane)).set(float(r))
        if version_spread is not None:
            for lane, s in enumerate(list(version_spread)):
                self._lane_spread.labels(self.engine, str(lane)).set(float(s))
