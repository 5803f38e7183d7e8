"""Replay: lift a recorded runtime trace into the deterministic simulator
(the port of the reference's ``twin/replay.py``).

A twin-grade trace holds one ``twin_node`` record per member and one
``twin_round`` record per initiated round (docs/twin.md spells the
contract; the reference's runtime records them). This module is the
consuming side:

- ``load_runtime_trace`` reads the JSONL tolerantly (a trace from a
  crashed process has a torn tail, and that trace is the one most worth
  replaying), checks the ``trace_header`` schema loudly, groups
  ``twin_round`` events by node, and aligns them into a fleet-wide
  per-round table by each node's own round index.
- ``lift_sim_config`` derives the ``SimConfig`` the trace implies:
  fleet size from the ``twin_node`` records, fanout from the advertised
  ``gossip_count``, phi from the FD config, one tick per gossip round.
- ``replay`` runs that config through the port's ``Simulator`` (chunk=1,
  stride-1 sampling: one metrics row per round) and returns the aligned
  (runtime, sim) round-by-round table the calibrator fits
  (twin/calibrate.py).

Alignment is by ROUND INDEX, not wall-clock: one sim tick models one
fleet-wide gossip round, while runtime members tick on their own
(jittered) intervals, so round r of the table aggregates every node's
r-th initiated round against the sim state after r+1 ticks.

``replay`` and ``wavefront_prediction`` run on the CUDA card unless the
caller passes ``device="cpu"``.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field
from pathlib import Path

from ..obs.trace import TRACE_SCHEMA, scan_trace
from ..sim.config import SimConfig


class TraceSchemaError(ValueError):
    """The trace does not carry a compatible ``trace_header`` — written
    by an incompatible version (or not by TraceWriter at all). Refused
    loudly instead of mis-fit silently (twin/calibrate.py)."""


@dataclass
class RoundRow:
    """One fleet-wide round of the aligned table: means/totals over the
    nodes that reported this round index."""

    round: int
    ts: float  # mean wall-clock timestamp of the round across nodes
    duration_s: float  # mean per-node round work time (excludes the interval)
    kv_sent: int  # fleet total key-versions sent this round
    kv_applied: int  # fleet total key-versions applied this round
    live: float  # mean live-peer count observed
    phi_max: float  # worst phi sample any node recorded this round
    nodes: int  # how many nodes reported this round index


@dataclass
class RuntimeTrace:
    """A loaded twin-grade runtime trace (see module docstring)."""

    path: str
    header: dict
    nodes: dict[str, dict]  # node name -> its (latest) twin_node record
    node_rounds: dict[str, list[dict]]  # node name -> twin_round records
    rounds: list[RoundRow] = field(default_factory=list)
    transitions: list[dict] = field(default_factory=list)
    skipped: int = 0  # malformed lines the tolerant read skipped

    @property
    def n_nodes(self) -> int:
        return len(self.nodes)

    def node_rates(
        self, start: int = 0, end: int | None = None
    ) -> dict[str, float]:
        """Per-node measured rounds/s over the [start, end) round-index
        window: (rounds - 1) / (last ts - first ts). Nodes with fewer
        than two rounds in the window are omitted."""
        rates: dict[str, float] = {}
        for name, recs in self.node_rounds.items():
            window = [
                r for r in recs
                if r["round"] >= start and (end is None or r["round"] < end)
            ]
            if len(window) < 2:
                continue
            span = window[-1]["ts"] - window[0]["ts"]
            if span > 0:
                rates[name] = (len(window) - 1) / span
        return rates

    def rounds_per_sec(
        self, start: int = 0, end: int | None = None
    ) -> tuple[float, float]:
        """Fleet (mean, std) of the per-node measured round rates — the
        transfer function's wall-clock axis, with its error bar."""
        rates = sorted(self.node_rates(start, end).values())
        if not rates:
            raise ValueError(
                f"trace {self.path} carries no node with two rounds in "
                f"[{start}, {end}) — nothing to rate-fit"
            )
        mean = statistics.fmean(rates)
        std = statistics.pstdev(rates) if len(rates) > 1 else 0.0
        return mean, std


def load_runtime_trace(
    path: str | Path, *, require_header: bool = True
) -> RuntimeTrace:
    """Read a twin-grade trace tolerantly and align it (module
    docstring). ``require_header=False`` admits headerless traces
    (hand-built fixtures) — calibration refuses those unless forced."""
    scan = scan_trace(path)
    header = scan.header
    if header is not None and header.get("schema") != TRACE_SCHEMA:
        raise TraceSchemaError(
            f"{path}: trace schema {header.get('schema')!r} is not the "
            f"supported {TRACE_SCHEMA!r}; refusing to mis-read records "
            "recorded under a different vocabulary"
        )
    if header is None and require_header:
        raise TraceSchemaError(
            f"{path}: no trace_header record — not a TraceWriter trace "
            "(or its first line was lost); pass require_header=False "
            "only for hand-built fixtures"
        )
    nodes: dict[str, dict] = {}
    node_rounds: dict[str, list[dict]] = {}
    transitions: list[dict] = []
    for rec in scan.records:
        event = rec.get("event")
        if event == "twin_node":
            # Latest wins: a restarted member re-describes itself.
            nodes[rec["node"]] = rec
        elif event == "twin_round":
            node_rounds.setdefault(rec["node"], []).append(rec)
        elif event == "node_transition":
            transitions.append(rec)
    trace = RuntimeTrace(
        path=str(path),
        header=header or {},
        nodes=nodes,
        node_rounds=node_rounds,
        transitions=transitions,
        skipped=len(scan.skipped),
    )
    if not node_rounds:
        raise ValueError(
            f"{path}: no twin_round records — record the fleet with "
            "Cluster.trace_rounds / ChaosHarness(trace=...) first "
            "(a plain trace= constructor trace has no twin events)"
        )
    # Align by round index. A restarted member restarts its own round
    # counter at 0 — its post-restart rounds fold into the early rows
    # (documented; calibration fits want restart-free windows anyway).
    by_round: dict[int, list[dict]] = {}
    for recs in node_rounds.values():
        for rec in recs:
            by_round.setdefault(int(rec["round"]), []).append(rec)
    for rnd in sorted(by_round):
        recs = by_round[rnd]
        trace.rounds.append(
            RoundRow(
                round=rnd,
                ts=statistics.fmean(r["ts"] for r in recs),
                duration_s=statistics.fmean(r["duration_s"] for r in recs),
                kv_sent=sum(int(r["kv_sent"]) for r in recs),
                kv_applied=sum(int(r["kv_applied"]) for r in recs),
                live=statistics.fmean(r["live"] for r in recs),
                phi_max=max(float(r.get("phi_max", 0.0)) for r in recs),
                nodes=len(recs),
            )
        )
    return trace


def lift_sim_config(trace: RuntimeTrace, **overrides) -> SimConfig:
    """The ``SimConfig`` this trace implies — one tick per gossip round,
    fleet shape and tuning knobs from the ``twin_node`` records
    (majority value where members disagree). Keyword overrides replace
    any derived field (e.g. ``budget=...`` to model a narrower MTU)."""
    if trace.n_nodes < 2:
        raise ValueError(
            f"trace describes {trace.n_nodes} node(s); a cluster sim "
            "needs at least 2 (were twin_node records recorded?)"
        )

    def majority(key, default=None):
        values = [n[key] for n in trace.nodes.values() if key in n]
        if not values:
            return default
        return statistics.mode(values)

    derived = {
        "n_nodes": trace.n_nodes,
        "keys_per_node": max(1, int(majority("n_own_keys", 1))),
        "fanout": min(int(majority("gossip_count", 3)), trace.n_nodes - 1),
        "phi_threshold": float(majority("phi_threshold", 8.0)),
        # The runtime's paired 3-way handshake maps to the matching
        # pairing (docs/sim.md); matching also keeps the fanout axis
        # sweepable, which is what the autotuner needs this config for.
        "pairing": "matching",
    }
    derived.update(overrides)
    return SimConfig(**derived)


def wavefront_prediction(
    trace: RuntimeTrace,
    *,
    threshold: float = 0.99,
    seed: int = 0,
    max_rounds: int = 512,
    device="cuda",
    **overrides,
) -> dict:
    """The sim's predicted epidemic wavefront for THIS deployment: lift
    the trace's implied SimConfig and run one marked write through it
    from a converged fleet (obs.sim.wavefront_series). This is what the
    propagation benchmark lines up against the MEASURED write→visible
    curve from the provenance tracer — the twin comparing propagation
    *curves*, not just convergence round counts. Returns the wavefront
    dict plus the lifted config's shape for provenance. Runs on
    ``device`` (the card unless the caller asks otherwise)."""
    import dataclasses

    from ..obs.sim import wavefront_series

    cfg = lift_sim_config(trace, **overrides)
    wf = wavefront_series(
        cfg, seed=seed, max_rounds=max_rounds, threshold=threshold, device=device
    )
    wf["sim_config"] = dataclasses.asdict(cfg)
    return wf


@dataclass
class ReplayReport:
    """The aligned (runtime, sim) comparison the calibrator fits."""

    trace: RuntimeTrace
    cfg: SimConfig
    seed: int
    sim_converged_round: int | None
    rows: list[dict]  # one aligned dict per runtime round
    sim_series: list[dict]  # full stride-1 sim metric series

    def to_dict(self) -> dict:
        """Evidence form (JSON-ready): the aligned table plus the run's
        shape — the full raw series stays out (it can be regenerated
        from the seed; evidence records should stay compact)."""
        import dataclasses

        return {
            "trace_path": self.trace.path,
            "trace_skipped_lines": self.trace.skipped,
            "n_nodes": self.trace.n_nodes,
            "sim_config": dataclasses.asdict(self.cfg),
            "seed": self.seed,
            "sim_converged_round": self.sim_converged_round,
            "rounds": self.rows,
        }


def replay(
    trace: RuntimeTrace,
    cfg: SimConfig | None = None,
    *,
    seed: int = 0,
    max_rounds: int = 4096,
    device="cuda",
) -> ReplayReport:
    """Run the trace's implied (or given) config through the
    deterministic sim on ``device`` and align the two series
    round-for-round.

    The sim runs at stride-1 sampling for at least as many ticks as the
    trace has rounds (so every runtime round has a sim row) and keeps
    going to its exact convergence round up to ``max_rounds`` — the
    figure autotune predictions are made of."""
    from ..obs.registry import MetricsRegistry
    from ..sim.simulator import Simulator

    if cfg is None:
        cfg = lift_sim_config(trace)
    n_trace_rounds = len(trace.rounds)
    sim = Simulator(
        cfg,
        seed=seed,
        chunk=1,
        metrics=MetricsRegistry(),  # private registry: replay is a study
        metrics_stride=1,
        device=device,
    )
    converged = sim.run_until_converged(
        max_rounds=max(max_rounds, n_trace_rounds)
    )
    if sim.tick < n_trace_rounds:
        # Converged before the trace ended: keep stepping so every
        # recorded runtime round has an aligned sim row.
        sim.run(n_trace_rounds - sim.tick)
    series = sim.flush_metrics()
    by_tick = {int(s["tick"]): s for s in series}
    initial_kv = cfg.n_nodes * cfg.keys_per_node  # every owner knows itself
    rows: list[dict] = []
    for row in trace.rounds:
        s = by_tick.get(row.round + 1)  # sim state after r+1 ticks
        prev = by_tick.get(row.round)
        prev_kv = prev["kv_known"] if prev is not None else float(initial_kv)
        rows.append(
            {
                "round": row.round,
                "ts": row.ts,
                "rt_duration_s": row.duration_s,
                "rt_kv_sent": row.kv_sent,
                "rt_kv_applied": row.kv_applied,
                "rt_live": row.live,
                "rt_phi_max": row.phi_max,
                "rt_nodes": row.nodes,
                "sim_kv_moved": (
                    None if s is None else max(s["kv_known"] - prev_kv, 0.0)
                ),
                "sim_mean_fraction": None if s is None else s["mean_fraction"],
                "sim_version_spread": (
                    None if s is None else s["version_spread"]
                ),
                "sim_alive": None if s is None else s["alive_count"],
            }
        )
    return ReplayReport(
        trace=trace,
        cfg=cfg,
        seed=seed,
        sim_converged_round=converged,
        rows=rows,
        sim_series=series,
    )
