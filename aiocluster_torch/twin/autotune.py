"""Autotune: evaluate an operator SLO over one sweep, emit a Config (the
port of the reference's ``twin/autotune.py``).

ScuttleButt reconciliation and phi-accrual detection both ship
operator-facing knobs (fanout, phi threshold, write cadence) whose safe
settings the papers leave to folklore. This module answers them for
*this* cluster: declare the SLO (``convergence_deadline_s``, an FD
false-positive budget, optionally a chaos ``FaultPlan`` the tuning must
survive), hand over a fitted ``CalibrationRecord`` (twin/calibrate.py),
and ``autotune`` drives every candidate as the lanes of ONE
``SweepSimulator`` (each sub-exchange one lane launch for all lanes on
the card), scores each lane's rounds-to-convergence through the
transfer function into wall-clock with error bars, and emits the best
feasible lane as a recommended ``Config`` + ``SimConfig`` pair with the
evidence attached.

Feasibility is conservative: a lane qualifies only if the UPPER error
bar of its predicted convergence time meets the deadline (and its FD
false-positive fraction fits the budget, when one is declared); among
feasible lanes the lowest predicted time wins, ties breaking toward the
earlier (cheaper: grids are built cheapest-first) lane. The sweep runs
on the CUDA card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import dataclasses
import itertools

from ..core.config import Config
from ..faults.plan import FaultPlan
from ..sim.checkpoint import _config_from_meta
from ..sim.config import SimConfig
from .calibrate import CalibrationRecord

RECOMMENDATION_SCHEMA = "aiocluster-twin-recommendation/1"


class AutotuneInfeasible(RuntimeError):
    """No candidate lane satisfied the SLO — the evidence table rides
    along so the operator sees how far each lane missed."""

    def __init__(self, message: str, lanes: list[dict]):
        super().__init__(message)
        self.lanes = lanes


@dataclasses.dataclass(frozen=True)
class SLO:
    """The operator's service-level objective for gossip tuning."""

    # The fleet must (re)converge within this wall-clock budget.
    convergence_deadline_s: float
    # Tolerable fraction of alive observer/peer pairs wrongly believed
    # dead (the sim's fd_false_positive_fraction metric). None = no FD
    # constraint (or FD untracked in the sim config).
    fd_false_positive_budget: float | None = None
    # Chaos conditioning: when set, every candidate lane is evaluated
    # UNDER this plan (docs/faults.md) — the recommendation then answers
    # "which knobs meet the deadline through this failure", not just in
    # fair weather.
    fault_plan: FaultPlan | None = None

    def __post_init__(self) -> None:
        if self.convergence_deadline_s <= 0:
            raise ValueError("convergence_deadline_s must be > 0")
        if (
            self.fd_false_positive_budget is not None
            and not 0.0 <= self.fd_false_positive_budget <= 1.0
        ):
            raise ValueError("fd_false_positive_budget must be in [0, 1]")

    def to_dict(self) -> dict:
        return {
            "convergence_deadline_s": self.convergence_deadline_s,
            "fd_false_positive_budget": self.fd_false_positive_budget,
            "fault_plan": (
                None if self.fault_plan is None else self.fault_plan.to_dict()
            ),
        }

    @classmethod
    def from_dict(cls, raw: dict) -> "SLO":
        plan = raw.get("fault_plan")
        return cls(
            convergence_deadline_s=raw["convergence_deadline_s"],
            fd_false_positive_budget=raw.get("fd_false_positive_budget"),
            fault_plan=None if plan is None else FaultPlan.from_dict(plan),
        )


@dataclasses.dataclass
class Recommendation:
    """One recommended (Config, SimConfig) pair plus its evidence."""

    config: Config
    sim_config: SimConfig
    lane: int
    predicted: dict  # predict_wall_seconds of the winning lane
    evidence: dict  # slo + calibration + per-lane scored table

    @property
    def predicted_rounds_per_sec(self) -> float:
        return self.evidence["calibration"]["rounds_per_sec"]

    def to_dict(self) -> dict:
        """JSON-ready form. The runtime ``Config`` serializes as the
        TUNABLE fields the sweep actually explored (identity, TLS and
        transport knobs belong to the deployment, not the tuner);
        ``from_dict`` re-applies them over the same base config."""
        return {
            "schema": RECOMMENDATION_SCHEMA,
            "tunables": {
                "gossip_count": self.config.gossip_count,
                "phi_threshhold": (
                    self.config.failure_detector.phi_threshhold
                ),
            },
            "sim_config": dataclasses.asdict(self.sim_config),
            "lane": self.lane,
            "predicted": dict(self.predicted),
            "evidence": self.evidence,
        }

    @classmethod
    def from_dict(cls, raw: dict, base_config: Config) -> "Recommendation":
        if raw.get("schema") != RECOMMENDATION_SCHEMA:
            raise ValueError(
                f"recommendation schema {raw.get('schema')!r} is not "
                f"the supported {RECOMMENDATION_SCHEMA!r}"
            )
        tun = raw["tunables"]
        config = dataclasses.replace(
            base_config,
            gossip_count=int(tun["gossip_count"]),
            failure_detector=dataclasses.replace(
                base_config.failure_detector,
                phi_threshhold=float(tun["phi_threshhold"]),
            ),
        )
        return cls(
            config=config,
            sim_config=_config_from_meta(dict(raw["sim_config"])),
            lane=int(raw["lane"]),
            predicted=dict(raw["predicted"]),
            evidence=dict(raw["evidence"]),
        )


def _candidate_grid(
    sim_config: SimConfig,
    fanout,
    phi_threshold,
    writes_per_round,
) -> list[dict]:
    """The lane grid, cheapest-first: fanout ascending outermost (a
    lower fanout is less traffic per round), then phi descending (a
    higher threshold is fewer false positives), then writes ascending.
    Each axis defaults to the base config's current value."""
    fanouts = sorted(set(fanout)) if fanout else [sim_config.fanout]
    phis = (
        sorted(set(phi_threshold), reverse=True)
        if phi_threshold
        else [sim_config.phi_threshold]
    )
    wprs = (
        sorted(set(writes_per_round))
        if writes_per_round
        else [sim_config.writes_per_round]
    )
    return [
        {"fanout": f, "phi_threshold": p, "writes_per_round": w}
        for f, p, w in itertools.product(fanouts, phis, wprs)
    ]


def autotune(
    slo: "SLO",
    calibration: CalibrationRecord,
    base_config: Config,
    sim_config: SimConfig,
    *,
    fanout=None,
    phi_threshold=None,
    writes_per_round=None,
    seed: int = 0,
    max_rounds: int = 1024,
    chunk: int = 8,
    device="cuda",
) -> Recommendation:
    """Evaluate the candidate grid as the lanes of ONE SweepSimulator on
    ``device`` and return the best feasible lane as a Recommendation
    (module docstring). Candidate axes not supplied stay at
    ``sim_config``'s current value; every lane shares ``seed`` so
    candidates differ only in the swept knobs."""
    from ..sim.sweep import SweepSimulator

    grid = _candidate_grid(sim_config, fanout, phi_threshold, writes_per_round)
    if len(grid) < 2:
        raise ValueError(
            "autotune needs at least two candidate lanes — pass "
            "fanout=/phi_threshold=/writes_per_round= candidate lists"
        )
    cfg = sim_config
    if slo.fault_plan is not None:
        cfg = dataclasses.replace(cfg, fault_plan=slo.fault_plan)
    if (
        slo.fd_false_positive_budget is not None
        and not cfg.track_failure_detector
    ):
        raise ValueError(
            "SLO declares an FD false-positive budget but the sim "
            "config does not track the failure detector"
        )
    lane_fanout = [g["fanout"] for g in grid]
    # The static config's fanout is the sweep's sub-exchange BOUND.
    cfg = dataclasses.replace(cfg, fanout=max(lane_fanout))
    sweep = SweepSimulator(
        cfg,
        seeds=[seed] * len(grid),
        fanout=lane_fanout if fanout else None,
        phi_threshold=[g["phi_threshold"] for g in grid]
        if phi_threshold
        else None,
        writes_per_round=[g["writes_per_round"] for g in grid]
        if writes_per_round
        else None,
        chunk=chunk,
        device=device,
    )
    sweep.run_until_converged(max_rounds=max_rounds)
    result = sweep.result()

    def objective(row: dict):
        rounds = row["rounds_to_convergence"]
        if rounds is None:
            return None  # never converged inside max_rounds
        pred = calibration.predict_wall_seconds(rounds)
        if pred["hi"] > slo.convergence_deadline_s:
            return None  # even the optimistic operator can't sign this
        if slo.fd_false_positive_budget is not None:
            fp = row.get("fd_false_positive_fraction")
            if fp is not None and fp > slo.fd_false_positive_budget:
                return None
        return pred["seconds"]

    # Evidence first: the scored table rides the result either way.
    scores = result.evaluate(objective)
    lanes_evidence = []
    for lane, (row, score) in enumerate(zip(result.rows(), scores)):
        entry = dict(row)
        entry.update(grid[lane])
        entry["feasible"] = score is not None
        if row["rounds_to_convergence"] is not None:
            entry["predicted"] = calibration.predict_wall_seconds(
                row["rounds_to_convergence"]
            )
        lanes_evidence.append(entry)

    best = result.best_lane(objective)
    if best is None:
        raise AutotuneInfeasible(
            f"no candidate lane meets the SLO (deadline "
            f"{slo.convergence_deadline_s}s, fd budget "
            f"{slo.fd_false_positive_budget}) — see .lanes for how far "
            "each missed",
            lanes_evidence,
        )
    lane, _score = best
    winner = grid[lane]
    rec_config = dataclasses.replace(
        base_config,
        gossip_count=winner["fanout"],
        failure_detector=dataclasses.replace(
            base_config.failure_detector,
            phi_threshhold=winner["phi_threshold"],
        ),
    )
    rec_sim = dataclasses.replace(
        cfg,
        fanout=winner["fanout"],
        phi_threshold=winner["phi_threshold"],
        writes_per_round=winner["writes_per_round"],
    )
    evidence = {
        "slo": slo.to_dict(),
        "calibration": calibration.to_dict(),
        "lanes": lanes_evidence,
        "swept": sorted(
            k for k, v in (
                ("fanout", fanout),
                ("phi_threshold", phi_threshold),
                ("writes_per_round", writes_per_round),
            ) if v
        ),
    }
    return Recommendation(
        config=rec_config,
        sim_config=rec_sim,
        lane=lane,
        predicted=calibration.predict_wall_seconds(
            result.rounds_to_convergence[lane]
        ),
        evidence=evidence,
    )
