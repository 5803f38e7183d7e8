"""Calibration: fit the runtime-to-sim residual as a transfer function
(the port of the reference's ``twin/calibrate.py``).

The simulator predicts *rounds*; an operator's SLO is written in
*seconds*. ``fit_calibration`` takes a replay report (twin/replay.py),
fits the transfer on the FIRST half of the trace, and validates it
against the HELD-OUT second half, so a prediction is checked against
the record's stated tolerance before anyone tunes against it.

The fitted quantities:

- ``rounds_per_sec`` (with the std over per-node rates): wall-clock per
  gossip round, measured for THIS deployment. Turns any simulated
  rounds-to-X into a wall-clock prediction with error bars
  (``predict_wall_seconds``).
- ``kv_scale`` (with its std): runtime key-versions applied per sim
  key-version moved, the reconciliation-volume bias between the
  runtime's byte-exact packer and the sim's budget model.
- ``round_duration_s``: the mean measured per-round work time.

Records persist as versioned JSON (``CALIBRATION_SCHEMA``, the
reference's string, so a record either package writes loads in the
other) and load with a loud schema refusal: a record written under a
different vocabulary is refused by name, never silently mis-fit.
"""

from __future__ import annotations

import json
import os
import statistics
import warnings
from dataclasses import asdict, dataclass, fields
from pathlib import Path

from .replay import ReplayReport

CALIBRATION_SCHEMA = "aiocluster-twin-calibration/1"


class CalibrationError(ValueError):
    """The replay report cannot support a fit (too short, rate-less)."""


class CalibrationSchemaError(ValueError):
    """A persisted record under an incompatible schema — refused loudly
    instead of mis-fit silently (the sim/checkpoint.py discipline)."""


@dataclass(frozen=True)
class CalibrationRecord:
    """One fitted transfer function with its held-out validation."""

    schema: str
    source: str  # trace path the fit came from
    n_nodes: int
    trace_rounds: int
    fit_rounds: int  # rounds the fit consumed (first window)
    holdout_rounds: int  # rounds the validation consumed (second window)
    rounds_per_sec: float
    rounds_per_sec_std: float
    round_duration_s: float
    kv_scale: float | None
    kv_scale_std: float | None
    sim_converged_round: int | None
    # Held-out validation: relative error of the transfer's predictions
    # over the second window, against the stated tolerance.
    holdout_wall_rel_err: float
    holdout_kv_rel_err: float | None
    tolerance: float
    holdout_ok: bool

    # -- prediction -----------------------------------------------------------

    def predict_wall_seconds(self, rounds: int) -> dict:
        """Wall-clock prediction for ``rounds`` gossip rounds, with the
        error bars the fitted rate spread implies (±2 std on the rate;
        the ``hi`` bound uses the slowest plausible rate)."""
        if rounds < 0:
            raise ValueError("rounds must be >= 0")
        rate = self.rounds_per_sec
        lo_rate = rate + 2 * self.rounds_per_sec_std
        hi_rate = max(rate - 2 * self.rounds_per_sec_std, rate * 0.1, 1e-9)
        return {
            "rounds": int(rounds),
            "seconds": rounds / rate,
            "lo": rounds / lo_rate,
            "hi": rounds / hi_rate,
        }

    # -- (de)serialization ----------------------------------------------------

    def to_dict(self) -> dict:
        return asdict(self)

    @classmethod
    def from_dict(cls, raw: dict) -> "CalibrationRecord":
        schema = raw.get("schema")
        if schema != CALIBRATION_SCHEMA:
            raise CalibrationSchemaError(
                f"calibration schema {schema!r} is not the supported "
                f"{CALIBRATION_SCHEMA!r}; refusing to fit predictions "
                "from a record written under a different vocabulary"
            )
        known = {f.name for f in fields(cls)}
        unknown = sorted(set(raw) - known)
        if unknown:
            # A NEWER same-major writer's additions cannot change the
            # meaning of the fields this build reads (that would bump
            # the schema); tolerate them like checkpoint configs do.
            warnings.warn(
                f"calibration record has unknown keys {unknown} "
                "(written by a newer version?); ignoring them",
                stacklevel=2,
            )
        missing = sorted(known - set(raw))
        if missing:
            raise CalibrationSchemaError(
                f"calibration record is missing required fields "
                f"{missing}; refusing a partial transfer function"
            )
        return cls(**{k: raw[k] for k in known})


def save_calibration(path: str | Path, record: CalibrationRecord) -> None:
    """Persist one record as JSON (atomic tmp + replace, like every
    other durable artifact in this repo)."""
    path = Path(path)
    tmp = path.with_suffix(path.suffix + ".tmp")
    tmp.write_text(json.dumps(record.to_dict(), indent=2) + "\n")
    os.replace(tmp, path)


def load_calibration(path: str | Path) -> CalibrationRecord:
    with open(path, encoding="utf-8") as fh:
        try:
            raw = json.load(fh)
        except json.JSONDecodeError as exc:
            raise CalibrationSchemaError(
                f"{path}: not a JSON calibration record: {exc}"
            ) from None
    if not isinstance(raw, dict):
        raise CalibrationSchemaError(f"{path}: calibration record must "
                                     "be a JSON object")
    return CalibrationRecord.from_dict(raw)


def fit_calibration(
    report: ReplayReport,
    *,
    holdout_frac: float = 0.5,
    tolerance: float = 0.35,
) -> CalibrationRecord:
    """Fit the transfer on the first ``1 - holdout_frac`` of the trace
    and validate it on the held-out rest (module docstring). Raises
    ``CalibrationError`` when the trace is too short to split."""
    rows = report.rows
    n = len(rows)
    if not 0.0 < holdout_frac < 1.0:
        raise ValueError("holdout_frac must be in (0, 1)")
    fit_end = int(n * (1.0 - holdout_frac))
    if fit_end < 2 or n - fit_end < 2:
        raise CalibrationError(
            f"trace has {n} aligned rounds; need at least 2 on each "
            f"side of the {holdout_frac:.0%} holdout split to fit and "
            "validate — record a longer run"
        )
    trace = report.trace

    # Wall-clock axis: per-node rates over the fit window only.
    rate, rate_std = trace.rounds_per_sec(0, fit_end)
    round_duration = statistics.fmean(r["rt_duration_s"] for r in rows[:fit_end])

    # Volume axis: fleet totals over the fit window (per-round ratios
    # are 0/0 for most quiescent rounds; window totals are the stable
    # estimator, per-round ratios give the spread where defined).
    fit_rt_kv = sum(r["rt_kv_applied"] for r in rows[:fit_end])
    fit_sim_kv = sum(
        r["sim_kv_moved"] for r in rows[:fit_end]
        if r["sim_kv_moved"] is not None
    )
    kv_scale = kv_scale_std = None
    if fit_sim_kv > 0:
        kv_scale = fit_rt_kv / fit_sim_kv
        ratios = [
            r["rt_kv_applied"] / r["sim_kv_moved"]
            for r in rows[:fit_end]
            if r["sim_kv_moved"]
        ]
        kv_scale_std = (
            statistics.pstdev(ratios) if len(ratios) > 1 else 0.0
        )

    # Held-out validation. Wall-clock: the measured span of the holdout
    # rounds vs the fitted rate's prediction for the same round count.
    holdout_rounds = n - fit_end
    actual_span = rows[-1]["ts"] - rows[fit_end - 1]["ts"]
    predicted_span = holdout_rounds / rate
    if actual_span <= 0:
        raise CalibrationError(
            "holdout window spans no wall-clock time (timestamps not "
            "monotone?) — cannot validate the rate fit"
        )
    wall_rel_err = abs(predicted_span - actual_span) / actual_span
    # Volume: predicted vs measured holdout totals. Both sides go
    # quiescent after convergence, so the denominator is floored at one
    # fleet's worth of keys — a 0-vs-0 holdout validates at 0 error
    # instead of dividing by zero.
    kv_rel_err = None
    if kv_scale is not None:
        hold_rt_kv = sum(r["rt_kv_applied"] for r in rows[fit_end:])
        hold_sim_kv = sum(
            r["sim_kv_moved"] for r in rows[fit_end:]
            if r["sim_kv_moved"] is not None
        )
        floor = max(trace.n_nodes, 1)
        kv_rel_err = abs(kv_scale * hold_sim_kv - hold_rt_kv) / max(
            hold_rt_kv, floor
        )

    return CalibrationRecord(
        schema=CALIBRATION_SCHEMA,
        source=trace.path,
        n_nodes=trace.n_nodes,
        trace_rounds=n,
        fit_rounds=fit_end,
        holdout_rounds=holdout_rounds,
        rounds_per_sec=rate,
        rounds_per_sec_std=rate_std,
        round_duration_s=round_duration,
        kv_scale=kv_scale,
        kv_scale_std=kv_scale_std,
        sim_converged_round=report.sim_converged_round,
        holdout_wall_rel_err=wall_rel_err,
        holdout_kv_rel_err=kv_rel_err,
        tolerance=tolerance,
        holdout_ok=wall_rel_err <= tolerance,
    )
