"""Drift monitor: does the stored calibration still describe reality?
(the port of the reference's ``twin/drift.py``)

A ``CalibrationRecord`` is a snapshot of a deployment's transfer
function; the deployment keeps changing under it (contention, fleet
growth, interval tuning). ``check_drift`` re-fits the measurable axes on
a ROLLING WINDOW of a fresh trace and verdicts each against the stored
record's own tolerance: the recurring check an operator runs between
full recalibrations (``python -m aiocluster_torch twin --trace
fresh.jsonl --check-drift stored.json``).

Axes checked:

- ``rounds_per_sec``: the wall-clock axis, re-measured from the
  window's per-node round timestamps (no sim needed).
- ``round_duration_s``: the per-round work floor.
- ``kv_scale``: the volume axis, ONLY when the window reaches back to
  the trace's round 0: kv_scale is runtime-kv per *sim*-kv, and the sim
  it is measured against cold-starts at round 0, so a mid-flight window
  has no comparable sim volume. Skipped windows are reported as such,
  never silently verdicted. Its replay runs on ``device``.

A drifted verdict means "refit and redeploy the calibration", not "the
system is broken". Exported as the ``aiocluster_twin_drift`` gauge (1 =
drifted) when a registry is passed.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass
from pathlib import Path

from ..obs.registry import MetricsRegistry
from .calibrate import CalibrationRecord
from .replay import RuntimeTrace, load_runtime_trace


@dataclass(frozen=True)
class AxisDrift:
    """One re-fitted axis vs its stored value."""

    axis: str
    fitted: float
    stored: float
    rel_err: float  # |fitted - stored| / |stored|
    tolerance: float
    drifted: bool

    def to_dict(self) -> dict:
        return {
            "axis": self.axis,
            "fitted": round(self.fitted, 6),
            "stored": round(self.stored, 6),
            "rel_err": round(self.rel_err, 6),
            "tolerance": self.tolerance,
            "drifted": self.drifted,
        }


@dataclass(frozen=True)
class DriftVerdict:
    """The monitor's answer: ok, or drifted with axis + magnitude."""

    ok: bool
    axes: tuple[AxisDrift, ...]
    skipped_axes: tuple[str, ...]  # axes the window could not re-fit
    window_rounds: int
    window_start: int
    trace_rounds: int
    tolerance: float

    @property
    def drifted_axes(self) -> tuple[AxisDrift, ...]:
        return tuple(a for a in self.axes if a.drifted)

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "axes": [a.to_dict() for a in self.axes],
            "skipped_axes": list(self.skipped_axes),
            "window_rounds": self.window_rounds,
            "window_start": self.window_start,
            "trace_rounds": self.trace_rounds,
            "tolerance": self.tolerance,
        }


def export_drift(
    verdict: DriftVerdict, registry: MetricsRegistry
) -> None:
    """Mirror a verdict into the registry: ``aiocluster_twin_drift``
    (1 drifted / 0 ok) plus the per-axis relative error as
    ``aiocluster_twin_drift_rel_err{axis=}`` — the alertable shape of
    the cron loop (docs/twin.md)."""
    registry.gauge(
        "aiocluster_twin_drift",
        "Twin calibration drift verdict: 1 = a re-fitted axis left the "
        "stored CalibrationRecord's tolerance (refit and redeploy), "
        "0 = the stored transfer function still describes the fleet",
    ).set(0.0 if verdict.ok else 1.0)
    rel = registry.gauge(
        "aiocluster_twin_drift_rel_err",
        "Per-axis relative error of the rolling re-fit vs the stored "
        "calibration (the drift magnitude behind aiocluster_twin_drift)",
        labels=("axis",),
    )
    for a in verdict.axes:
        rel.labels(a.axis).set(a.rel_err)


def check_drift(
    calibration: CalibrationRecord,
    trace: RuntimeTrace | str | Path,
    *,
    window: int | None = None,
    tolerance: float | None = None,
    seed: int = 0,
    registry: MetricsRegistry | None = None,
    device="cuda",
) -> DriftVerdict:
    """Re-fit the transfer function's axes on the LAST ``window``
    rounds of ``trace`` and verdict each against ``calibration``
    (module docstring). ``window`` defaults to the stored record's own
    fit window; ``tolerance`` to the stored record's. Raises
    ``ValueError`` when the window holds fewer than two rounds (nothing
    to rate-fit — record longer). The kv_scale axis's replay runs on
    ``device`` (the card unless the caller asks otherwise)."""
    if isinstance(trace, (str, Path)):
        trace = load_runtime_trace(trace)
    tol = calibration.tolerance if tolerance is None else tolerance
    if tol <= 0:
        raise ValueError("drift tolerance must be > 0")
    rows = trace.rounds
    if not rows:
        raise ValueError(f"{trace.path}: trace aligned to zero rounds")
    last_round = rows[-1].round
    w = calibration.fit_rounds if window is None else int(window)
    if w < 2:
        raise ValueError("drift window must span at least 2 rounds")
    start = max(0, last_round + 1 - w)
    window_rows = [r for r in rows if r.round >= start]
    if len(window_rows) < 2:
        raise ValueError(
            f"{trace.path}: only {len(window_rows)} aligned round(s) in "
            f"the [{start}, {last_round}] window — record a longer trace"
        )

    axes: list[AxisDrift] = []
    skipped: list[str] = []

    def axis(name: str, fitted: float, stored: float) -> None:
        denom = max(abs(stored), 1e-12)
        rel = abs(fitted - stored) / denom
        axes.append(
            AxisDrift(
                axis=name,
                fitted=fitted,
                stored=stored,
                rel_err=rel,
                tolerance=tol,
                drifted=rel > tol,
            )
        )

    # Wall-clock axis: the window's measured per-node rate.
    rate, _rate_std = trace.rounds_per_sec(start, None)
    axis("rounds_per_sec", rate, calibration.rounds_per_sec)
    # Work-floor axis.
    duration = statistics.fmean(r.duration_s for r in window_rows)
    axis("round_duration_s", duration, calibration.round_duration_s)

    # Volume axis: only a window anchored at round 0 is comparable to
    # the cold-start sim kv_scale is defined against (module docstring).
    if calibration.kv_scale is not None and start == 0:
        from .calibrate import CalibrationError, fit_calibration
        from .replay import replay

        try:
            refit = fit_calibration(
                replay(trace, seed=seed, device=device), tolerance=tol
            )
        except CalibrationError:
            skipped.append("kv_scale")
        else:
            if refit.kv_scale is not None:
                axis("kv_scale", refit.kv_scale, calibration.kv_scale)
            else:
                skipped.append("kv_scale")
    elif calibration.kv_scale is not None:
        skipped.append("kv_scale")

    verdict = DriftVerdict(
        ok=not any(a.drifted for a in axes),
        axes=tuple(axes),
        skipped_axes=tuple(skipped),
        window_rounds=len(window_rows),
        window_start=start,
        trace_rounds=len(rows),
        tolerance=tol,
    )
    if registry is not None:
        export_drift(verdict, registry)
    return verdict
