"""The digital twin: trace-driven calibration and SLO-driven autotuning
(the port of the reference's ``twin`` package, docs/twin.md).

A recorded runtime trace is lifted into the deterministic simulator and
replayed round for round (``replay``); the residual between the two is
fitted as a transfer function with stated error bars and persisted as a
versioned ``CalibrationRecord`` (``calibrate``); the record is checked
against fresh traces (``check_drift``); and an operator SLO is evaluated
over the lanes of one ``SweepSimulator`` to emit a recommended
``Config`` + ``SimConfig`` pair with the evidence attached
(``autotune``). The simulations run on the CUDA card unless the caller
passes ``device="cpu"``; ``python -m aiocluster_torch twin`` is the
command-line form.
"""

from .autotune import (
    SLO,
    AutotuneInfeasible,
    Recommendation,
    autotune,
)
from .calibrate import (
    CALIBRATION_SCHEMA,
    CalibrationError,
    CalibrationRecord,
    CalibrationSchemaError,
    fit_calibration,
    load_calibration,
    save_calibration,
)
from .drift import AxisDrift, DriftVerdict, check_drift, export_drift
from .replay import (
    ReplayReport,
    RoundRow,
    RuntimeTrace,
    TraceSchemaError,
    lift_sim_config,
    load_runtime_trace,
    replay,
    wavefront_prediction,
)

__all__ = (
    "CALIBRATION_SCHEMA",
    "SLO",
    "AutotuneInfeasible",
    "AxisDrift",
    "CalibrationError",
    "CalibrationRecord",
    "CalibrationSchemaError",
    "DriftVerdict",
    "Recommendation",
    "ReplayReport",
    "RoundRow",
    "RuntimeTrace",
    "TraceSchemaError",
    "autotune",
    "check_drift",
    "export_drift",
    "fit_calibration",
    "lift_sim_config",
    "load_calibration",
    "load_runtime_trace",
    "replay",
    "save_calibration",
    "wavefront_prediction",
)
