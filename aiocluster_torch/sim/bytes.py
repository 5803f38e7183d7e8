"""Resident bytes per (observer, owner) pair of each memory-ladder rung
(the port's copy of the reference's ``sim/bytes.py`` tables and
``state_bytes_per_pair``; the rest of that module, the MTU bridge and
the traffic model, is not ported yet).

The planned resident state of a run is ``state_bytes_per_pair(cfg) *
N * N`` (the reference's ``sim/memory.py::plan(cfg).state_bytes``),
which the telemetry's ``aiocluster_sim_state_bytes`` gauge reports.
"""

from __future__ import annotations

__all__ = ("FD_BYTES", "HB_BYTES", "ICOUNT_BYTES", "W_BYTES", "state_bytes", "state_bytes_per_pair")

# Storage width per rung of each SimState matrix. Fractional entries are
# the packed forms (sim/packed.py): "u4r" stores two saturating
# watermark residuals per byte; live_bits stores eight liveness bits per
# byte.
W_BYTES = {"int32": 4.0, "int16": 2.0, "int8": 1.0, "u4r": 0.5}
HB_BYTES = {"int32": 4.0, "int16": 2.0, "int8": 1.0}
FD_BYTES = {"float32": 4.0, "bfloat16": 2.0}
ICOUNT_BYTES = {"int16": 2.0, "int8": 1.0}


def state_bytes_per_pair(cfg) -> float:
    """Resident SimState bytes per (observer, owner) pair for this
    config's rung (fractional for the packed forms; multiply by N^2 and
    round for totals)."""
    b = W_BYTES[cfg.version_dtype]
    if cfg.track_heartbeats:
        b += HB_BYTES[cfg.heartbeat_dtype]  # hb_known
    if cfg.track_failure_detector:
        b += HB_BYTES[cfg.heartbeat_dtype]  # last_change
        b += FD_BYTES[cfg.fd_dtype]  # imean
        b += ICOUNT_BYTES[cfg.icount_dtype]  # icount
        b += 0.125 if cfg.live_bits else 1.0  # live_view
        if cfg.dead_grace_ticks is not None:
            b += HB_BYTES[cfg.heartbeat_dtype]  # dead_since
    return b


def state_bytes(cfg) -> int:
    """The run's planned resident state bytes, over every block of a
    mesh (the reference's ``memory.plan(cfg, shards).state_bytes``)."""
    return int(state_bytes_per_pair(cfg) * cfg.n_nodes * cfg.n_nodes)
