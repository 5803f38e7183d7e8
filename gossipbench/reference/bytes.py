"""The least device-memory traffic of one gossip round: the fully fused
model, in which each sub-exchange reads and writes every row of the
watermark and heartbeat matrices once, and the failure detector's
bookkeeping is read and written once in the last one (frozen from the
port's ``sim/bytes.py::per_round_bytes(cfg, variant="pairs",
fd_phase="fused")``). It is the round's work whatever kernels run it,
so a roofline share over it reads the same for every kernel form.
"""

from __future__ import annotations

W_BYTES = {"int32": 4.0, "int16": 2.0, "int8": 1.0, "u4r": 0.5}
HB_BYTES = {"int32": 4.0, "int16": 2.0, "int8": 1.0}
FD_BYTES = {"float32": 4.0, "bfloat16": 2.0}
ICOUNT_BYTES = {"int16": 2.0, "int8": 1.0}

# One NVIDIA H100 SXM's published HBM3 bandwidth (the data sheet's
# 3.35 TB/s at the card's full 700 W power limit).
HBM_BYTES_PER_S = 3.35e12


def fused_round_bytes(cfg: dict) -> int:
    """Bytes of one round of the configuration ``cfg`` (a dict of the
    simulator's fields, with its defaults where a field is absent) in the
    fully fused model."""
    n2 = cfg["n_nodes"] ** 2
    fanout = cfg.get("fanout", 3)
    track_hb = cfg.get("track_heartbeats", True)
    track_fd = cfg.get("track_failure_detector", True)
    hdt = cfg.get("heartbeat_dtype", "int32")
    m_w = n2 * W_BYTES[cfg.get("version_dtype", "int32")]
    m_hb = n2 * HB_BYTES[hdt] if track_hb else 0
    total = fanout * 2 * (m_w + m_hb)
    if track_fd:
        if fanout > 1:
            total += m_hb
        total += 2 * m_hb + 2 * n2 * FD_BYTES[cfg.get("fd_dtype", "float32")]
        total += 2 * n2 * ICOUNT_BYTES[cfg.get("icount_dtype", "int16")]
        total += n2 * (0.125 if cfg.get("live_bits", False) else 1.0)
    return int(total)


def fused_round_ms(cfg: dict) -> float:
    """The least time of one round at the published bandwidth, in ms."""
    return fused_round_bytes(cfg) / HBM_BYTES_PER_S * 1e3
