"""Bytes models (the port of the reference's ``sim/bytes.py``): the
resident bytes per (observer, owner) pair of each memory-ladder rung,
the MTU <-> key-version budget bridge and the reference's per-round
traffic model.

The tensor sim bounds each exchange by ``SimConfig.budget`` key-versions,
an abstraction of the wire packer's byte-exact MTU. ``budget_from_mtu``
converts a wire MTU (the reference's 65,507-byte ``max_payload_size``)
into that budget with the reference's proto3 size accounting of a
delta (its ``wire/sizes.DeltaSizeModel`` over its ``NodeId`` and
``KeyValueUpdate`` encodings), of which this module keeps a private copy
of just the arithmetic: every MTU gives the reference's budget, and
``HEADLINE_BUDGET`` (sim/config.py) is ``budget_from_mtu(65_507)``.

``per_round_bytes`` and ``roofline_models`` are the reference's traffic
model of ITS execution paths ("pairs", "m8", "xla"), ported as the same
arithmetic: they are not the port's kernel bounds, which
``chip_smoke.py``'s ``bound`` computes from the bytes each CUDA kernel
moves.
"""

from __future__ import annotations

__all__ = (
    "FD_BYTES",
    "HB_BYTES",
    "ICOUNT_BYTES",
    "W_BYTES",
    "budget_from_mtu",
    "ladder",
    "per_round_bytes",
    "roofline_models",
    "state_bytes",
    "state_bytes_per_pair",
)

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


def ladder(n_nodes: int = 1024) -> list[dict]:
    """The per-rung B/pair table: one row per named rung of each profile
    family, with the SimConfig fields that select it. ``n_nodes`` only
    shapes the illustrative config (the per-pair figure is
    N-independent)."""
    from .config import full_config, lean_config

    rows = []
    for family, make_config, rungs in (
        ("full-fd", full_config, ("int32", "int16", "shrunk", "deep")),
        ("lean", lean_config, ("int32", "int16", "int8", "u4r")),
    ):
        for rung in rungs:
            cfg = make_config(n_nodes, rung=rung)
            rows.append({
                "family": family,
                "rung": rung,
                "bytes_per_pair": state_bytes_per_pair(cfg),
                "version_dtype": cfg.version_dtype,
                "heartbeat_dtype": cfg.heartbeat_dtype if cfg.track_heartbeats else None,
                "fd_dtype": cfg.fd_dtype if cfg.track_failure_detector else None,
                "icount_dtype": cfg.icount_dtype if cfg.track_failure_detector else None,
                "live_bits": cfg.live_bits,
            })
    return rows


# -- the reference's per-round traffic model ---------------------------------------
#
# Passes per (N, N) matrix per sub-exchange on the reference's paths: the
# pair-fused kernel reads and writes every row once (2), the single-pass
# m8 kernel streams a row as itself and again as its partner's peer and
# writes it (3), the plain XLA matching path materialises the peer-row
# gather (4). The FD phase: a separate pass over the heartbeat matrices
# ("kernel"/"xla"), or, fused into the last pairs sub-exchange, only the
# bookkeeping plus one round-start hb read when fanout > 1.

_PULL_PASSES = {"pairs": 2, "m8": 3, "xla": 4}


def per_round_bytes(cfg, *, variant: str = "pairs", fd_phase: str | None = None) -> int:
    """The reference's analytic device-memory bytes of one gossip round
    for ``cfg`` on its pull ``variant`` ("pairs"/"m8"/"xla") and FD phase
    ("fused"/"kernel"/"xla"/"off"; None derives off/xla from the
    config). Rung-aware: the packed forms move their packed bytes."""
    if variant not in _PULL_PASSES:
        raise ValueError(f"unknown variant {variant!r}")
    if fd_phase is None:
        fd_phase = "xla" if cfg.track_failure_detector else "off"
    if fd_phase == "off" and cfg.track_failure_detector:
        raise ValueError("fd_phase='off' on an FD-tracking config")
    n2 = cfg.n_nodes * cfg.n_nodes
    m_w = n2 * W_BYTES[cfg.version_dtype]
    m_hb = n2 * HB_BYTES[cfg.heartbeat_dtype] if cfg.track_heartbeats else 0
    total = cfg.fanout * _PULL_PASSES[variant] * (m_w + m_hb)
    if cfg.version_dtype == "u4r" and variant != "pairs":
        # The byte-space XLA arm materialises the refreshed packed matrix
        # before the first gather: one more read and write a round.
        total += 2 * m_w
    if cfg.track_failure_detector:
        m_fd = n2 * FD_BYTES[cfg.fd_dtype]
        m_lc = m_hb  # last_change is heartbeat-dtype
        m_ic = n2 * ICOUNT_BYTES[cfg.icount_dtype]
        m_live = n2 * (0.125 if cfg.live_bits else 1.0)
        if fd_phase == "fused":
            if cfg.fanout > 1:
                total += m_hb  # round-start hb0 stream
            total += 2 * m_lc + 2 * m_fd + 2 * m_ic  # bookkeeping read + write
            total += m_live  # live_view write
        else:
            total += 2 * m_hb  # hb + round-start hb reads
            total += 2 * m_lc + 2 * m_fd + 2 * m_ic + 2 * m_live
    return int(total)


def roofline_models(cfg, *, variant: str, fd_phase: str) -> dict:
    """The reference's three denominators of a roofline: the engaged
    path's bytes, the fully fused minimal-traffic model and the plain-XLA
    model (``per_round_bytes`` of each)."""
    fd_on = cfg.track_failure_detector
    return {
        "engaged": per_round_bytes(cfg, variant=variant, fd_phase=fd_phase),
        "fused": per_round_bytes(cfg, variant="pairs", fd_phase="fused" if fd_on else "off"),
        "xla": per_round_bytes(cfg, variant="xla", fd_phase="xla" if fd_on else "off"),
    }


# -- the wire's size arithmetic (the reference's proto3 accounting) ----------------

_TAG_SIZE = 1  # every field of the schema has a one-byte tag
_SET = 0  # VersionStatusEnum.SET's wire value


def _varint_size(value: int) -> int:
    """Encoded size in bytes of an unsigned varint."""
    size = 1
    while value >= 0x80:
        value >>= 7
        size += 1
    return size


def _len_field_size(body_size: int) -> int:
    """Bytes of a length-delimited field holding ``body_size`` bytes."""
    return _TAG_SIZE + _varint_size(body_size) + body_size


def _varint_field_size(value: int) -> int:
    """Bytes of a varint field (proto3 skips a zero)."""
    return 0 if value == 0 else _TAG_SIZE + _varint_size(value)


def _str_field_size(value: str) -> int:
    """Bytes of a string field (proto3 skips an empty one)."""
    return 0 if not value else _len_field_size(len(value.encode("utf-8")))


def _node_id_size(name: str, generation_id: int, host: str, port: int, tls_name: str = "") -> int:
    """The NodeIdPb body: name, generation, the address submessage (host,
    port; always emitted) and the TLS name."""
    address = _str_field_size(host) + _varint_field_size(port)
    return (_str_field_size(name) + _varint_field_size(generation_id)
            + _len_field_size(address) + _str_field_size(tls_name))


def _kv_size(key: str, value: str, version: int, status: int) -> int:
    """The KeyValueUpdatePb body."""
    return (_str_field_size(key) + _str_field_size(value) + _varint_field_size(version)
            + _varint_field_size(status))


def budget_from_mtu(
    mtu_bytes: int,
    *,
    key_bytes: int = 8,
    value_bytes: int = 8,
    stale_owners: int = 1,
    node_name_bytes: int = 8,
    version_scale: int = 1000,
) -> int:
    """Key-versions that fit one ``mtu_bytes`` delta for this workload.

    ``stale_owners`` is how many distinct owners' updates share the delta
    (each adds one NodeDelta envelope); ``version_scale`` sets the varint
    width of representative version numbers. Raises if not even one
    key-version fits (the packer would make no progress at that MTU)."""
    if mtu_bytes <= 0:
        raise ValueError("mtu_bytes must be positive")
    node = _node_id_size("n" * node_name_bytes, version_scale, "h" * 9, 65_000)
    # The NodeDeltaPb body before any key-value: the node id, the
    # versions (last_gc 0 is skipped) and the presence-tracked max_version.
    base = (_len_field_size(node) + _varint_field_size(version_scale) + _varint_field_size(0)
            + _TAG_SIZE + _varint_size(version_scale))
    kv_inc = _len_field_size(_kv_size("k" * key_bytes, "v" * value_bytes, version_scale, _SET))
    overhead = stale_owners * _len_field_size(base)
    budget = (mtu_bytes - overhead) // kv_inc
    if budget < 1:
        raise ValueError(
            f"mtu_bytes={mtu_bytes} cannot carry one key-version "
            f"(overhead {overhead}B + {kv_inc}B per key-version)"
        )
    return int(budget)
