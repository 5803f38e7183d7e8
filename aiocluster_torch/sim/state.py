"""Tensor state for the PyTorch gossip simulator.

The same fields, dtypes and shapes as the reference ``SimState``: what
replica ``i`` knows about owner ``j`` is one watermark ``w[i, j]`` (a
version prefix), plus heartbeat knowledge and the phi-accrual failure
detector's bookkeeping. The state is a frozen dataclass of tensors that
all live on one device; ``dataclasses.replace`` makes the next one.

A sweep (sim/sweep.py) holds S lanes in one ``SimState`` whose fields
carry a leading lane axis (``init_lanes``); ``lane(states, s)`` is lane
s's state as views, and ``SweepParams`` the per-lane values of the
sweepable scalars.
"""

from __future__ import annotations

import dataclasses

import torch

from ..obs.profiling import span
from .config import SimConfig
from .packed import is_packed_w, pack_u4

DTYPES = {
    "bool": torch.bool,
    "uint8": torch.uint8,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}


@dataclasses.dataclass(frozen=True)
class SimState:
    """One cluster's complete simulated state."""

    tick: torch.Tensor  # () int32 — gossip round counter
    max_version: torch.Tensor  # (N,) int32 — owner version counters
    heartbeat: torch.Tensor  # (N,) int32 — owner heartbeat counters
    alive: torch.Tensor  # (N,) bool — ground-truth liveness
    w: torch.Tensor  # (N, N) version_dtype — i's watermark on owner j
    # (u4r: (N, N/2) uint8 residuals, two owners a byte; sim/packed.py)
    hb_known: torch.Tensor  # (N, N) heartbeat_dtype — highest hb of j known to i
    # Failure-detector state ((0, 0) when disabled): the sampling window
    # as a running (mean, count) pair.
    last_change: torch.Tensor  # (N, N) heartbeat_dtype — tick of last hb increase
    imean: torch.Tensor  # (N, N) fd_dtype — mean of sampled intervals (ticks)
    icount: torch.Tensor  # (N, N) icount_dtype — number of samples (window-capped)
    live_view: torch.Tensor  # (N, N) bool — i's belief that j is alive
    # (live_bits: (N, N/8) uint8, eight owners a byte; sim/packed.py)
    # Dead-node lifecycle stamps: the tick at which observer i saw owner
    # j die (0: not dead); (0, 0) unless dead_grace_ticks is set.
    dead_since: torch.Tensor  # (N, N) heartbeat_dtype

    def replace(self, **changes) -> "SimState":
        return dataclasses.replace(self, **changes)


STATE_FIELDS = tuple(f.name for f in dataclasses.fields(SimState))


@dataclasses.dataclass(frozen=True)
class SweepParams:
    """Per-lane values of the sweepable ``SimConfig`` scalars (the
    reference's ``SweepParams``): each None (every lane uses the config's
    value) or an (S,) tensor on the states' device.

    - ``fanout`` (int64, <= cfg.fanout): a lane's sub-exchanges ``c >=
      fanout`` are voided (their alive-pair mask is all 0) and its dither
      salts use its own value, so the lane equals a run with
      ``replace(cfg, fanout=...)``.
    - ``phi_threshold`` (float32): the FD liveness bound.
    - ``writes_per_round`` (int32): the owners' write rate.
    - ``fault_seed`` (int64, masked to 32 bits): overrides
      ``fault_plan.seed`` in the probabilistic link and byzantine draws.
    - ``byz_frac`` (float32 in [0, 1]): moves every byzantine entry's
      attackers to the window [0, byz_frac).

    The last two stay on the host: they choose each lane's plan
    (``ops.gossip.lane_configs``), which is host data.
    """

    fanout: torch.Tensor | None = None
    phi_threshold: torch.Tensor | None = None
    writes_per_round: torch.Tensor | None = None
    fault_seed: torch.Tensor | None = None
    byz_frac: torch.Tensor | None = None

# Largest representable watermark / heartbeat per dtype rung: init_state
# and the horizon guard (Simulator._check_horizon) enforce these bounds
# loudly instead of letting a narrow rung wrap.
VERSION_LIMITS = {"int32": 2**31, "int16": 2**15, "int8": 2**7, "u4r": 16}
HEARTBEAT_LIMITS = {"int32": 2**31, "int16": 2**15, "int8": 2**7}


def state_n_local(state: SimState) -> int:
    """The owner-column count of the state's matrices, decoding the
    packed u4 rung (whose stored width is halved)."""
    return int(state.w.shape[-1]) * (2 if is_packed_w(state.w) else 1)


def expected_shapes(cfg: SimConfig) -> dict[str, tuple[int, ...]]:
    """The (N, N)-class fields' stored shapes for this config's rung:
    the packed u4 rung halves w's width, the live bitmap divides the live
    view's by eight, and a disabled matrix (dead_since without the
    lifecycle) is (0, 0)."""
    n = cfg.n_nodes
    fd = cfg.track_failure_detector
    lifecycle = fd and cfg.dead_grace_ticks is not None
    return {
        "w": (n, n // 2) if cfg.version_dtype == "u4r" else (n, n),
        "hb_known": (n, n) if cfg.track_heartbeats else (0, 0),
        "live_view": ((n, n // 8) if cfg.live_bits else (n, n)) if fd else (0, 0),
        "dead_since": (n, n) if lifecycle else (0, 0),
    }


def expected_dtypes(cfg: SimConfig) -> dict[str, str]:
    """Storage dtype per SimState field for this config's rung — the
    layout contract carried-in states are validated against."""
    vdt = "uint8" if cfg.version_dtype == "u4r" else cfg.version_dtype
    hdt = cfg.heartbeat_dtype
    return {
        "tick": "int32",
        "max_version": "int32",
        "heartbeat": "int32",
        "alive": "bool",
        "w": vdt,
        "hb_known": hdt,
        "last_change": hdt,
        "imean": cfg.fd_dtype,
        "icount": cfg.icount_dtype,
        "live_view": "uint8" if cfg.live_bits else "bool",
        "dead_since": hdt,
    }


def init_lanes(
    cfg: SimConfig, lanes: int, initial_versions=None, *,
    device: str | torch.device = "cuda", owner_offset: int = 0, n_local: int | None = None,
) -> SimState:
    """S = ``lanes`` copies of ``init_state`` in one state whose fields
    carry a leading lane axis: the broadcast is materialised, as the
    reference's sweep does, because every lane's matrices are updated in
    place. ``owner_offset`` / ``n_local`` make one column block of it, as
    ``init_state``'s. One ``aiocluster_torch.init_state`` range."""
    with span("aiocluster_torch.init_state"):
        base = _init_state(cfg, initial_versions, device=device, owner_offset=owner_offset,
                           n_local=n_local)
        return SimState(**{
            f: getattr(base, f)[None].expand(lanes, *getattr(base, f).shape).clone()
            for f in STATE_FIELDS
        })


def lane(states: SimState, s: int) -> SimState:
    """Lane ``s`` of a lane-batched state, as views: writing a field of
    the lane in place writes the batch."""
    return SimState(**{f: getattr(states, f)[s] for f in STATE_FIELDS})


def check_lanes(states: SimState, cfg: SimConfig, lanes: int, device) -> None:
    """A provided lane-batched state must hold ``lanes`` lanes of this
    config's rung, field for field, on ``device`` (nothing is moved or
    cast silently; ``device`` None: a mesh copies it into its blocks)."""
    device = None if device is None else torch.device(device)
    if states.w.dim() < 1 or states.w.shape[0] != lanes:
        raise ValueError(
            f"provided states carry {states.w.shape[0] if states.w.dim() else 0} "
            f"lanes, expected {lanes}"
        )
    want = expected_dtypes(cfg)
    n = cfg.n_nodes
    fd = (n, n) if cfg.track_failure_detector else (0, 0)
    shapes = dict(
        tick=(), max_version=(n,), heartbeat=(n,), alive=(n,), last_change=fd,
        imean=fd, icount=fd, **expected_shapes(cfg),
    )
    for f in STATE_FIELDS:
        t = getattr(states, f)
        if t.dtype != DTYPES[want[f]]:
            raise ValueError(f"states.{f} is {t.dtype}, config expects {want[f]}")
        if device is not None and t.device.type != device.type:
            raise ValueError(f"states.{f} is on {t.device}, expected {device}")
        shape = shapes[f]
        if tuple(t.shape) != (lanes, *shape):
            raise ValueError(f"states.{f} shape {tuple(t.shape)} != {(lanes, *shape)}")


def init_state(
    cfg: SimConfig,
    initial_versions=None,
    *,
    device: str | torch.device = "cuda",
    owner_offset: int = 0,
    n_local: int | None = None,
) -> SimState:
    """Fresh cluster: every node owns ``keys_per_node`` versions (or
    per-node counts via ``initial_versions``), knows only itself, and has
    heartbeat 1.

    ``owner_offset``/``n_local`` build one column block of it: the
    (N, N)-class matrices hold only the owners ``owner_offset ..
    owner_offset + n_local - 1`` (the packed rungs' stored widths scale
    with it), the (N,) vectors and the tick stay whole. The blocks of a
    mesh (parallel/mesh.py) are made this way, so the whole state never
    exists at once. One ``aiocluster_torch.init_state`` range."""
    with span("aiocluster_torch.init_state"):
        return _init_state(cfg, initial_versions, device=device, owner_offset=owner_offset,
                           n_local=n_local)


def _init_state(cfg, initial_versions, *, device, owner_offset, n_local) -> SimState:
    device = torch.device(device)
    n = cfg.n_nodes
    n_local = n if n_local is None else n_local
    fd_shape = (n, n_local) if cfg.track_failure_detector else (0, 0)
    ds_shape = (
        (n, n_local)
        if cfg.track_failure_detector and cfg.dead_grace_ticks is not None
        else (0, 0)
    )
    if initial_versions is None:
        initial_versions = torch.full((n,), cfg.keys_per_node, dtype=torch.int32)
    initial_versions = torch.as_tensor(initial_versions).to(
        device=device, dtype=torch.int32, copy=True
    )
    limit = VERSION_LIMITS[cfg.version_dtype]
    if int(initial_versions.max()) >= limit:
        raise ValueError(
            f"initial versions overflow version_dtype={cfg.version_dtype} "
            f"(must stay < {limit})"
        )
    hdt = DTYPES[cfg.heartbeat_dtype]
    # Local column j is global owner owner_offset + j, whose own row holds
    # the block's diagonal.
    cols = torch.arange(n_local, device=device)
    rows = owner_offset + cols
    owned = initial_versions[owner_offset : owner_offset + n_local]

    # Each (N, N) matrix is allocated once, in its own dtype, and only its
    # diagonal written: at N = 100,352 an eye mask alone is 10 GB.
    if cfg.version_dtype == "u4r":
        # A fresh observer's residual on owner j IS j's initial version
        # count (w = 0 off the diagonal), 0 on the diagonal: one packed
        # row repeated, then each row's own nibble cleared.
        row = pack_u4(owned)
        w = row[None, :].expand(n, n_local // 2).clone()
        w[rows, cols // 2] &= torch.where(cols % 2 == 0, 0xF0, 0x0F).to(torch.uint8)
    else:
        w = torch.zeros((n, n_local), dtype=DTYPES[cfg.version_dtype], device=device)
        w[rows, cols] = owned.to(w.dtype)
    hb_shape = (n, n_local) if cfg.track_heartbeats else (0, 0)
    hb_known = torch.zeros(hb_shape, dtype=hdt, device=device)
    if cfg.track_heartbeats:
        hb_known[rows, cols] = 1
    if cfg.track_failure_detector and cfg.live_bits:
        live_view = torch.zeros((n, n_local // 8), dtype=torch.uint8, device=device)
        live_view[rows, cols // 8] = (1 << (cols % 8)).to(torch.uint8)
    else:
        live_view = torch.zeros(fd_shape, dtype=torch.bool, device=device)
        if cfg.track_failure_detector:
            live_view[rows, cols] = True
    return SimState(
        tick=torch.zeros((), dtype=torch.int32, device=device),
        max_version=initial_versions,
        heartbeat=torch.ones((n,), dtype=torch.int32, device=device),
        alive=torch.ones((n,), dtype=torch.bool, device=device),
        w=w,
        hb_known=hb_known,
        last_change=torch.zeros(fd_shape, dtype=hdt, device=device),
        imean=torch.zeros(fd_shape, dtype=DTYPES[cfg.fd_dtype], device=device),
        icount=torch.zeros(fd_shape, dtype=DTYPES[cfg.icount_dtype], device=device),
        live_view=live_view,
        dead_since=torch.zeros(ds_shape, dtype=hdt, device=device),
    )
