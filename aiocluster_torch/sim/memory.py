"""Device-memory planning for simulated cluster sizes (the port of the
reference's ``sim/memory.py``), for the CUDA card.

The footprint is dominated by the (N, N) knowledge matrices
(sim/state.py); which matrices exist and how wide their elements are
depends on the ``SimConfig``, so whether a scale fits is a function of
the config, answered here before any allocation. The resident state
comes from the reference's per-pair tables (``sim.bytes``), so it equals
the reference's plan for every rung. The transients are the port's own,
each the tensors a round or a metrics pass of this package holds beside
the state at its peak:

- the pairs kernels update w and hb in place: the FD epilogue's
  round-start copy of hb (unless the FD fuses into a fanout-1 round's
  only launch), one per lane of a sweep;
- the m8 pull writes out of place: a second copy of w, and of hb twice
  where the FD keeps the round-start hb beside the ping-pong;
- the plain pulls write new matrices and gather the peers' rows:
  (1 + directions) copies of w and hb (a matching pulls one direction,
  the permutation and the choice pairings two), the round-start hb with
  the FD, and a block of rows of int64 hash temporaries
  (``PLAIN_BLOCK_BYTES`` an element of ``gossip.ROW_BLOCK_ELEMS``); a
  sweep's plain lanes run one after another;
- every route's metrics pass (``gossip.metrics_sample``) works a block
  of rows at a time (``METRIC_BLOCK_BYTES`` an element).

The capacity is the card's (``device_capacity``: its total memory), or an
explicit argument where no card is visible.

Measured evidence comes first (``fits_verdict``): the port's own
``measured_boundaries.json`` holds peaks measured on the H100, each with
its source run and the card's name and power limit, keyed by the
execution path and the capacity it was observed on.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass

from .bytes import HB_BYTES, W_BYTES, state_bytes_per_pair
from .config import SimConfig, full_config, lean_config

__all__ = (
    "MemoryPlan",
    "device_capacity",
    "engaged_variant",
    "fits_verdict",
    "full_config",
    "ladder_models",
    "lean_config",
    "load_boundaries",
    "max_scale_model",
    "packed_kernel_engagement",
    "plan",
    "record_boundary",
)

# The share of the card's memory a plan may take: the CUDA context and
# the caching allocator's rounding keep the rest.
HEADROOM = 0.95
# Bytes of temporaries an element of a block of rows holds: the metrics
# pass (float32 fractions and their masks, the widened watermarks, the
# live view's bools), and the plain pull (the int64 dither hash, the
# gathered peer rows and the advance).
METRIC_BLOCK_BYTES = 32
PLAIN_BLOCK_BYTES = 64


def device_capacity(device=None) -> int:
    """The card's total memory in bytes (``device``: a CUDA device, the
    current one by default). Raises where no card is visible: pass the
    capacity explicitly there."""
    import torch

    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: pass the capacity in bytes explicitly")
    if device is None:
        device = torch.cuda.current_device()
    return int(torch.cuda.get_device_properties(device).total_memory)


@dataclass(frozen=True)
class MemoryPlan:
    """Planned device bytes for one simulated cluster (or a sweep of
    ``lanes`` of them). ``shards`` counts global column blocks, over
    ``hosts`` processes (parallel/multihost.py): memory-neutral, but part
    of the planning identity."""

    n_nodes: int
    state_bytes: int  # resident SimState matrices (all lanes)
    transient_bytes: int  # what a round or a metrics pass holds beside them
    shards: int
    lanes: int = 1
    hosts: int = 1

    @property
    def planned_bytes(self) -> int:
        """State and transients: the planned peak of the whole run."""
        return self.state_bytes + self.transient_bytes

    @property
    def per_shard_bytes(self) -> int:
        return self.planned_bytes // self.shards

    def fits(self, capacity_bytes: int | None = None) -> bool:
        """Whether a shard's bytes fit ``HEADROOM`` of one card
        (``capacity_bytes``, the visible card's by default)."""
        if capacity_bytes is None:
            capacity_bytes = device_capacity()
        return self.per_shard_bytes <= int(capacity_bytes * HEADROOM)


def _phases(cfg: SimConfig, shards: int, lanes: int):
    """The round's resolution on a card (``gossip.resolve_phases``), or
    None off the kernels' block domain (a mesh the kernels refuse)."""
    from ..ops.gossip import resolve_phases, resolve_variant_env

    cfg = resolve_variant_env(cfg)
    n_local = None if shards == 1 else cfg.n_nodes // shards
    try:
        return resolve_phases(cfg, "cuda", sweep=lanes > 1, n_local=n_local)
    except ValueError:
        return None


def engaged_variant(cfg: SimConfig, shards: int = 1, lanes: int = 1) -> str:
    """Which pull serves ``cfg`` on the card: "pairs", "m8" or "xla" (the
    reference's name for the plain route), by the same resolution the
    round dispatches on, the variant environment override folded in;
    ``lanes > 1`` asks for the sweep's (only the pairs kernels carry the
    lane axis)."""
    from ..ops.gossip import M8_FORMS, PAIRS_FORMS

    phases = _phases(cfg, shards, lanes)
    if phases is None:
        return "xla"
    if phases.pull in PAIRS_FORMS:
        return "pairs"
    return "m8" if phases.pull in M8_FORMS else "xla"


def plan(cfg: SimConfig, shards: int = 1, lanes: int = 1, hosts: int = 1) -> MemoryPlan:
    """Bytes needed for ``cfg`` sharded ``shards`` ways (globally, over
    ``hosts`` processes) on the owner axis; ``lanes`` > 1 is a sweep,
    whose state and lane transients scale with the lane count."""
    from ..ops.gossip import ROW_BLOCK_ELEMS

    if lanes < 1:
        raise ValueError("lanes must be >= 1")
    if hosts < 1 or shards % hosts != 0:
        raise ValueError("hosts must divide the global shard count")
    n = cfg.n_nodes
    n2 = n * n
    state = int(state_bytes_per_pair(cfg) * n2)
    w = int(W_BYTES[cfg.version_dtype] * n2)
    hb = int(HB_BYTES[cfg.heartbeat_dtype] * n2) if cfg.track_heartbeats else 0
    fd = cfg.track_failure_detector
    block = min(ROW_BLOCK_ELEMS, n * (n // shards))
    transient = METRIC_BLOCK_BYTES * block
    variant = engaged_variant(cfg, shards, lanes)
    if variant == "pairs":
        phases = _phases(cfg, shards, lanes)
        if fd and not (phases.fd == "fused" and cfg.fanout == 1):
            transient += lanes * hb
    elif variant == "m8":
        transient += w + (2 * hb if fd else hb)
    else:
        directions = 1 if cfg.pairing == "matching" else 2
        transient += (1 + directions) * (w + hb) + (hb if fd else 0) + PLAIN_BLOCK_BYTES * block
    return MemoryPlan(n, state * lanes, transient, shards, lanes, hosts)


# -- measured fit/no-fit boundaries ----------------------------------------------
#
# Every chip run that finds a width's peak may record it here; the planner
# consults the measured table before the model. Entries are keyed by the
# execution path (the variant, the profile's dtypes and flags, the shards,
# lanes and hosts) and the capacity they were observed on: within one key
# group, fit is monotone in n_nodes.

_BOUNDARIES_DEFAULT = os.path.join(
    os.path.dirname(os.path.abspath(__file__)), "measured_boundaries.json"
)
BOUNDARIES_ENV = "AIOCLUSTER_TORCH_BOUNDARIES_PATH"


def _boundaries_path() -> str:
    """The boundary file: the package's, or ``AIOCLUSTER_TORCH_BOUNDARIES_PATH``
    (read at every call) where the package directory is not writable."""
    return os.environ.get(BOUNDARIES_ENV, _BOUNDARIES_DEFAULT)


def _boundary_key(cfg: SimConfig, shards: int, capacity_bytes: int, lanes: int = 1,
                  hosts: int = 1) -> dict:
    """The signature a measured verdict is valid for: the execution path
    and the card capacity it was observed on."""
    return {
        "variant": engaged_variant(cfg, shards, lanes),
        "version_dtype": cfg.version_dtype,
        "heartbeat_dtype": cfg.heartbeat_dtype if cfg.track_heartbeats else None,
        "fd_dtype": cfg.fd_dtype if cfg.track_failure_detector else None,
        "icount_dtype": cfg.icount_dtype if cfg.track_failure_detector else None,
        "live_bits": cfg.live_bits,
        "track_heartbeats": cfg.track_heartbeats,
        "track_failure_detector": cfg.track_failure_detector,
        "pairing": cfg.pairing,
        "shards": shards,
        "lanes": lanes,
        "hosts": hosts,
        "capacity_bytes": capacity_bytes,
    }


def load_boundaries(path: str | None = None) -> list[dict]:
    try:
        with open(path or _boundaries_path()) as f:
            return json.load(f)["entries"]
    except (OSError, ValueError, KeyError):
        return []


def record_boundary(
    cfg: SimConfig,
    shards: int,
    fits: bool,
    *,
    peak_bytes: int | None = None,
    rounds_per_sec: float | None = None,
    card: str = "",
    source: str = "",
    path: str | None = None,
    capacity_bytes: int | None = None,
    lanes: int = 1,
    hosts: int = 1,
) -> dict:
    """Append one measured outcome (an atomic rewrite under a file lock):
    whether the run fit, its peak (``torch.cuda.max_memory_allocated``),
    the card's name and power limit (``card``) and the run that measured
    it (``source``). Returns the entry."""
    import fcntl
    import time

    if capacity_bytes is None:
        capacity_bytes = device_capacity()
    path = path or _boundaries_path()
    entry = {
        **_boundary_key(cfg, shards, capacity_bytes, lanes, hosts),
        "n_nodes": cfg.n_nodes,
        "fits": bool(fits),
        "peak_bytes": peak_bytes,
        "rounds_per_sec": rounds_per_sec,
        "card": card,
        "source": source,
        "ts": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
    }
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        entries = load_boundaries(path)
        entries.append(entry)
        payload = {
            "note": "Measured fit/no-fit outcomes on the card, keyed by the execution "
            "path (kernel variant, profile, shards, lanes, hosts) and the card's "
            "capacity; each names its run and the card's name and power limit. "
            "Consulted by sim.memory.fits_verdict before the model.",
            "entries": entries,
        }
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "w") as f:
            json.dump(payload, f, indent=1)
        os.replace(tmp, path)
    return entry


def fits_verdict(
    cfg: SimConfig,
    shards: int = 1,
    capacity_bytes: int | None = None,
    path: str | None = None,
    lanes: int = 1,
    hosts: int = 1,
) -> dict:
    """Will this config fit one card: measured evidence first, the plan
    second. Returns ``{"fits", "measured", "evidence", "model_fits",
    "per_shard_bytes"}``: ``measured=True`` when an outcome on the same
    execution path and capacity decides it (a recorded fit at n >= ours:
    fits; a recorded no-fit at n <= ours: does not). Where fit and no-fit
    evidence contradict each other, the more recent wins (a tie stays
    conservative)."""
    if capacity_bytes is None:
        capacity_bytes = device_capacity()
    p = plan(cfg, shards, lanes, hosts)
    key = _boundary_key(cfg, shards, capacity_bytes, lanes, hosts)
    latest: dict[int, dict] = {}
    for e in load_boundaries(path):
        if any(e.get(k) != v for k, v in key.items()):
            continue
        n = e["n_nodes"]
        if n not in latest or e.get("ts", "") >= latest[n].get("ts", ""):
            latest[n] = e
    fit_ev = oom_ev = None
    for e in latest.values():
        if e["fits"] and e["n_nodes"] >= cfg.n_nodes:
            if fit_ev is None or e["n_nodes"] < fit_ev["n_nodes"]:
                fit_ev = e
        if not e["fits"] and e["n_nodes"] <= cfg.n_nodes:
            if oom_ev is None or e["n_nodes"] > oom_ev["n_nodes"]:
                oom_ev = e
    model_fits = p.fits(capacity_bytes)
    if oom_ev is not None and fit_ev is not None:
        if fit_ev.get("ts", "") > oom_ev.get("ts", ""):
            verdict, measured, evidence = True, True, fit_ev
        else:
            verdict, measured, evidence = False, True, oom_ev
    elif oom_ev is not None:
        verdict, measured, evidence = False, True, oom_ev
    elif fit_ev is not None:
        verdict, measured, evidence = True, True, fit_ev
    else:
        verdict, measured, evidence = model_fits, False, None
    return {
        "fits": verdict,
        "measured": measured,
        "evidence": evidence,
        "model_fits": model_fits,
        "per_shard_bytes": p.per_shard_bytes,
    }


def max_scale_model(
    profile: str = "lean",
    rung: str = "int16",
    shards: int = 1,
    hosts: int = 1,
    capacity_bytes: int | None = None,
) -> dict:
    """The largest aligned population the plan fits for one (profile,
    rung, shards, hosts) cell, labelled a model (``certified: false``):
    widths of 128 x shards (256 x shards for the packed u4r rung, whose
    blocks stay whole bytes on the kernels' domain)."""
    if capacity_bytes is None:
        capacity_bytes = device_capacity()
    make_config = {"lean": lean_config, "full": full_config}[profile]
    step = (256 if rung == "u4r" else 128) * shards
    lo, hi = step, step * 20_000
    while lo + step <= hi:
        mid = ((lo + hi) // 2) // step * step
        if mid <= lo:
            break
        if plan(make_config(mid, rung=rung), shards, hosts=hosts).fits(capacity_bytes):
            lo = mid
        else:
            hi = mid
    cfg = make_config(lo, rung=rung)
    p = plan(cfg, shards, hosts=hosts)
    return {
        "profile": profile,
        "rung": rung,
        "shards": shards,
        "hosts": hosts,
        "max_nodes_model": lo,
        "bytes_per_pair": state_bytes_per_pair(cfg),
        "per_shard_bytes": p.per_shard_bytes,
        "variant": engaged_variant(cfg, shards),
        "capacity_bytes": capacity_bytes,
        "certified": False,
    }


def packed_kernel_engagement(n_nodes: int = 12_800) -> dict:
    """Whether each packed ladder rung rides its kernel on the card at a
    planning width (12,800: 256-aligned): the u4r lean rung the pairs
    kernels' nibble codec, the shrunk and deep full rungs the fused FD
    epilogue's packed bookkeeping (the round's own resolution, the
    variant override folded in)."""
    from ..ops.gossip import resolve_phases, resolve_variant_env

    def fd_fused(cfg) -> bool:
        return resolve_phases(resolve_variant_env(cfg), "cuda").fd == "fused"

    return {
        "u4r": engaged_variant(lean_config(n_nodes, rung="u4r")) == "pairs",
        "shrunk": fd_fused(full_config(n_nodes, rung="shrunk")),
        "deep": fd_fused(full_config(n_nodes, rung="deep")),
    }


def ladder_models(capacity_bytes: int | None = None) -> dict:
    """The memory ladder's planning claims on the card, each a model
    (``certified: false``): the deepest full-FD rung's B/pair and whether
    102,400 nodes of it fit 8 blocks on cards of this capacity; each lean
    rung's largest modelled single-card population."""
    if capacity_bytes is None:
        capacity_bytes = device_capacity()
    n100k = 102_400
    deep = full_config(n100k, rung="deep")
    deep_plan = plan(deep, shards=8)
    out = {
        "full_fd_deepest": {
            "rung": "deep",
            "bytes_per_pair": state_bytes_per_pair(deep),
            "target_bytes_per_pair": 9.125,
            "meets_target": state_bytes_per_pair(deep) <= 9.125,
            "n_nodes": n100k,
            "fits_x8_model": deep_plan.fits(capacity_bytes),
            "per_shard_bytes": deep_plan.per_shard_bytes,
            "certified": False,
        },
        "lean_single_card": {
            rung: max_scale_model("lean", rung, capacity_bytes=capacity_bytes)
            for rung in ("int32", "int16", "int8", "u4r")
        },
    }
    return out
