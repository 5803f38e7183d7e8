"""Checkpoint / resume for simulated clusters (the port of the reference's
``sim/checkpoint.py``, in the same ``.npz`` container, so a file written
by either package resumes in the other).

The full SimState plus the exact SimConfig and the run's seed go into
one ``.npz`` file. A resumed run continues the trajectory (same state,
same tick, same seed) on any layout — the CPU, one card, or column
blocks of a mesh — because the round's randomness is keyed by (seed,
tick), not by host history.

Layout, field for field the reference's:

- one array per SimState field, bfloat16 stored as its uint8 bytes with
  a trailing itemsize axis (little-endian, numpy's view of the 16-bit
  words) and the dtype string ``"bfloat16"``: numpy has no bfloat16 of
  its own, and the codec needs no ``ml_dtypes``;
- ``__meta__``: the JSON ``{"config": dataclasses.asdict(cfg),
  "dtypes", "seed", "has_topology"}`` as uint8;
- a sweep file (sim/sweep.py) has a leading lane axis on every field, an
  ``__first__`` array (each lane's first converged tick) and
  ``meta["sweep"]`` (seeds, params, host_tick) instead of seed and
  topology flag.

Files are written with ``np.savez_compressed`` through a temporary file
and a rename. Loading checks the stored dtypes against the config's
rung and refuses a mismatch; an unknown config key warns and a missing
one takes its default. A config with ``heterogeneity`` is refused on
load as the reference refuses it: its metadata keeps the classes as a
dict, which ``SimConfig`` does not take.
"""

from __future__ import annotations

import dataclasses
import json
import warnings
from collections.abc import Iterable
from pathlib import Path

import numpy as np
import torch

from .carry import _to_tensor, state_from_numpy
from .config import SimConfig
from .state import DTYPES, STATE_FIELDS, SimState, expected_dtypes

_NAMES = {dt: name for name, dt in DTYPES.items()}


def _config_from_meta(raw: dict) -> SimConfig:
    """SimConfig from a checkpoint's ``dataclasses.asdict`` snapshot; a
    fault plan comes back through its own deserializer."""
    known = {f.name for f in dataclasses.fields(SimConfig)}
    kwargs = {k: v for k, v in raw.items() if k in known}
    if isinstance(kwargs.get("fault_plan"), dict):
        from ..faults.plan import FaultPlan

        kwargs["fault_plan"] = FaultPlan.from_dict(kwargs["fault_plan"])
    return SimConfig(**kwargs)


def _encode(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """(stored array, dtype string) of one host tensor: bfloat16 as the
    bytes of its 16-bit words, with a trailing itemsize axis."""
    name = _NAMES[t.dtype]
    if t.dtype == torch.bfloat16:
        arr = t.contiguous().view(torch.int16).numpy().view(np.uint8)
        return arr.reshape(tuple(t.shape) + (2,)), name
    return t.numpy(), name


def _host_field(blocks: list[SimState], name: str) -> torch.Tensor:
    """Field ``name`` of the state held as ``blocks`` (column blocks of the
    owners, in order, or one whole state; lane-batched or not) as a host
    tensor: an (N, N)-class field's blocks are copied to the host one at a
    time into one array, so no gathered copy is made on a device."""
    from ..parallel.mesh import COLUMNS, state_partition_spec

    head = getattr(blocks[0], name)
    if len(blocks) == 1 or state_partition_spec()[name] != COLUMNS or not head.numel():
        return head.detach().cpu()
    out = torch.empty((*head.shape[:-1], sum(getattr(b, name).shape[-1] for b in blocks)),
                      dtype=head.dtype)
    col = 0
    for b in blocks:
        t = getattr(b, name)
        out[..., col : col + t.shape[-1]].copy_(t)
        col += t.shape[-1]
    return out


# What the reference's jax.device_get raises for a state sharded over
# devices of other processes (jax.Array's host fetch).
ACROSS_PROCESSES = (
    "Fetching value for `jax.Array` that spans non-addressable"
    " (non process local) devices is not possible. You can use"
    " `jax.experimental.multihost_utils.process_allgather` to print the"
    " global array or use `.addressable_shards` method of jax.Array to"
    " inspect the addressable (process local) shards."
)


def refuse_across_processes(mesh) -> None:
    """Refuse to copy a state to the host whose blocks span processes, as
    the reference's ``save`` refuses it (with its words): each process
    holds only its own blocks."""
    if mesh.processes > 1:
        raise RuntimeError(ACROSS_PROCESSES)


def _encode_fields(blocks: list[SimState]) -> tuple[dict, dict[str, str]]:
    """(arrays, dtypes) of the state held as ``blocks``."""
    arrays: dict = {}
    dtypes: dict[str, str] = {}
    for name in STATE_FIELDS:
        arrays[name], dtypes[name] = _encode(_host_field(blocks, name))
    return arrays, dtypes


def _same_dtype(stored: str, want: str) -> bool:
    if "bfloat16" in (stored, want):
        return stored == want
    try:
        return np.dtype(stored) == np.dtype(want)
    except TypeError:
        return False


def _check_layout(cfg: SimConfig, dtypes: dict[str, str], path) -> None:
    """Refuse a file whose stored field dtypes are not the layout its
    config's rung implies: packed u4 residual bytes reinterpreted as
    int16 watermarks would be silent garbage."""
    exp = expected_dtypes(cfg)
    bad = {
        name: (stored, exp[name])
        for name, stored in dtypes.items()
        if name in exp and not _same_dtype(stored, exp[name])
    }
    if bad:
        detail = ", ".join(
            f"{k}: stored {s!r} != rung-expected {e!r}" for k, (s, e) in sorted(bad.items())
        )
        raise ValueError(
            f"checkpoint {path} layout does not match its config's "
            f"memory-ladder rung ({detail}); refuse to reinterpret "
            "packed/narrow state across rungs"
        )


def _decode_fields(data, dtypes: dict[str, str]) -> dict[str, np.ndarray]:
    """Inverse of _encode_fields: the fields as numpy arrays (bfloat16 as
    its raw uint16 words, which ``carry.state_from_numpy`` takes)."""
    out = {}
    for name in STATE_FIELDS:
        arr = data[name]
        if dtypes[name] == "bfloat16":
            arr = np.ascontiguousarray(arr).view(np.uint16).reshape(arr.shape[:-1])
        out[name] = arr
    return out


def _state_of(arrays: dict[str, np.ndarray], cfg: SimConfig, device) -> SimState:
    """The decoded fields as a SimState on ``device``; a sweep's lane axis
    is kept (``SweepSimulator`` checks its shapes)."""
    if arrays["tick"].ndim == 0:
        return state_from_numpy(arrays, cfg, device)
    want, dev = expected_dtypes(cfg), torch.device(device)
    return SimState(**{f: _to_tensor(f, arrays[f], want[f], dev) for f in STATE_FIELDS})


def _atomic_savez(path: Path, arrays: dict, meta: dict) -> None:
    arrays["__meta__"] = np.frombuffer(json.dumps(meta).encode(), dtype=np.uint8)
    tmp = path.with_suffix(path.suffix + ".tmp")
    with open(tmp, "wb") as fh:
        np.savez_compressed(fh, **arrays)
    tmp.replace(path)


def save_state(
    path: str | Path,
    state: SimState | Iterable[SimState],
    cfg: SimConfig,
    *,
    seed: int = 0,
    has_topology: bool = False,
) -> None:
    """Write state + config + run metadata to ``path`` (.npz, atomic via
    temp rename). ``state`` is one whole state or the column blocks of a
    mesh, in order (copied to the host one block at a time)."""
    blocks = [state] if isinstance(state, SimState) else list(state)
    arrays, dtypes = _encode_fields(blocks)
    meta = {
        "config": dataclasses.asdict(cfg),
        "dtypes": dtypes,
        "seed": seed,
        "has_topology": has_topology,
    }
    _atomic_savez(Path(path), arrays, meta)


def save_sweep(
    path: str | Path,
    states: SimState | Iterable[SimState],
    cfg: SimConfig,
    *,
    seeds: list[int],
    params: dict[str, list],
    first,
    host_tick: int,
) -> None:
    """Checkpoint a lane-batched sweep (sim/sweep.py): the (S, ...)
    state plus the per-lane seeds, the declared sweep values and the
    convergence accumulator. ``meta["sweep"]`` marks the layout so
    load_state refuses it loudly. ``states`` is one lane-batched state or
    the column blocks of a mesh, in order (copied to the host one block
    at a time)."""
    arrays, dtypes = _encode_fields([states] if isinstance(states, SimState) else list(states))
    arrays["__first__"] = np.asarray(torch.as_tensor(first).cpu(), np.int32)
    meta = {
        "config": dataclasses.asdict(cfg),
        "dtypes": dtypes,
        "sweep": {
            "seeds": [int(s) for s in seeds],
            "params": {k: list(v) for k, v in params.items()},
            "host_tick": int(host_tick),
        },
    }
    _atomic_savez(Path(path), arrays, meta)


def load_sweep(path: str | Path, *, device="cuda") -> tuple[SimState, SimConfig, dict]:
    """Read a sweep checkpoint; returns (lane-batched states on
    ``device``, config, meta) with meta carrying ``seeds``, ``params``,
    ``first`` and ``host_tick``."""
    with np.load(Path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if "sweep" not in meta:
            raise ValueError("not a sweep checkpoint (single-sim file? use load_state)")
        cfg = _config_from_meta(dict(meta["config"]))
        _check_layout(cfg, meta["dtypes"], path)
        states = _state_of(_decode_fields(data, meta["dtypes"]), cfg, device)
        out_meta = dict(meta["sweep"])
        out_meta["first"] = np.asarray(data["__first__"])
    return states, cfg, out_meta


def load_state(path: str | Path, *, device="cuda") -> tuple[SimState, SimConfig, dict]:
    """Read a checkpoint; returns (state on ``device``, config, meta)
    where meta carries ``seed`` and ``has_topology``. The caller shards
    it (``parallel.shard_state``) when resuming on a mesh."""
    with np.load(Path(path)) as data:
        meta = json.loads(bytes(data["__meta__"]).decode())
        if "sweep" in meta:
            raise ValueError(
                "lane-batched sweep checkpoint; use load_sweep / SweepSimulator.resume"
            )
        # Tolerate config keys this version doesn't know (a NEWER
        # writer's fields): unknown knobs can't influence a build that
        # lacks them. Missing keys take their defaults (an OLDER writer).
        known = {f.name for f in dataclasses.fields(SimConfig)}
        raw = dict(meta["config"])
        unknown = sorted(set(raw) - known)
        if unknown:
            warnings.warn(
                f"checkpoint config has unknown keys {unknown} "
                "(written by a newer version?); ignoring them",
                stacklevel=2,
            )
        cfg = _config_from_meta(raw)
        _check_layout(cfg, meta["dtypes"], path)
        state = _state_of(_decode_fields(data, meta["dtypes"]), cfg, device)
    return state, cfg, meta
