"""Carry a simulator state between the reference and the port.

The reference's ``SimState`` fields as numpy arrays (``np.asarray`` of
each field, or the arrays of a reference ``.npz`` checkpoint) become a
port ``SimState`` on a device, and back: a run started in the
reference continues in the port and computes the same thing. bfloat16
arrays (numpy has no bfloat16 of its own) are accepted as the
``ml_dtypes`` type the reference produces or as their raw uint16 bits.
The packed rungs carry across unchanged in layout: the u4r residual
bytes (N, N/2) and the live bitmap (N, N/8) (sim/packed.py).
"""

from __future__ import annotations

from collections.abc import Mapping

import numpy as np
import torch

from .config import SimConfig
from .state import DTYPES, STATE_FIELDS, SimState, expected_dtypes, expected_shapes


def _to_tensor(name: str, arr: np.ndarray, want: str, device) -> torch.Tensor:
    arr = np.asarray(arr)
    if want == "bfloat16":
        if arr.dtype.name == "bfloat16" or arr.dtype == np.uint16:
            bits = np.array(arr).view(np.uint16).astype(np.int16)
            return torch.from_numpy(bits).view(torch.bfloat16).to(device)
    elif arr.dtype.name == want:
        return torch.from_numpy(np.array(arr)).to(device)  # a writable copy
    raise ValueError(f"{name}: dtype {arr.dtype.name}, config expects {want}")


def state_from_numpy(
    arrays: Mapping[str, np.ndarray], cfg: SimConfig, device="cuda"
) -> SimState:
    """A port SimState from the reference's field arrays, validated
    against ``expected_dtypes(cfg)`` (a mismatched rung would silently
    reinterpret the values)."""
    missing = [f for f in STATE_FIELDS if f not in arrays]
    if missing:
        raise ValueError(f"missing state fields: {missing}")
    want = expected_dtypes(cfg)
    fields = {
        f: _to_tensor(f, arrays[f], want[f], torch.device(device))
        for f in STATE_FIELDS
    }
    for f, shape in expected_shapes(cfg).items():
        if tuple(fields[f].shape) != shape:
            raise ValueError(f"{f} shape {tuple(fields[f].shape)} != {shape}")
    return SimState(**fields)


def state_to_numpy(state: SimState) -> dict[str, np.ndarray]:
    """Each field as a host numpy array, in the reference's dtypes
    (bfloat16 as ``ml_dtypes.bfloat16`` when that package is present,
    else as its raw uint16 bits)."""
    out = {}
    for f in STATE_FIELDS:
        t = getattr(state, f).detach().cpu()
        if t.dtype == DTYPES["bfloat16"]:
            bits = t.view(torch.int16).numpy().view(np.uint16)
            try:
                import ml_dtypes
            except ImportError:
                out[f] = bits
            else:
                out[f] = bits.view(ml_dtypes.bfloat16)
        else:
            out[f] = t.numpy()
    return out
