"""Packed state dtypes: the u4 residual watermark rung and bit-packed
liveness, plus the helpers that widen them (the port's copy of the
reference's ``sim/packed.py``, on torch tensors).

- ``version_dtype="u4r"`` stores each watermark as a saturating residual
  below the owner's max_version, ``r[i, j] = clip(max_version[j] -
  w[i, j], 0, 15)``, two residuals per byte (0.5 B/pair): byte column
  ``k`` holds owner ``2k`` in the low nibble and ``2k + 1`` in the high
  nibble. Residual space is closed under the gossip math: one
  direction's deficit is ``max(r_recv - r_send, 0)``, an advance of
  ``a`` key-versions is ``r -= a``, the owner-diagonal refresh is
  ``r = 0`` and full convergence is ``r == 0``, so the round computes on
  the nibbles (ops/gossip.py) and only metrics and tests widen.
- ``live_bits=True`` stores the failure detector's live view as a
  column-packed bitmap: column ``j`` is bit ``j % 8`` of byte ``j // 8``
  (1 bit/pair instead of bool's byte).
"""

from __future__ import annotations

import torch

U4_MAX = 15  # saturating residual ceiling (one nibble)

__all__ = (
    "U4_MAX",
    "imean_f32",
    "is_packed_live",
    "is_packed_w",
    "live_view_bool",
    "pack_bits",
    "pack_u4",
    "residuals_u4",
    "unpack_bits",
    "unpack_u4",
    "watermarks_i32",
)


# -- u4 residual codec (two values per byte, column-packed) -------------------


def pack_u4(values: torch.Tensor) -> torch.Tensor:
    """(..., n) integer residuals -> (..., n // 2) uint8, column 2k in
    the low nibble and 2k + 1 in the high nibble. Values outside
    [0, 15] saturate (they do not wrap)."""
    v = torch.clamp(values, 0, U4_MAX).to(torch.uint8)
    return v[..., 0::2] | (v[..., 1::2] << 4)


def unpack_u4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_u4`: (..., n // 2) uint8 -> (..., n) int32
    residuals."""
    lo = (packed & 0xF).to(torch.int32)
    hi = (packed >> 4).to(torch.int32)
    return torch.stack((lo, hi), dim=-1).reshape(*packed.shape[:-1], -1)


def is_packed_w(w: torch.Tensor) -> bool:
    """Whether a watermark matrix is the packed u4 residual form: every
    unpacked rung is signed, only the packed rung stores uint8 bytes."""
    return w.dtype == torch.uint8


# -- liveness bitmap (eight pairs per byte, column-packed) --------------------


def pack_bits(mask: torch.Tensor) -> torch.Tensor:
    """(..., n) bool -> (..., n // 8) uint8 bitmap, column j in bit
    j % 8 of byte j // 8."""
    b = mask.to(torch.uint8).reshape(*mask.shape[:-1], -1, 8)
    weights = 1 << torch.arange(8, dtype=torch.uint8, device=mask.device)
    return (b * weights).sum(dim=-1, dtype=torch.uint8)


def unpack_bits(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of :func:`pack_bits`: (..., n // 8) uint8 -> (..., n) bool."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed[..., :, None] >> shifts) & 1
    return (bits > 0).reshape(*packed.shape[:-1], -1)


def is_packed_live(live_view: torch.Tensor) -> bool:
    """Whether a live view is the packed bitmap form (unpacked views
    store bool)."""
    return live_view.dtype == torch.uint8


# -- widening helpers ---------------------------------------------------------


def watermarks_i32(state, owners: torch.Tensor | None = None, rows=None) -> torch.Tensor:
    """The watermark matrix as int32 values for any rung (of the rows
    ``rows``, a slice or index tensor, when given). Packed states store
    residuals below the owner's max_version, so the decode reads the
    max_version of each column's owner (``owners``; ``arange`` by
    default)."""
    w = state.w if rows is None else state.w[rows]
    if not is_packed_w(w):
        return w.to(torch.int32)
    r = unpack_u4(w)
    if owners is None:
        owners = torch.arange(r.shape[-1], device=r.device)
    return state.max_version[owners].to(torch.int32)[None, :] - r


def residuals_u4(state) -> torch.Tensor:
    """The stored residuals of a packed state as int32 (raises on the
    unpacked rungs: callers that want values use watermarks_i32)."""
    if not is_packed_w(state.w):
        raise ValueError("state.w is not the packed u4 residual rung")
    return unpack_u4(state.w)


def live_view_bool(state, rows=None) -> torch.Tensor:
    """live_view as bool for any rung (of the rows ``rows`` when given),
    unpacking the bitmap form."""
    lv = state.live_view if rows is None else state.live_view[rows]
    return unpack_bits(lv) if is_packed_live(lv) else lv


def imean_f32(imean: torch.Tensor) -> torch.Tensor:
    """The FD's stored interval mean widened to the float32 its update
    runs in."""
    return imean.to(torch.float32)
