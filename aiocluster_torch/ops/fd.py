"""The phi-accrual failure-detector phase: its arithmetic, its plain
PyTorch version and the wrapper of its standalone CUDA kernel
(csrc/fd.cu, the port of the reference's ops/pallas_fd.py::_fd_kernel).

``fd_update`` is the plain counterpart of the reference's
``pallas_pull.fd_update``: the same float32 operations in the same order
as the reference's XLA block, shared by both plain versions (this
module's ``fused_fd_plain`` and the pair-fused pull's epilogue in
pairs_pull.py), as csrc/fd_update.cuh is shared by both kernels.
"""

from __future__ import annotations

import dataclasses

import torch

from ..sim.packed import is_packed_live, pack_bits
from . import _build, counters


# The matrix dtypes the kernels take, one byte code each (their element
# size; csrc/common.cuh).
MATRIX_DTYPES = (torch.int8, torch.int16, torch.int32)


@dataclasses.dataclass(frozen=True)
class FdParams:
    """The FD's static constants as the f32 arithmetic sees them."""

    max_interval: float
    window: int
    prior_weight: float
    prior_wm: float  # prior_weight * prior_mean, folded on the host
    phi: float

    @classmethod
    def from_config(cls, cfg) -> "FdParams":
        return cls(
            max_interval=float(cfg.max_interval_ticks),
            window=int(cfg.window_ticks),
            prior_weight=float(cfg.prior_weight),
            prior_wm=float(cfg.prior_weight) * float(cfg.prior_mean_ticks),
            phi=float(cfg.phi_threshold),
        )


def fd_update(tick: int, hb, hb0, lc, im32, ic, k: FdParams):
    """One FD update on int32 (hb, hb0, last_change, icount) and float32
    (imean) tensors. Returns (last_change', imean', icount', live') in
    int32/float32/int32/bool, BEFORE the self diagonal and the death
    wipe (callers apply both). Python-float constants enter float32
    arithmetic rounded to float32, as JAX's weakly typed scalars do."""
    increased = hb > hb0
    never_seen = lc == 0
    interval = (tick - lc).to(torch.float32)
    sampled = increased & ~never_seen & (interval <= k.max_interval)
    icount = torch.clamp(ic + sampled.to(torch.int32), max=k.window)
    count = icount.to(torch.float32)
    denom = torch.clamp(count, min=1.0)
    imean = torch.where(sampled, im32 + (interval - im32) / denom, im32)
    lc2 = torch.where(increased, tick, lc)
    elapsed = (tick - lc2).to(torch.float32)
    lhs = elapsed * (count + k.prior_weight)
    rhs = (imean * count + k.prior_wm) * k.phi
    live = (icount >= 1) & (lhs <= rhs)
    return lc2, imean, icount, live


def fd_store(rows, lc2, imean, icount, live, lc, im, ic, live_out):
    """Finish an FD update in place: the update's results are the rows
    ``rows`` (int64 ids) against owner columns ``0..``; the self
    diagonal stays live, death wipes the window, and each result rounds
    once into its stored dtype in those rows of ``lc``/``im``/``ic``/
    ``live_out`` (bool, or the uint8 bitmap of the live_bits rung)."""
    cols = torch.arange(live.shape[1], device=live.device)
    live = live | (rows[:, None] == cols[None, :])
    lc.index_copy_(0, rows, lc2.to(lc.dtype))
    im.index_copy_(0, rows, torch.where(live, imean, torch.zeros_like(imean)).to(im.dtype))
    ic.index_copy_(0, rows, torch.where(live, icount, torch.zeros_like(icount)).to(ic.dtype))
    live_out.index_copy_(0, rows, pack_bits(live) if is_packed_live(live_out) else live)


def fused_fd_plain(tick: int, hb, hb0, hbv, lc, im, ic, live, k: FdParams):
    """The plain version of the standalone FD pass: hb0's owner diagonal
    is refreshed from ``hbv``, then the update runs in place on
    last_change/imean/icount and writes ``live``."""
    n = hb.shape[0]
    eye = torch.eye(n, dtype=torch.bool, device=hb.device)
    hb0 = torch.where(eye, hbv.to(torch.int32)[None, :], hb0.to(torch.int32))
    out = fd_update(
        tick, hb.to(torch.int32), hb0, lc.to(torch.int32),
        im.to(torch.float32), ic.to(torch.int32), k,
    )
    fd_store(torch.arange(n, device=hb.device), *out, lc, im, ic, live)


def fused_fd(tick: int, hb, hb0, hbv, lc, im, ic, live, k: FdParams):
    """One standalone FD pass, in place on ``lc``/``im``/``ic``, writing
    ``live``. The kernel takes int8/int16/int32 heartbeats with int16
    sample counters and a bool live view (the reference's FD kernel has
    no int8 counters or bitmap either). CPU tensors take the plain
    version; CUDA tensors launch csrc/fd.cu (or raise)."""
    if hb.device.type == "cpu":
        counters.plain_calls["fd"] += 1
        return fused_fd_plain(tick, hb, hb0, hbv, lc, im, ic, live, k)
    n, dev, hdt = hb.shape[0], hb.device, hb.dtype
    if hdt not in MATRIX_DTYPES:
        raise ValueError(f"heartbeat dtype {hdt} is not int8/int16/int32")
    if im.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"imean dtype {im.dtype} is not bfloat16/float32")
    if n % 8:
        raise ValueError("n must be a multiple of 8")
    for name, t, dt, shape in (
        ("hb", hb, hdt, (n, n)),
        ("hb0", hb0, hdt, (n, n)),
        ("hbv", hbv, torch.int32, (n,)),
        ("last_change", lc, hdt, (n, n)),
        ("imean", im, im.dtype, (n, n)),
        ("icount", ic, torch.int16, (n, n)),
        ("live", live, torch.bool, (n, n)),
    ):
        expect(name, t, dt, shape, dev)
    lib = _build.load("fd")
    rc = lib.aiocluster_fd(
        hb.data_ptr(), hb0.data_ptr(), hbv.data_ptr(), lc.data_ptr(),
        im.data_ptr(), ic.data_ptr(), live.data_ptr(), n, int(tick),
        k.max_interval, k.window, k.prior_weight, k.prior_wm, k.phi,
        hb.element_size(), 102 if im.dtype == torch.bfloat16 else 104,
        torch.cuda.current_stream(hb.device).cuda_stream,
    )
    _build.check(lib, rc, "fd kernel launch")
    counters.launches["fd"] += 1


def expect(name: str, t: torch.Tensor, dtype, shape, device, align: int = 16) -> None:
    """The kernels' operand contract: dtype, shape, contiguity, one CUDA
    device and 16-byte-aligned storage (8-element vector accesses;
    ``align`` for operands read one scalar at a time)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")
    if t.data_ptr() % align:
        raise ValueError(f"{name} storage must be {align}-byte aligned")
