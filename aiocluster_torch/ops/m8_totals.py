"""The deficit row totals of one single-pass sub-exchange: the wrapper of
the CUDA kernel (csrc/m8_totals.cu, the port of the reference's
ops/pallas_pull.py::_m8_totals_kernel) and its plain PyTorch version.

Pass A of the two-pass m8 pull: for every row ``i`` of ``w``, what it
lacks of its partner's row ``p[i]`` under the grouped matching, summed
over the owners and zero where ``valid[i]`` is false. ``m8_pull(...,
totals=...)`` applies the advance with them (pass B). ``w`` may be a
column block of the owners (``owner_offset`` its first global owner):
the blocks' totals sum to the whole width's, as the reference's sharded
form sums them across devices. With ``mv`` (the block's owners' entries)
the owner diagonal is refreshed first, as pass B refreshes it on the
round's first sub-exchange. CPU tensors take the plain version; CUDA
tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from . import _build, counters, gossip, prng
from .fd import MATRIX_DTYPES, expect


def m8_totals_plain(w, gm, c, valid, *, mv=None, owner_offset: int = 0) -> torch.Tensor:
    """The plain version of ``m8_totals`` (same operands, same (N,)
    float32 result), taken over blocks of rows so that it runs at any
    width the kernel does."""
    p = prng.rows_of_groups(gm.to(torch.int64), c.to(torch.int64))
    n_rows, n_cols = w.shape
    totals = torch.empty(n_rows, dtype=torch.float32, device=w.device)
    for r0, r1 in gossip.row_blocks(n_rows, n_cols):
        rows = torch.arange(r0, r1, device=w.device)
        d = gossip.deficits(
            gossip.refreshed_rows(w, rows, mv, col0=owner_offset),
            gossip.refreshed_rows(w, p[rows], mv, col0=owner_offset),
            valid[rows],
        )
        totals[r0:r1] = gossip.deficit_totals(d)
    return totals


def m8_totals(w, gm, c, valid, *, mv=None, owner_offset: int = 0) -> torch.Tensor:
    """(N,) float32 deficit totals of every row of one sub-exchange.

    ``w`` (N, n_local) int8/int16/int32 (read only), the owners
    ``owner_offset .. owner_offset + n_local - 1``; ``gm``/``c`` (N/8,)
    int32 the grouped matching; ``valid`` (N,) bool, per row (row ``i``'s
    total is 0 where ``valid[i]`` is false, whatever ``valid[p[i]]``);
    ``mv`` (n_local,) int32 refreshes the owner diagonal first. Totals
    are exact integer sums rounded to float32 once.

    Precondition: ``(gm, c)`` is an involution (``p[p[i]] == i``), as
    every draw of ``prng.grouped_matching`` is. The kernel visits each
    pair once, from its leader row ``i <= p[i]``, and writes both rows'
    totals; the plain version takes any matching."""
    if w.device.type == "cpu":
        counters.plain_calls["m8_totals"] += 1
        return m8_totals_plain(w, gm, c, valid, mv=mv, owner_offset=owner_offset)
    (n, n_local), dev = w.shape, w.device
    if w.dtype not in MATRIX_DTYPES:
        raise ValueError(f"w dtype {w.dtype} is not int8/int16/int32")
    if n % 8 or n_local % 8:
        raise ValueError(f"m8 totals kernel needs N and n_local % 8 == 0, got {w.shape}")
    expect("w", w, w.dtype, (n, n_local), dev)
    expect("gm", gm, torch.int32, (n // 8,), dev)
    expect("c", c, torch.int32, (n // 8,), dev)
    expect("valid", valid, torch.bool, (n,), dev)
    if mv is not None:
        expect("mv", mv, torch.int32, (n_local,), dev)
    totals = torch.empty(n, dtype=torch.float32, device=dev)
    lib = _build.load("m8_totals")
    rc = lib.aiocluster_m8_totals(
        w.data_ptr(), gm.data_ptr(), c.data_ptr(), valid.data_ptr(),
        None if mv is None else mv.data_ptr(), totals.data_ptr(), n, n_local,
        int(owner_offset), w.element_size(),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "m8_totals kernel launch")
    counters.launches[counter_key(mv is not None)] += 1
    return totals


def counter_key(diag: bool) -> str:
    """The ``counters.launches`` key of a launch in this mode."""
    return f"m8_totals[{'diag' if diag else 'sum'}]"
