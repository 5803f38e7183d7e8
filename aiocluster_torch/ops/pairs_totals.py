"""The deficit row totals of one pair-fused sub-exchange: the wrapper of
the CUDA kernel (csrc/pairs_totals.cu, the port of the reference's
ops/pallas_pull.py::_pairs_totals_kernel) and its plain PyTorch version.

Pass A of the two-pass pull: for every row ``i`` of ``w``, what it lacks
of its partner's row ``p[i]`` under the grouped matching, summed over
the owners and zero where the pair is not alive. ``pairs_pull(...,
totals=...)`` applies the advance with them (pass B). With ``mv`` the
owner diagonal is refreshed first, exactly as pass B refreshes it on the
round's first sub-exchange (on the packed u4r rung ``mv`` is the
owners' write bump, as in pass B). ``w`` may be a column block of the
owners (``owner_offset`` its first global owner, the reference's
owner-sharded form): its totals are the block's share of each row's,
and the blocks' shares sum to the whole width's. ``pairs_totals_lanes`` is the lane
lift of a sweep (the reference's ``fused_pull_pairs_totals_lanes``): a
leading lane axis on every operand, one launch for all lanes. CPU
tensors take the plain version; CUDA tensors launch the kernel or raise.
"""

from __future__ import annotations

import torch

from ..sim.packed import is_packed_w, pack_u4
from . import _build, counters, gossip, prng
from .fd import MATRIX_DTYPES, expect
from .pairs_pull import U4_CODE, check_block, owner_columns


def pairs_totals_plain(w, gm, c, valid, *, mv=None, owner_offset: int = 0) -> torch.Tensor:
    """The plain version of ``pairs_totals`` (same operands, same (N,)
    float32 result), taken over blocks of row pairs so that it runs at
    any width the kernel does."""
    p = prng.rows_of_groups(gm.to(torch.int64), c.to(torch.int64))
    totals = torch.empty(w.shape[0], dtype=torch.float32, device=w.device)
    col0 = int(owner_offset)
    for rows, partners in gossip.pair_row_blocks(p):
        if is_packed_w(w):
            totals[rows] = gossip.packed_totals(
                gossip.refreshed_packed_rows(w, rows, mv, col0),
                gossip.refreshed_packed_rows(w, partners, mv, col0),
                valid[rows],
            )
            continue
        d = gossip.deficits(
            gossip.refreshed_rows(w, rows, mv, col0=col0),
            gossip.refreshed_rows(w, partners, mv, col0=col0),
            valid[rows],
        )
        totals[rows] = gossip.deficit_totals(d)
    return totals


def pairs_totals(w, gm, c, valid, *, mv=None, owner_offset: int = 0) -> torch.Tensor:
    """(N,) float32 deficit totals of every row of one sub-exchange.

    ``w`` (N, N) int8/int16/int32 or (N, N/2) uint8 (the packed u4r
    rung), read only, or a column block of it, (N, n_local) (packed:
    (N, n_local/2)), of the owners ``owner_offset ..``; ``gm``/``c``
    (N/8,) int32 the grouped matching; ``valid`` (N,) bool the
    alive-pair mask per row; ``mv`` (the block's owners, int32)
    refreshes the owner diagonal first (packed: the write bump). Totals
    are exact integer sums rounded to float32 once: a block's are its
    columns' share."""
    if w.device.type == "cpu":
        counters.plain_calls["totals"] += 1
        return pairs_totals_plain(w, gm, c, valid, mv=mv, owner_offset=owner_offset)
    return _launch(w, gm, c, valid, mv, (), int(owner_offset))


def pairs_totals_lanes_plain(w, gm, c, valid, *, mv=None) -> torch.Tensor:
    """The plain version of ``pairs_totals_lanes``: ``pairs_totals_plain``
    on each lane's operands, lane after lane."""
    return torch.stack([
        pairs_totals_plain(w[s], gm[s], c[s], valid[s], mv=None if mv is None else mv[s])
        for s in range(w.shape[0])
    ])


def pairs_totals_lanes(w, gm, c, valid, *, mv=None) -> torch.Tensor:
    """(S, N) float32 deficit totals of one sub-exchange of S sweep lanes
    in one launch: ``pairs_totals`` with a leading lane axis on every
    operand."""
    if w.device.type == "cpu":
        counters.plain_calls["totals"] += 1
        return pairs_totals_lanes_plain(w, gm, c, valid, mv=mv)
    return _launch(w, gm, c, valid, mv, (w.shape[0],))


def _launch(w, gm, c, valid, mv, lanes, owner_offset=0) -> torch.Tensor:
    """Check the operands of a launch over ``lanes`` (``()`` or (S,)) on
    the block of owners from ``owner_offset`` and launch the kernel."""
    n, dev = w.shape[-2], w.device
    packed = is_packed_w(w)
    if not packed and w.dtype not in MATRIX_DTYPES:
        raise ValueError(f"w dtype {w.dtype} is not int8/int16/int32/uint8")
    n_cols = owner_columns(w)
    check_block(n, n_cols, owner_offset, packed)
    expect("w", w, w.dtype, (*lanes, n, w.shape[-1]), dev)
    expect("gm", gm, torch.int32, (*lanes, n // 8), dev)
    expect("c", c, torch.int32, (*lanes, n // 8), dev)
    expect("valid", valid, torch.bool, (*lanes, n), dev)
    if mv is not None:
        expect("mv", mv, torch.int32, (*lanes, n_cols), dev)
        if packed:
            mv = pack_u4(mv)  # the write bumps as nibbles, each clipped to 15
    totals = torch.empty((*lanes, n), dtype=torch.float32, device=dev)
    lib = _build.load("pairs_totals")
    rc = lib.aiocluster_pairs_totals(
        w.data_ptr(), gm.data_ptr(), c.data_ptr(), valid.data_ptr(),
        None if mv is None else mv.data_ptr(), totals.data_ptr(), n, n_cols,
        owner_offset, U4_CODE if packed else w.element_size(), lanes[0] if lanes else 1,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "pairs_totals kernel launch")
    counters.launches[counter_key(mv is not None, packed, lanes=bool(lanes))] += 1
    return totals


def counter_key(diag: bool, packed: bool = False, lanes: bool = False) -> str:
    """The ``counters.launches`` key of a launch in this mode (``lanes``:
    a lane launch of a sweep)."""
    flags = ("lanes+" if lanes else "") + ("packed+" if packed else "")
    return f"pairs_totals[{flags}{'diag' if diag else 'sum'}]"
