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


# -- the kernel's arithmetic on 1-byte rows, mirrored ---------------------------
#
# csrc/pairs.cuh sums the rows of 1-byte elements (int8, packed u4r) on
# 32-bit words of four bytes: the packed write-bump refresh as saturating
# adds of nibble lanes, each direction's deficit sum as (A +- D) / 2 with
# A = sum |y - x| and D = sum (y - x). The kernel runs only on a card, so
# these plain mirrors of that word arithmetic are what the CPU tests hold
# against the plain versions, bit for bit.

NIBBLES, BYTE_ONES = 0x0F0F0F0F, 0x01010101


def _words(b: torch.Tensor) -> torch.Tensor:
    """(..., B) uint8 or int8 bytes, B a multiple of 4, as (..., B/4)
    int64 holding the little-endian 32-bit words."""
    k = torch.arange(4, device=b.device) * 8
    by = (b.to(torch.int64) & 0xFF).reshape(*b.shape[:-1], -1, 4)
    return (by << k).sum(dim=-1)


def _word_bytes(words: torch.Tensor) -> torch.Tensor:
    """(..., W) int64 words as their (..., 4 W) bytes (0..255, int64)."""
    k = torch.arange(4, device=words.device) * 8
    return ((words[..., None] >> k) & 0xFF).flatten(-2)


def sat_nibbles(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """min(a + b, 15) in every byte of words of nibble lanes (bytes
    0..15): a byte's sum is at most 30, so bit 4 marks the ones to clamp
    (pairs.cuh ``sat_nibbles``)."""
    s = a + b
    return (s | (((s >> 4) & BYTE_ONES) * 15)) & NIBBLES


def packed_lanes_swar(x: torch.Tensor, bump, rows, col0: int = 0):
    """The kernel's packed refresh of rows ``x`` ((R, B) uint8, global
    rows ``rows``) on words of nibble lanes: (lo, hi) int64 words, lo
    holding owners 2k and hi owners 2k + 1 of byte k one to a byte, each
    plus its owner's bump (``bump`` (B,) uint8, packed nibbles)
    saturating at 15, then the row's own owner zeroed (pairs.cuh
    ``packed_step_lanes``). ``bump`` None: the lanes as stored."""
    w = _words(x)
    lo, hi = w & NIBBLES, (w >> 4) & NIBBLES
    if bump is None:
        return lo, hi
    b = _words(bump)[None, :]
    lo = sat_nibbles(lo, b & NIBBLES)
    hi = sat_nibbles(hi, (b >> 4) & NIBBLES)
    t = rows.to(torch.int64) - col0  # the own owner's nibble in the row
    hit = (t >= 0) & (t < 2 * x.shape[1])
    at, t = torch.arange(x.shape[0], device=x.device)[hit], t[hit]
    keep = ~(0xFF << (8 * ((t & 7) >> 1))) & 0xFFFFFFFF
    for lanes, odd in ((lo, False), (hi, True)):
        sel = (t & 1) == int(odd)
        lanes[at[sel], t[sel] >> 3] &= keep[sel]
    return lo, hi


def packed_refresh_swar(x: torch.Tensor, bump, rows, col0: int = 0) -> torch.Tensor:
    """``packed_lanes_swar`` packed back into bytes: the refreshed rows
    as ``gossip.refreshed_packed_rows`` gives them."""
    lo, hi = packed_lanes_swar(x, bump, rows, col0)
    return _word_bytes(lo | (hi << 4)).to(torch.uint8)


def narrow_pair_sums(x, y, vi, vp, *, bump=None, rows_i=None, rows_p=None, col0: int = 0):
    """Both directions' exact deficit sums (int64 (R,)) of 1-byte row
    pairs as the kernel takes them: A = sum |y - x| and D = sum (y - x)
    over the words' bytes (packed: over the nibble lanes, refreshed with
    ``bump``, and D = sum (x - y), the residuals' direction), row i's sum
    (A + D) / 2 where ``vi``, row p's (A - D) / 2 where ``vp``. int8 rows
    read their bytes as signed."""
    if x.dtype == torch.uint8:
        xl, xh = packed_lanes_swar(x, bump, rows_i, col0)
        yl, yh = packed_lanes_swar(y, bump, rows_p, col0)
        xs = _word_bytes(xl) + _word_bytes(xh)
        ys = _word_bytes(yl) + _word_bytes(yh)
        a = ((_word_bytes(xl) - _word_bytes(yl)).abs()
             + (_word_bytes(xh) - _word_bytes(yh)).abs()).sum(dim=1)
        d = (xs - ys).sum(dim=1)
    else:
        def signed(r):
            by = _word_bytes(_words(r))
            return torch.where(by > 127, by - 256, by)

        xs, ys = signed(x), signed(y)
        a = (ys - xs).abs().sum(dim=1)
        d = (ys - xs).sum(dim=1)
    return torch.where(vi, (a + d) >> 1, 0), torch.where(vp, (a - d) >> 1, 0)
