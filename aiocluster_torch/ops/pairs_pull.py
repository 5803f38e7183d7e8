"""One pair-fused gossip sub-exchange: the wrapper of the CUDA kernel
(csrc/pairs_pull.cu, the port of the reference's
ops/pallas_pull.py::_pairs_kernel) and its plain PyTorch version.

A sub-exchange of a grouped matching: every row ``i`` pulls from its
partner ``p[i] = 8*gm[g] + (r - c[g]) % 8`` under the per-exchange
budget (the proportional, hash-dithered advance) and absorbs the
partner's heartbeat knowledge, both directions computed from the
pre-exchange rows. Optional modes, as on the TPU: the owner-diagonal
refresh (``mv``/``hbv``, the round's first sub-exchange), the
all-converged check (``check``, the last), the fused failure-detector
epilogue (``fd``, the last; int16 or int8 sample counters, a bool live
view or the live bitmap) and the rows' deficit totals given as an input
(``totals``, from ops/pairs_totals.py: the two-pass form, which needs no
shared memory and so takes any width). A uint8 ``w`` is the packed u4r
rung (sim/packed.py; lean profile only, as in the reference): ``mv`` is
then the owners' write bump of the round.

Without ``totals`` a row pair is staged in shared memory by a
thread-block cluster of ``cluster`` CTAs, each holding its slice of both
rows (the cluster frame of csrc/pairs_pull.cu). ``pull_form`` is the one
rule for the form a round takes and the cluster size it stages with.

``owner_offset`` runs the sub-exchange on a column block of the owners
(the reference's owner-sharded form): the (N, n_local) matrices hold the
global owners ``owner_offset ..``, rows stay global, and ``mv``/``hbv``
and the check's owner vectors are the block's (n_local,) slices. A
block's own sums cover only its columns, so the sharded round feeds
every block the rows' global totals (the blocks' ``pairs_totals``
shares, summed).

``pairs_pull_lanes`` is the lane lift of a sweep (the reference's
``fused_pull_pairs_lanes``): every operand carries a leading lane axis S,
each lane with its own salt and FD phi, and one launch serves all S
lanes; lane s computes exactly ``pairs_pull`` on lane s's operands.

Both versions update ``w``/``hb`` (and the FD bookkeeping) IN PLACE and
write ``fd.live``. CPU tensors take the plain version; CUDA tensors
launch the kernel or raise.
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from ..sim.packed import is_packed_live, is_packed_w, pack_u4
from . import _build, counters, gossip, prng
from . import fd as fd_mod
from .fd import MATRIX_DTYPES, FdParams, expect

SMEM_LIMIT = 232_448  # bytes of shared memory one H100 block may use
# Static shared memory of the kernel: block_sum's 32 long long partials
# (csrc/common.cuh); chip_smoke.py holds it against the compiled kernel.
STATIC_SMEM = 32 * 8
U4_CODE = 100  # the packed u4r rung's dtype code (csrc/common.cuh kU4)

# The cluster frame. A cluster holds 1, 2, 4 or 8 CTAs (8: the portable
# maximum); an H100 SM has 228 KB of shared memory, of which the runtime
# keeps 1 KB per resident CTA. The kernel's registers (<= 128 a thread of
# 256) let 2 CTAs share an SM, and the rule asks for that: at one CTA per
# SM a staged pair's loads leave the SM idle while they land.
CLUSTER_SIZES = (1, 2, 4, 8)
SM_SMEM = 233_472
CTA_SMEM_RESERVED = 1_024
CTAS_PER_SM = 2
# Rows of 1-byte elements (int8, packed u4r) stage only up to this many
# bytes a row. Their pulls are bound by instructions, not bytes, and on
# one H100 the two-pass form ran them faster than the staged one at every
# wider row measured (int8 and u4r at 100,352 owners, u4r at 262,144, the
# deep rung at 49,152: rows of 48 to 131 KB); at 10,240 owners (rows of
# 5 and 10 KB) the two forms ran the same (PERF.md).
NARROW_STAGED_BYTES = 16 * 1024


@dataclasses.dataclass(frozen=True)
class FdOperands:
    """The fused FD epilogue's operands: the round's tick, the FD
    bookkeeping (updated in place), the live view (written), the
    round-start heartbeat matrix (None at fanout == 1, where the input hb
    IS the round-start matrix) and the constants. A lane launch may give
    ``phi``, an (S,) float32 tensor of each lane's threshold, in place of
    ``params.phi``."""

    tick: int
    lc: torch.Tensor
    im: torch.Tensor
    ic: torch.Tensor
    live: torch.Tensor
    hb0: torch.Tensor | None
    params: FdParams
    phi: torch.Tensor | None = None

    def lane(self, s: int) -> "FdOperands":
        """Lane ``s``'s operands of a lane launch, with its own phi."""
        params = self.params
        if self.phi is not None:
            params = dataclasses.replace(params, phi=float(self.phi[s]))
        return FdOperands(
            self.tick, self.lc[s], self.im[s], self.ic[s], self.live[s],
            None if self.hb0 is None else self.hb0[s], params,
        )


def staged_smem(row_len: int, itemsize: int, k: int) -> int:
    """Dynamic shared memory of one CTA of a ``k``-CTA cluster staging
    rows of ``row_len`` stored elements of ``itemsize`` bytes: its slice
    of both rows in whole 8-element chunks and, for k > 1, the two
    partial sums the cluster reads (csrc/pairs_pull.cu ``staged_smem``)."""
    per = -(-(row_len // 8) // k)
    return 2 * per * 8 * itemsize + (16 if k > 1 else 0)


def cluster_fits(row_len: int, itemsize: int, k: int, ctas: int = 1) -> bool:
    """Whether ``ctas`` CTAs of a ``k``-CTA cluster over such rows share
    one SM's shared memory, each within a block's limit."""
    smem = staged_smem(row_len, itemsize, k) + STATIC_SMEM
    return (
        row_len % 8 == 0 and k in CLUSTER_SIZES and smem <= SMEM_LIMIT
        and ctas * (smem + CTA_SMEM_RESERVED) <= SM_SMEM
    )


def cluster_size(row_len: int, itemsize: int, ctas: int = CTAS_PER_SM) -> int | None:
    """The smallest cluster whose CTAs stage a pair of such rows with
    ``ctas`` CTAs to an SM, or None."""
    return next((k for k in CLUSTER_SIZES if cluster_fits(row_len, itemsize, k, ctas)), None)


def pull_form(row_len: int, itemsize: int, blocks: int = 1) -> tuple[str, int]:
    """The one rule for the pull kernels' form of a round's
    sub-exchanges over rows of ``row_len`` stored elements of
    ``itemsize`` bytes (a packed u4r row stores n / 2 bytes), held as
    ``blocks`` column blocks of the owners, with the CTAs that stage a
    pair: ("pairs", 1) where one CTA stages a pair and another fits
    beside it on its SM; ("pairs_cluster", k) where a cluster of the
    smallest k > 1 does (one launch a sub-exchange either way);
    ("pairs_two_pass", 1), the totals pass then the pull fed them, on the
    column blocks of a mesh (a block's own sums are not the rows' totals),
    for rows of 1-byte elements wider than ``NARROW_STAGED_BYTES``, and
    where no cluster of 8 lets two CTAs share an SM. The m8 pull, which
    runs the same frame out of place, takes the same forms under its own
    names (``gossip.kernel_pull_form``)."""
    k = cluster_size(row_len, itemsize) if blocks == 1 else None
    if k is None or (itemsize == 1 and row_len > NARROW_STAGED_BYTES):
        return "pairs_two_pass", 1
    return ("pairs" if k == 1 else "pairs_cluster"), k


def compiled_static_smem(name: str = "pairs_pull") -> int:
    """The static shared memory in bytes of library ``name``'s staged
    kernel (``_build.STATIC_SMEM_QUERIES``), as the CUDA runtime reports
    it (needs a CUDA device)."""
    lib = _build.load(name)
    out = ctypes.c_int(0)
    query = getattr(lib, f"aiocluster_{name}_static_smem")
    _build.check(lib, query(ctypes.byref(out)), f"{name} static shared memory query")
    return out.value


def owner_columns(w) -> int:
    """The owners a watermark matrix (or column block) holds: its width,
    twice its stored width on the packed u4r rung."""
    return w.shape[-1] * (2 if is_packed_w(w) else 1)


def pairs_pull_plain(
    w, hb, gm, c, valid, salt, run_salt, budget, *,
    mv=None, hbv=None, check=None, fd: FdOperands | None = None, totals=None,
    owner_offset: int = 0, leaders=None,
):
    """The plain version of ``pairs_pull`` (same operands, same in-place
    effect, same returned flag). It runs over blocks of row pairs: each
    block's rows are computed from their pre-exchange values and written
    back, as the kernel's CTAs do, so it runs at any width the kernel
    does. ``leaders`` (int64 leader rows ``i <= p[i]``) computes only
    those rows' pairs (and their flag): a sample, for holding a kernel
    launch at a width where a second copy of every matrix does not
    fit."""
    dev = w.device
    packed = is_packed_w(w)
    _check_packed(packed, hb, fd)
    p = prng.rows_of_groups(gm.to(torch.int64), c.to(torch.int64))
    col0 = int(owner_offset)
    owners = col0 + torch.arange(owner_columns(w), device=dev)
    ok = torch.ones((), dtype=torch.bool, device=dev)
    if check is not None:
        needed, alive, alive_owner = check
        need = torch.where(alive_owner, needed.to(torch.int32), 0)
    for rows, partners in gossip.pair_row_blocks(p, leaders):
        v = valid[rows]
        row_totals = None if totals is None else totals[rows]
        if packed:
            x = gossip.refreshed_packed_rows(w, rows, mv, col0)
            a_lo, a_hi = gossip.packed_adv_halves(
                x, gossip.refreshed_packed_rows(w, partners, mv, col0), budget, v, salt,
                owners, run_salt, row_totals, rows,
            )
            w_new = gossip.packed_apply(x, a_lo, a_hi)
            if check is not None:
                # A zero residual is caught up; dead owners are excused.
                lo, hi = gossip.nibbles(w_new)
                caught = ((lo == 0) | ~alive_owner[0::2]) & ((hi == 0) | ~alive_owner[1::2])
                ok &= (caught | ~alive[rows, None]).all()
        else:
            x = gossip.refreshed_rows(w, rows, mv, col0=col0)
            adv = gossip.budgeted_advance(
                x, gossip.refreshed_rows(w, partners, mv, col0=col0), budget, v, salt,
                owners, run_salt, row_totals, rows,
            )
            w_new = x + adv
            if check is not None:
                ok &= ((w_new.to(torch.int32) >= need[None, :]) | ~alive[rows, None]).all()
        if hb is not None:
            hb_diag = hbv if mv is not None else None
            h = gossip.refreshed_rows(hb, rows, hb_diag, col0=col0)
            h_p = gossip.refreshed_rows(hb, partners, hb_diag, col0=col0)
            hb_new = torch.maximum(h, torch.where(v[:, None], h_p, 0))
            if fd is not None:
                if fd.hb0 is not None:
                    hb0 = gossip.refreshed_rows(fd.hb0, rows, hbv, torch.int32, col0)
                else:
                    hb0 = h.to(torch.int32)
                out = fd_mod.fd_update(
                    fd.tick, hb_new.to(torch.int32), hb0, fd.lc[rows].to(torch.int32),
                    fd.im[rows].to(torch.float32), fd.ic[rows].to(torch.int32), fd.params,
                )
                fd_mod.fd_store(rows, *out, fd.lc, fd.im, fd.ic, fd.live, col0)
            hb.index_copy_(0, rows, hb_new)
        w.index_copy_(0, rows, w_new)
    return None if check is None else ok.to(torch.int32).reshape(1)


def exchange_once(x, y, vi, vp, rows_i, rows_p, owners, salt_mix, budget, *, packed=False):
    """The kernel's exchange body (csrc/pairs_pull.cu, ONE ADVANCE PER
    COLUMN PAIR) on row pairs: ``x`` (R, C) the rows i and ``y`` their
    partner rows p, pre-exchange and refreshed (int8/int16/int32
    watermarks, or packed u4r bytes with ``packed``), ``vi``/``vp`` (R,)
    their valid flags, ``rows_i``/``rows_p`` (R,) their global row ids,
    ``owners`` the global owners of the logical columns, ``salt_mix`` the
    sub-exchange salt xor the run's. Each column pair's receiving row is
    decided first (the one behind: y > x takes row i; packed residuals
    the other way round), its deficit masked by that row's valid flag,
    and one hash, one dither and one advance serve it; the rows' totals
    are summed exactly over the C columns. Returns (nx, ny) in x's dtype.
    The plain versions advance both directions (``gossip.budgeted_advance``,
    ``packed_adv_halves``); the tests hold the two equal."""
    if packed:
        def logical(r):
            lo, hi = gossip.nibbles(r)
            return torch.stack((lo, hi), dim=-1).flatten(-2)

        xs, ys = logical(x), logical(y)
        lag = xs - ys
    else:
        xs, ys = x.to(torch.int32), y.to(torch.int32)
        lag = ys - xs
    to_i = lag > 0
    d = torch.where(to_i, lag * vi[:, None], -lag * vp[:, None])
    tot_i = torch.where(to_i, d, 0).sum(dim=1, dtype=torch.int64).to(torch.float32)
    tot_p = torch.where(to_i, 0, d).sum(dim=1, dtype=torch.int64).to(torch.float32)
    scale = torch.where(to_i, gossip.budget_scale(tot_i, budget)[:, None],
                        gossip.budget_scale(tot_p, budget)[:, None])
    recv = torch.where(to_i, rows_i.to(torch.int64)[:, None], rows_p.to(torch.int64)[:, None])
    u = gossip.dither24(gossip.hash_mix_u32(recv, owners.to(torch.int64)[None, :], salt_mix))
    share = d.to(torch.float32) * scale
    floor = torch.floor(share)
    adv = torch.minimum(floor.to(torch.int32) + (u < share - floor).to(torch.int32), d)
    step = -adv if packed else adv
    nx = xs + torch.where(to_i, step, 0)
    ny = ys + torch.where(to_i, 0, step)
    if packed:
        return tuple(gossip.pack_halves(r[:, 0::2], r[:, 1::2]) for r in (nx, ny))
    return nx.to(x.dtype), ny.to(y.dtype)


def _check_packed(packed: bool, hb, fd) -> None:
    """The packed rung is lean-only in the pairs kernel, as in the
    reference (its nibble codec carries no hb or FD tiles)."""
    if packed and (hb is not None or fd is not None):
        raise ValueError("packed u4 w is lean-only in the pairs kernel (no hb/FD)")


def pairs_pull(
    w, hb, gm, c, valid, salt, run_salt, budget, *,
    mv=None, hbv=None, check=None, fd: FdOperands | None = None, totals=None,
    owner_offset: int = 0, cluster: int | None = None,
):
    """One pair-fused sub-exchange, in place.

    ``w`` (N, N) int8/int16/int32, or (N, N/2) uint8 (the packed u4r
    rung, with ``hb`` and ``fd`` None), and ``hb`` (N, N)
    int8/int16/int32 or None (the lean profile); or each a column block
    (N, n_local) of the owners ``owner_offset ..`` (packed: (N,
    n_local/2)), with every owner vector below the block's (n_local,)
    slice and the FD matrices blocks too; ``gm``/``c`` (N/8,)
    int32 the grouped matching; ``valid`` (N,) bool the alive-pair mask
    per row; ``salt`` the sub-exchange salt and ``run_salt`` the run's;
    ``budget`` key-versions per exchange. ``mv``/``hbv`` (N,) int32
    refresh the owner diagonal first (``hbv`` also refreshes the FD's
    hb0 diagonal; packed: ``mv`` is the owners' write bump, which raises
    every residual, saturating, before the diagonal zeroes). ``check`` =
    (needed, alive, alive_owner) asks for the all-converged flag of the
    output (of the block's columns: ``needed`` and ``alive_owner`` are
    per owner, ``alive`` (N,) per row), returned as a (1,) int32 tensor
    (None without ``check``).
    ``fd`` runs the FD phase on the post-exchange heartbeat rows.
    ``totals`` (N,) float32, the rows' deficit totals of this
    sub-exchange (``pairs_totals`` on the same operands), scales the
    advance instead of the kernel's own sums: no row is staged, so any
    width runs. Without ``totals``, ``cluster`` CTAs (1, 2, 4 or 8) stage
    each row pair; None takes ``cluster_size``'s. The plain version has
    no clusters: the result is the same bits for every size."""
    if w.device.type == "cpu":
        counters.plain_calls["pull"] += 1
        return pairs_pull_plain(
            w, hb, gm, c, valid, salt, run_salt, budget,
            mv=mv, hbv=hbv, check=check, fd=fd, totals=totals, owner_offset=owner_offset,
        )
    salt_mix = (int(salt) & prng.M32) ^ (int(run_salt) & prng.M32)
    return _launch(w, hb, gm, c, valid, salt_mix, budget, (), mv, hbv, check, fd, totals,
                   int(owner_offset), cluster)


def pairs_pull_lanes_plain(
    w, hb, gm, c, valid, salt_mix, budget, *,
    mv=None, hbv=None, check=None, fd: FdOperands | None = None, totals=None,
):
    """The plain version of ``pairs_pull_lanes``: ``pairs_pull_plain`` on
    each lane's operands with the lane's salt and phi, lane after lane.
    Returns the (S,) int32 flags with ``check``, else None."""
    flags = []
    for s in range(w.shape[0]):
        def at(t):
            return None if t is None else t[s]

        flag = pairs_pull_plain(
            w[s], at(hb), gm[s], c[s], valid[s], int(salt_mix[s]), 0, budget,
            mv=at(mv), hbv=at(hbv), fd=None if fd is None else fd.lane(s),
            check=None if check is None else tuple(t[s] for t in check),
            totals=at(totals),
        )
        flags.append(flag)
    return None if check is None else torch.cat(flags)


def pairs_pull_lanes(
    w, hb, gm, c, valid, salt_mix, budget, *,
    mv=None, hbv=None, check=None, fd: FdOperands | None = None, totals=None,
    cluster: int | None = None,
):
    """One pair-fused sub-exchange of S sweep lanes in one launch, in
    place: ``pairs_pull`` with a leading lane axis on every operand —
    (S, N, N) matrices, (S, N/8) matchings, (S, N) vectors — and
    ``salt_mix`` an (S,) int32 tensor of each lane's sub-exchange salt
    xor its run salt (the bits as uint32). ``fd.phi`` (S,) float32 gives
    each lane's threshold (``fd.params.phi`` for all when None);
    ``cluster`` as in ``pairs_pull``. Returns the (S,) int32 flags with
    ``check``, else None."""
    if w.device.type == "cpu":
        counters.plain_calls["pull"] += 1
        return pairs_pull_lanes_plain(
            w, hb, gm, c, valid, salt_mix, budget,
            mv=mv, hbv=hbv, check=check, fd=fd, totals=totals,
        )
    lanes = (w.shape[0],)
    expect("salt_mix", salt_mix, torch.int32, lanes, w.device, align=4)
    if fd is not None and fd.phi is not None:
        expect("phi", fd.phi, torch.float32, lanes, w.device, align=4)
    return _launch(w, hb, gm, c, valid, salt_mix, budget, lanes, mv, hbv, check, fd, totals,
                   cluster=cluster)


def check_block(n: int, n_cols: int, owner_offset: int, packed: bool) -> None:
    """A column block's contract: owners ``owner_offset .. +n_cols`` of
    ``n``, rows of 8-element vectors (a packed block also starts on a
    byte)."""
    if n_cols % (16 if packed else 8):
        raise ValueError(
            f"a block of {n_cols} owners is not rows of 8-element vectors"
            + (" (16 owners, packed)" if packed else "")
        )
    if owner_offset < 0 or owner_offset + n_cols > n or (packed and owner_offset % 2):
        raise ValueError(f"owner_offset {owner_offset} does not place {n_cols} of {n} owners")


def _launch(w, hb, gm, c, valid, salt, budget, lanes, mv, hbv, check, fd, totals,
            owner_offset=0, cluster=None):
    """Check the operands of a launch over ``lanes`` (``()``: one
    sub-exchange; ``(S,)``: S lanes, ``salt`` their (S,) salt_mix, else
    the salt_mix int) on the block of owners from ``owner_offset``, with
    ``cluster`` CTAs a staged pair, and launch the kernel."""
    dev = w.device
    n = w.shape[-2]
    packed = is_packed_w(w)
    _check_packed(packed, hb, fd)
    if not packed and w.dtype not in MATRIX_DTYPES:
        raise ValueError(f"w dtype {w.dtype} is not int8/int16/int32/uint8")
    n_cols = owner_columns(w)
    check_block(n, n_cols, owner_offset, packed)
    expect("w", w, w.dtype, (*lanes, n, w.shape[-1]), dev)
    row_len, itemsize = w.shape[-1], w.element_size()
    if totals is not None:
        expect("totals", totals, torch.float32, (*lanes, n), dev)
        if cluster not in (None, 1):
            raise ValueError("the totals-fed pull stages nothing: it takes no cluster")
        cluster = 1
    else:
        if cluster is None:
            cluster = cluster_size(row_len, itemsize) or cluster_size(row_len, itemsize, 1)
        if cluster is None or not cluster_fits(row_len, itemsize, cluster):
            raise ValueError(
                f"pairs kernel cannot stage rows of {n_cols} owners with {w.dtype} "
                f"watermarks on a cluster of {cluster} (the slices of both rows in "
                "shared memory, a cluster of 1, 2, 4 or 8; pass totals for the "
                "two-pass form)"
            )
    expect("gm", gm, torch.int32, (*lanes, n // 8), dev)
    expect("c", c, torch.int32, (*lanes, n // 8), dev)
    expect("valid", valid, torch.bool, (*lanes, n), dev)
    w_code = U4_CODE if packed else w.element_size()
    h_code = w.element_size()
    if hb is not None:
        if hb.dtype not in MATRIX_DTYPES:
            raise ValueError(f"hb dtype {hb.dtype} is not int8/int16/int32")
        expect("hb", hb, hb.dtype, (*lanes, n, n_cols), dev)
        h_code = hb.element_size()
    if mv is not None:
        expect("mv", mv, torch.int32, (*lanes, n_cols), dev)
        if hb is not None and hbv is None:
            raise ValueError("hbv required when mv is given and hb is tracked")
        if packed:
            mv = pack_u4(mv)  # the write bumps as nibbles, each clipped to 15
    if hbv is not None:
        expect("hbv", hbv, torch.int32, (*lanes, n_cols), dev)
    need = alive = flag = None
    if check is not None:
        needed, alive, alive_owner = check
        if packed:
            # A zero residual is caught up: the row carries only each
            # owner's alive bit, one nibble each.
            need = pack_u4(alive_owner.to(torch.int32))
        else:
            need = torch.where(alive_owner, needed.to(torch.int32), 0)
        expect("need", need, need.dtype, (*lanes, w.shape[-1] if packed else n_cols), dev)
        expect("alive", alive, torch.bool, (*lanes, n), dev)
        flag = torch.ones(lanes or (1,), dtype=torch.int32, device=dev)
    fd_ptrs = [None] * 5
    im_code, ic_code, live_bits = 104, 2, 0
    consts = FdParams(0.0, 0, 0.0, 0.0, 0.0)
    tick = 0
    phi = None
    if fd is not None:
        if hb is None or hbv is None:
            raise ValueError("the fused FD needs hb and hbv")
        if fd.im.dtype not in (torch.bfloat16, torch.float32):
            raise ValueError(f"imean dtype {fd.im.dtype} is not bfloat16/float32")
        if fd.ic.dtype not in (torch.int8, torch.int16):
            raise ValueError(f"icount dtype {fd.ic.dtype} is not int8/int16")
        live_bits = int(is_packed_live(fd.live))
        expect("last_change", fd.lc, hb.dtype, (*lanes, n, n_cols), dev)
        expect("imean", fd.im, fd.im.dtype, (*lanes, n, n_cols), dev)
        expect("icount", fd.ic, fd.ic.dtype, (*lanes, n, n_cols), dev)
        if live_bits:
            expect("live", fd.live, torch.uint8, (*lanes, n, n_cols // 8), dev)
        else:
            expect("live", fd.live, torch.bool, (*lanes, n, n_cols), dev)
        if fd.hb0 is not None:
            expect("hb0", fd.hb0, hb.dtype, (*lanes, n, n_cols), dev)
        fd_ptrs = [
            fd.lc.data_ptr(), fd.im.data_ptr(), fd.ic.data_ptr(),
            fd.live.data_ptr(),
            None if fd.hb0 is None else fd.hb0.data_ptr(),
        ]
        im_code = 102 if fd.im.dtype == torch.bfloat16 else 104
        ic_code = fd.ic.element_size()
        consts = fd.params
        tick = int(fd.tick)
        phi = fd.phi

    def ptr(t):
        return None if t is None else t.data_ptr()

    lane_salt = salt if lanes else None
    lib = _build.load("pairs_pull")
    rc = lib.aiocluster_pairs_pull(
        w.data_ptr(), ptr(hb), gm.data_ptr(), c.data_ptr(), valid.data_ptr(),
        n, n_cols, owner_offset, 0 if lanes else salt, float(budget), ptr(totals), ptr(mv), ptr(hbv),
        ptr(need), ptr(alive), ptr(flag), tick, *fd_ptrs,
        consts.max_interval, consts.window, consts.prior_weight,
        consts.prior_wm, consts.phi, w_code, h_code, im_code, ic_code, live_bits,
        lanes[0] if lanes else 1, ptr(lane_salt), ptr(phi), cluster,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    _build.check(lib, rc, "pairs_pull kernel launch")
    counters.launches[
        counter_key(mv is not None, check is not None, fd is not None, totals is not None,
                    packed, lanes=bool(lanes), cluster=cluster > 1)
    ] += 1
    return flag


def counter_key(
    diag: bool, check: bool, fd: bool, totals: bool = False, packed: bool = False,
    lanes: bool = False, cluster: bool = False,
) -> str:
    """The ``counters.launches`` key of a launch in this mode (``lanes``:
    a lane launch of a sweep; ``cluster``: staged by a cluster of more
    than one CTA)."""
    flags = [
        f for f, on in (
            ("cluster", cluster), ("packed", packed), ("totals", totals), ("diag", diag),
            ("check", check), ("fd", fd),
        )
        if on
    ]
    return f"pairs_pull[{'lanes+' if lanes else ''}{'+'.join(flags) or 'pull'}]"
