"""The batched gossip round in PyTorch: one ScuttleButt round for all N
nodes as tensor passes over the (N, N) watermark, heartbeat and
failure-detector matrices — the port of the reference's ops/gossip.py
for the slice it covers (grouped matching, proportional budget, FD on or
off, every rung of the memory ladder, no churn, no lifecycle, no fault
plan). The packed u4r rung computes on the nibbles (the packed helpers
below), and the shrunk FD bookkeeping stores int8 counters and the live
bitmap.

Two implementations serve a round, resolved once per call by
``resolve_phases`` (the counterpart of the reference's
``pallas_fallback_reason`` / ``pallas_path_engaged`` /
``fd_phase_engaged``):

- on a CUDA device (``use_pallas="auto"``): every sub-exchange is one
  launch of the pair-fused pull kernel (ops/pairs_pull.py); the first
  also refreshes the owner diagonal, the last also runs the FD phase
  ("fused") and the convergence check. A row pair is staged by one CTA
  ("pairs") or, where two such CTAs would not share an SM, by a
  thread-block cluster of CTAs ("pairs_cluster"). On the column blocks
  of a mesh, on wide rows of 1-byte elements (int8, packed u4r: there it
  ran faster) and past what a cluster of 8 stages, each sub-exchange is
  two launches instead: the deficit totals (ops/pairs_totals.py), then
  the pull fed those totals ("pairs_two_pass", the reference's sharded
  two-pass form). ``pairs_pull.pull_form`` is the rule. A config the
  kernels cannot take is refused, never run plain,
  except on the routes the reference itself serves with XLA for want of
  a kernel: "packed_dtype" (u4r with heartbeats, or pinned to m8) and
  "fanout" (fanout 0: no sub-exchange carries the refresh and the FD
  epilogue; its FD phase is the standalone kernel) run the plain pull,
  "fd_packed_bookkeeping" (the shrunk FD bookkeeping off the pairs path)
  the plain FD phase, each counted in ``counters.fallbacks``;
- ``pallas_variant="m8"`` on a CUDA device: every sub-exchange is one
  launch of the single-pass pull (ops/m8_pull.py, out of place; "m8"),
  or, where its rows do not stage, the m8 deficit totals
  (ops/m8_totals.py) and then the pull fed those totals
  ("m8_two_pass"); the FD phase is the standalone kernel ("kernel")
  and the convergence flag the plain reduction, as in the reference;
- ``use_pallas=False, use_pallas_fd=True`` on a CUDA device: the pull
  runs as plain PyTorch ops and the FD phase as the standalone kernel
  (ops/fd.py, "kernel") — the reference's A/B seam;
- on the CPU: the same resolution, with every wrapper taking its plain
  version (so ``use_pallas="auto"`` runs the plain round).

ops/counters.py counts what served each phase, every fallback and every
refusal.

``sweep_step`` is the round of a sweep's S lanes (sim/sweep.py): on the
pairs forms each sub-exchange is one lane launch for all lanes (two in
the two-pass form), each lane with its own salts, fanout mask, write
rate and FD phi; elsewhere each lane runs the plain round
(``resolve_phases(sweep=True)``).

``step_blocks`` is the round of a state held as column blocks of the
owners (the reference's ``sim_step(axis_name="owners")``; the mesh of
parallel/mesh.py): each phase runs block after block between the
collectives of ``reduce_blocks`` (the deficit totals summed over the
blocks before any block's pull, the flag's min), the kernels at each
block's ``owner_offset``. ``sim_step`` is that round on one block of
every owner; ``run_rounds`` queues a chunk of rounds of either (the
chunk's draws once, no host sync), and ``block_width`` is the one rule
for the widths a mesh's blocks may take.

``sim_step``, ``step_blocks`` and ``sweep_step`` consume their input
state, as the reference's donated buffers do: the matrices are updated
in place where a phase can.
"""

from __future__ import annotations

import dataclasses
from collections.abc import Sequence
from typing import NamedTuple

import torch
from torch.profiler import record_function

from ..sim.config import SimConfig, unported_reason
from ..sim.packed import U4_MAX, is_packed_w, live_view_bool, watermarks_i32
from ..sim.state import DTYPES, STATE_FIELDS, SimState, SweepParams, lane, state_n_local
from . import counters, m8_pull, m8_totals, pairs_pull, pairs_totals, prng
from . import fd as fd_mod
from .fd import FdParams

M32 = prng.M32
K1, K2, K3, K4 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F


# -- the plain round's pieces ---------------------------------------------------


def hash_mix_u32(i: torch.Tensor, j: torch.Tensor, s) -> torch.Tensor:
    """The reference's one multiplicative hash of two index streams and a
    salt (an int or a tensor), on uint32 words held in int64 (see prng:
    PyTorch has no uint32 arithmetic on the CPU). csrc/hash.cuh is the
    kernels' copy."""
    if torch.is_tensor(s):
        s_term = prng.mul32(s.to(torch.int64), K3)
    else:
        s_term = (int(s) & M32) * K3 & M32
    h = prng.mul32(i, K1) ^ prng.mul32(j, K2) ^ s_term
    h = prng.mul32(h ^ (h >> 15), K4)
    return h ^ (h >> 13)


def hash_uniform(
    salt, n_rows: int, owner_ids: torch.Tensor, run_salt=None, row_ids=None
) -> torch.Tensor:
    """Deterministic (row, global owner, salt) -> [0, 1) dither: the top
    24 hash bits through int32 to float32, clipped to
    [1e-12, 1 - 2^-24] — the reference's ``_hash_uniform(bits=24)``.
    Rows are ``0 .. n_rows - 1``, or the global ids ``row_ids`` of a
    block of rows."""
    dev = owner_ids.device
    s = int(salt) & M32
    if run_salt is not None:
        s ^= int(run_salt) & M32
    if row_ids is None:
        row_ids = torch.arange(n_rows, device=dev)
    i = row_ids.to(torch.int64)[:, None]
    j = owner_ids.to(torch.int64)[None, :]
    return dither24(hash_mix_u32(i, j, s))


def dither24(h: torch.Tensor) -> torch.Tensor:
    """The [0, 1) dither of hash words: the top 24 bits through int32 to
    float32, clipped to [1e-12, 1 - 2^-24] (csrc/hash.cuh ``dither24``)."""
    u = (h >> 8).to(torch.int32).to(torch.float32) * (1.0 / 16777216.0)
    return torch.clamp(u, min=1e-12, max=1.0 - 2.0**-24)


def deficits(w_recv, w_send, valid) -> torch.Tensor:
    """What each receiver row lacks of its sender row, zero on rows whose
    pair is not alive."""
    dt = w_recv.dtype
    return torch.clamp(w_send - w_recv, min=0) * valid[:, None].to(dt)


def deficit_totals(d) -> torch.Tensor:
    """(N,) float32 row totals of ``deficits``: summed exactly in int64
    and rounded to float32 once, which equals the reference's float32
    sum while a row total stays below 2^24."""
    return d.sum(dim=1, dtype=torch.int64).to(torch.float32)


def budget_scale(total: torch.Tensor, budget: int) -> torch.Tensor:
    """The share of every deficit a row may take: min(1, budget /
    max(total, 1)). A tensor numerator: PyTorch computes ``scalar /
    tensor`` as a reciprocal times the scalar, which is not the
    correctly rounded quotient."""
    quot = torch.full_like(total, float(budget)) / torch.clamp(total, min=1.0)
    return torch.clamp(quot, max=1.0)


def proportional_advance(d, scale, salt, owner_ids, run_salt=None, row_ids=None):
    """(rows, cols) int32 advances on the deficits ``d``: each scaled by
    its row's ``scale`` and rounded with the hashed dither of (row,
    global owner ``owner_ids``, salt), never past the deficit."""
    x = d.to(torch.float32) * scale[:, None]
    floor = torch.floor(x)
    bump = hash_uniform(salt, d.shape[0], owner_ids, run_salt, row_ids) < (x - floor)
    return torch.minimum(floor.to(torch.int32) + bump.to(torch.int32), d.to(torch.int32))


def budgeted_advance(
    w_recv, w_send, budget: int, valid, salt, owner_ids, run_salt=None,
    totals=None, row_ids=None,
) -> torch.Tensor:
    """How far each receiver row advances toward its sender row under the
    per-exchange key-version budget: the reference's
    ``_budgeted_advance`` with the proportional policy. Deficits are
    scaled by min(1, budget/total) and rounded with the hashed dither.
    ``totals`` (float32, one per row), when given, are the row totals to
    scale by (a first pass took them); else they are summed here.
    ``row_ids`` are the rows' global ids when they are a block of the
    matrix's rows (the dither hashes them)."""
    d = deficits(w_recv, w_send, valid)
    total = deficit_totals(d) if totals is None else totals
    adv = proportional_advance(
        d, budget_scale(total, budget), salt, owner_ids, run_salt, row_ids
    )
    return adv.to(w_recv.dtype)


# -- the packed u4 residual rung: the round's math on the nibbles -------------
#
# version_dtype="u4r" stores watermarks as saturating residuals below the
# owner's max_version, two per byte (sim/packed.py). The sub-exchange is
# closed in residual space (a direction's deficit is max(r_recv - r_send,
# 0): the owner's max_version cancels), so these compute on the nibbles
# and reproduce budgeted_advance bit for bit: one row total spans both
# halves (exact integer sums, rounded to float32 once), then each half
# takes the same scale and the dither of its own global owners.


def nibbles(r: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(low, high) int32 nibble halves of packed bytes: owners 2k and
    2k + 1 of byte column k."""
    return (r & 0xF).to(torch.int32), (r >> 4).to(torch.int32)


def pack_halves(lo: torch.Tensor, hi: torch.Tensor) -> torch.Tensor:
    return (lo | (hi << 4)).to(torch.uint8)


def packed_adv_halves(
    r, r_peer, budget: int, valid, salt, owners, run_salt=None, totals=None,
    row_ids=None,
) -> tuple[torch.Tensor, torch.Tensor]:
    """The reference's ``_packed_adv_halves``: (a_lo, a_hi) int32 nibble
    advances of each receiver row toward its peer row (the receiver's
    residual shrinks by them). ``totals`` and ``row_ids`` as in
    ``budgeted_advance``; ``owners`` are the logical columns' global
    ids."""
    lo, hi = nibbles(r)
    plo, phi = nibbles(r_peer)
    v = valid[:, None].to(torch.int32)
    d_lo = torch.clamp(lo - plo, min=0) * v
    d_hi = torch.clamp(hi - phi, min=0) * v
    if totals is None:
        totals = packed_totals(r, r_peer, valid)
    scale = budget_scale(totals, budget)
    return (
        proportional_advance(d_lo, scale, salt, owners[0::2], run_salt, row_ids),
        proportional_advance(d_hi, scale, salt, owners[1::2], run_salt, row_ids),
    )


def packed_totals(r, r_peer, valid) -> torch.Tensor:
    """(rows,) float32 deficit totals of packed rows against their peer
    rows: both halves summed exactly, rounded once."""
    lo, hi = nibbles(r)
    plo, phi = nibbles(r_peer)
    d = torch.clamp(lo - plo, min=0).sum(dim=1, dtype=torch.int64) + torch.clamp(
        hi - phi, min=0
    ).sum(dim=1, dtype=torch.int64)
    return torch.where(valid, d, 0).to(torch.float32)


def packed_apply(r, a_lo, a_hi) -> torch.Tensor:
    """Apply nibble advances: the receiver's residual shrinks (w += adv
    in watermark space)."""
    lo, hi = nibbles(r)
    return pack_halves(lo - a_lo, hi - a_hi)


def packed_writes_shift(r, bump) -> torch.Tensor:
    """Owner writes raise max_version, which raises every observer's
    residual by the owner's bump (``bump`` (n,), w unchanged), saturating
    at the nibble ceiling."""
    lo, hi = nibbles(r)
    lo = torch.clamp(lo + bump[0::2].to(torch.int32)[None, :], max=U4_MAX)
    hi = torch.clamp(hi + bump[1::2].to(torch.int32)[None, :], max=U4_MAX)
    return pack_halves(lo, hi)


def packed_diag_zero_(r, rows, col0: int = 0) -> torch.Tensor:
    """The owner-diagonal refresh in residual space, in place: the rows
    with global ids ``rows`` (of a matrix over the owners ``col0 ..``,
    col0 even; every owner by default) get a zero residual on themselves
    (w[j, j] = max_version[j]) where their own owner lies in the matrix.
    Returns ``r``."""
    local = rows - col0
    hit = (local >= 0) & (local < 2 * r.shape[1])
    at = torch.arange(rows.numel(), device=r.device)[hit]
    local = local[hit]
    keep = torch.where(local % 2 == 0, 0xF0, 0x0F).to(torch.uint8)
    r[at, local // 2] &= keep
    return r


def refreshed_packed_rows(r, rows, bump, col0: int = 0) -> torch.Tensor:
    """A copy of the packed rows ``rows`` as the round's first
    sub-exchange sees them (``bump`` given: the writes shift, then the
    diagonal zero; the reference's ``_refresh_packed``), or as stored.
    ``r`` holds the owners ``col0 ..`` and ``bump`` their write bumps."""
    x = r[rows]
    if bump is None:
        return x
    return packed_diag_zero_(packed_writes_shift(x, bump), rows, col0)


# -- dispatch -------------------------------------------------------------------


def kernels_wanted(cfg: SimConfig, device) -> bool:
    """``use_pallas`` resolved for a device: True asks for the kernels,
    "auto" means "the state is on a CUDA device"."""
    return cfg.use_pallas is True or (
        cfg.use_pallas == "auto" and torch.device(device).type == "cuda"
    )


PAIRS_FORMS = ("pairs", "pairs_cluster", "pairs_two_pass")
M8_FORMS = ("m8", "m8_two_pass")


class Phases(NamedTuple):
    """One resolution of a config's round on a device: the form that
    serves the sub-exchanges and the one that serves the FD phase, each
    with the reference's reason name where a config that asks for the
    kernels runs that phase plain anyway (None elsewhere). ``sim_step``
    dispatches on it and counts its reasons in ``counters.fallbacks``."""

    pull: str
    pull_fallback: str | None
    fd: str
    fd_fallback: str | None


def fd_bookkeeping_packed(cfg: SimConfig) -> bool:
    """Whether the FD bookkeeping sits below the int16/bool profile (int8
    sample counters or the live bitmap): the pairs kernels' fused
    epilogue takes both, the standalone FD kernel neither."""
    return cfg.icount_dtype != "int16" or cfg.live_bits


# The column blocks the kernels take on a mesh: lane-aligned blocks, the
# reference's sharded kernel domain (its pallas_pull.supported(n_local=)).
BLOCK_ALIGN = 128


def block_width(cfg: SimConfig, blocks: int, device) -> int:
    """The owners of each of ``blocks`` column blocks (a mesh's
    n_local): the blocks must be whole and their packed forms whole
    bytes (two owners a byte of w, eight a byte of the live bitmap: a
    multiple of 16 owners), and where the kernels are wanted (on
    ``device``) more than one block must be lane-aligned
    (``BLOCK_ALIGN``). Raises a ValueError naming the width otherwise."""
    n = cfg.n_nodes
    if n % blocks or (n // blocks) % 16:
        raise ValueError(
            f"a mesh of {blocks} blocks does not split n_nodes={n} into "
            "column blocks of a multiple of 16 owners"
        )
    n_local = n // blocks
    if blocks > 1 and kernels_wanted(cfg, device) and n_local % BLOCK_ALIGN:
        raise ValueError(
            f"column blocks of n_local={n_local} owners are off the kernels' "
            f"domain (n_local % {BLOCK_ALIGN} == 0, the reference's "
            "lane-aligned shard); use fewer blocks or use_pallas=False"
        )
    return n_local


def kernel_pull_form(cfg: SimConfig, n_local: int | None = None) -> tuple[str, int]:
    """The kernel form of a config's sub-exchanges and the CTAs that
    stage a row pair (1 where none or one does): the pairs pull's from
    ``pairs_pull.pull_form`` (staged by one CTA or a cluster, or two
    launches a sub-exchange; always two on column blocks of a mesh,
    ``n_local`` owners of n a block); ``pallas_variant="m8"`` pins the
    single-pass pull, staged where one CTA holds both rows (a packed row
    is n / 2 bytes)."""
    n = cfg.n_nodes
    blocks = 1 if n_local is None else n // n_local
    row_len, itemsize = (n // 2, 1) if cfg.version_dtype == "u4r" else (
        n, DTYPES[cfg.version_dtype].itemsize)
    if cfg.pallas_variant == "m8":
        staged = blocks == 1 and pairs_pull.pairs_supported(row_len, itemsize)
        return ("m8" if staged else "m8_two_pass"), 1
    return pairs_pull.pull_form(row_len, itemsize, blocks)


def resolve_phases(
    cfg: SimConfig, device, sweep: bool = False, n_local: int | None = None
) -> Phases:
    """Resolve both phases of a round once (the counterpart of the
    reference's ``pallas_fallback_reason`` / ``pallas_path_engaged`` /
    ``fd_phase_engaged``).

    The pull is "pairs", "pairs_cluster" or "pairs_two_pass" (the
    pair-fused pull: one launch a sub-exchange staged by one CTA or by a
    cluster of CTAs, or two launches; ``pairs_pull.pull_form``), "m8" or
    "m8_two_pass" (pinned by
    ``pallas_variant="m8"``), or "plain": no kernels wanted, or a route
    the reference serves with XLA for want of a kernel, "packed_dtype"
    (the u4r rung with heartbeats, or pinned to m8: only the pairs
    kernels carry the nibble codec, and only in the lean profile) or
    "fanout" (fanout 0: no sub-exchange exists to carry the diagonal
    refresh and the FD epilogue).

    The FD phase is "fused" (the epilogue of the round's last pairs
    sub-exchange), "kernel" (the standalone pass; the m8 forms' and
    fanout 0's too, as in the reference), "plain", or "off" (no failure
    detector). The shrunk bookkeeping off the pairs path runs plain, as
    the standalone kernel (nor the reference's) does not take it: where
    the kernels are wanted that is "fd_packed_bookkeeping".

    ``sweep``: the round of a sweep's lanes (``sweep_step``). Only the
    pairs forms carry the lane axis, as in the reference: a sweep pinned
    to m8 runs its pull plain ("sweep_needs_pairs"), and a sweep's FD
    phase off the pairs forms runs plain (the standalone FD kernel has
    no lane axis).

    ``n_local``: the owners of one column block of a mesh (``step_blocks``;
    None is the whole width). With more than one block the kernel forms
    are the two-pass ones ("pairs_two_pass" / "m8_two_pass": each block's
    totals, summed over the blocks, feed every block's pull), as in the
    reference's sharded round; one block of every owner runs the
    unsharded forms (``block_width`` says which widths a mesh may
    take)."""
    wanted = kernels_wanted(cfg, device)
    pull_fallback = None
    if wanted and cfg.version_dtype == "u4r" and (
        cfg.track_heartbeats or cfg.pallas_variant == "m8"
    ):
        pull_fallback = "packed_dtype"
    elif wanted and cfg.fanout < 1:
        pull_fallback = "fanout"
    pull = kernel_pull_form(cfg, n_local)[0] if wanted and pull_fallback is None else "plain"
    if sweep and pull in M8_FORMS:
        pull, pull_fallback = "plain", "sweep_needs_pairs"
    fd, fd_fallback = "off", None
    if cfg.track_failure_detector:
        if cfg.use_pallas_fd is False:
            fd = "plain"
        elif pull in PAIRS_FORMS:
            fd = "fused"
        elif sweep or fd_bookkeeping_packed(cfg):
            fd = "plain"
            if wanted and fd_bookkeeping_packed(cfg):
                fd_fallback = "fd_packed_bookkeeping"
        elif cfg.use_pallas_fd is True or wanted:
            fd = "kernel"
        else:
            fd = "plain"
    return Phases(pull, pull_fallback, fd, fd_fallback)


def pull_phase_engaged(cfg: SimConfig, device, n_local: int | None = None) -> str:
    """The form that serves the sub-exchanges (``resolve_phases``)."""
    return resolve_phases(cfg, device, n_local=n_local).pull


def pull_fallback_reason(cfg: SimConfig, device) -> str | None:
    """Why a config that asks for the kernels runs its pull plain anyway
    ("packed_dtype", "fanout"), or None (``resolve_phases``)."""
    return resolve_phases(cfg, device).pull_fallback


def fd_phase_engaged(cfg: SimConfig, device) -> str:
    """The form that serves the FD phase (``resolve_phases``)."""
    return resolve_phases(cfg, device).fd


def fd_fallback_reason(cfg: SimConfig, device) -> str | None:
    """Why a config that asks for the kernels runs its FD phase plain
    anyway ("fd_packed_bookkeeping"), or None (``resolve_phases``)."""
    return resolve_phases(cfg, device).fd_fallback


# -- the round --------------------------------------------------------------------


def sim_step(
    state: SimState,
    key: torch.Tensor,
    cfg: SimConfig,
    *,
    return_converged: bool = False,
    tick: int | None = None,
    draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    run_salt: int | None = None,
):
    """Advance the whole cluster by one gossip round.

    ``key`` is the run's key (``prng.key(seed)``). ``tick`` is the host
    value of ``state.tick`` and ``draws`` the round's (gm, c, p) matchings
    on the state's device, shape (fanout, ...) — both derived here when
    not given (reading ``state.tick`` then costs a device sync);
    ``Simulator`` passes them, drawn a chunk at a time on the device, so
    its loop never syncs. ``run_salt`` is ``prng.run_salt(key)``.

    ``return_converged=True`` also returns the all-converged flag of the
    new state (a bool tensor); on the pairs path it rides the round's
    last sub-exchange.
    """
    out = step_blocks(
        [state], key, cfg, offsets=(0,), return_converged=return_converged,
        tick=tick, draws=draws, run_salt=run_salt,
    )
    if not return_converged:
        return out[0]
    blocks, flag = out
    return blocks[0], flag


# The collectives of a round over column blocks, by name.
_REDUCE_OPS = {"sum": torch.add, "min": torch.minimum, "max": torch.maximum}


def reduce_blocks(parts: Sequence[torch.Tensor], op: str) -> list[torch.Tensor]:
    """Reduce one partial per column block (``op`` "sum", "min" or
    "max") and return the result once per block, on the block's device:
    the counterpart of the reference's psum / pmin / pmax over the
    "owners" axis. Taken in block order 0 .. P-1 on the first block's
    device, in the partials' dtype (float32 for the deficit totals), so
    a sum of exact integers below 2^24 is exact and equals the whole
    width's. One block is returned as it is. A process per card would
    swap this for an ``all_reduce`` of its one block."""
    acc = parts[0]
    for part in parts[1:]:
        acc = _REDUCE_OPS[op](acc, part.to(acc.device))
    return _replicas([p.device for p in parts])(acc)


def _replicas(devices: Sequence[torch.device]):
    """A function mapping a tensor to one copy per block on the block's
    device (one copy per distinct device; the tensor itself where it
    already lies)."""

    def rep(t: torch.Tensor) -> list[torch.Tensor]:
        copies = {t.device: t}
        out = []
        for d in devices:
            if d not in copies:
                copies[d] = t.to(d)
            out.append(copies[d])
        return out

    return rep


def step_blocks(
    blocks: Sequence[SimState],
    key: torch.Tensor,
    cfg: SimConfig,
    *,
    offsets: Sequence[int],
    return_converged: bool = False,
    tick: int | None = None,
    draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor] | None = None,
    run_salt: int | None = None,
):
    """One gossip round of a state held as column blocks of the owners
    (the reference's ``sim_step(axis_name="owners")`` under shard_map):
    ``blocks[k]`` holds the (N, n_local) matrices of the global owners
    ``offsets[k] ..`` and the replicated (N,) vectors and tick. The
    replicated work runs once, on the first block's device, and is
    copied to the others; every phase then runs block after block
    between the collectives (``reduce_blocks``): each sub-exchange's deficit
    totals are summed over the blocks before any block's pull reads them
    (the two-pass kernel forms; the plain round likewise), the FD phase
    runs per block at its offset, and the convergence flag is the min
    over the blocks. ``sim_step`` is this round on one block of every
    owner. Returns the new blocks (and the flag with
    ``return_converged``); the other arguments are ``sim_step``'s."""
    reason = unported_reason(cfg)
    if reason is not None:
        counters.refuse(reason)
    head = blocks[0]
    n = cfg.n_nodes
    n_local = state_n_local(head)
    dev = head.w.device
    rep = _replicas([b.w.device for b in blocks])
    owned = [slice(o, o + n_local) for o in offsets]
    if tick is None:
        tick = int(head.tick)
    new_tick = tick + 1
    if run_salt is None:
        run_salt = prng.run_salt(key)
    if draws is None:
        draws = [t[0] for t in prng.round_draws(key.to(dev), new_tick, 1, n, cfg.fanout)]
    gm_all, c_all, p_all = draws

    alive = head.alive
    alive_i32 = alive.to(torch.int32)
    heartbeat = head.heartbeat + alive_i32
    max_version = head.max_version + cfg.writes_per_round * alive_i32
    alive_b, hbt_b, mv_b = rep(alive), rep(heartbeat), rep(max_version)
    track_hb = cfg.track_heartbeats
    phases = resolve_phases(cfg, dev, n_local=None if len(blocks) == 1 else n_local)
    pull, fd_phase = phases.pull, phases.fd
    for reason in (phases.pull_fallback, phases.fd_fallback):
        if reason is not None:
            counters.fallbacks[reason] += 1
    params = FdParams.from_config(cfg)
    packed = is_packed_w(head.w)
    # The first sub-exchange's refresh operand per block: the packed
    # rung's owners' write bump (the residuals shift by it, then the
    # diagonal zeroes), the unpacked rungs' new max_version.
    refresh_b = rep(max_version - head.max_version) if packed else mv_b
    refresh = [r[sl] for r, sl in zip(refresh_b, owned)]
    hbv = [h[sl] for h, sl in zip(hbt_b, owned)]

    def salt_of(c: int) -> int:
        return new_tick * (2 * cfg.fanout) + 2 * c

    def matching(c: int):
        """Sub-exchange ``c``'s (gm, c, p, valid) on each block's device."""
        p = p_all[c]
        return zip(rep(gm_all[c]), rep(c_all[c]), rep(p), rep(alive & alive[p]))

    flag = None
    ws = [b.w for b in blocks]
    hbs = [b.hb_known for b in blocks]
    if pull in M8_FORMS:
        # m8 never writes its inputs: the input hb is the round-start
        # matrix the FD phase reads.
        hb0s = list(hbs)
        _m8_exchanges(cfg, pull, ws, hbs, offsets, matching, refresh, hbv, salt_of, run_salt)
    elif pull != "plain":
        # The FD phase reads the round-start hb after the sub-exchanges
        # unless it fuses into a fanout-1 round's only call: keep a copy
        # (its owner diagonal is refreshed where it is read).
        hb0s = [None] * len(blocks)
        if cfg.track_failure_detector and not (fd_phase == "fused" and cfg.fanout == 1):
            hb0s = [h.clone() for h in hbs]
        for c in range(cfg.fanout):
            first, last = c == 0, c == cfg.fanout - 1
            ops = list(matching(c))
            totals = [None] * len(blocks)
            if pull == "pairs_two_pass":
                # Pass A sees the refreshed diagonal exactly as pass B will.
                totals = reduce_blocks([
                    pairs_totals.pairs_totals(
                        w, gm, cc, valid, mv=r if first else None, owner_offset=off,
                    )
                    for w, (gm, cc, _, valid), r, off in zip(ws, ops, refresh, offsets)
                ], "sum")
            flags = []
            for k, (gm, cc, _, valid) in enumerate(ops):
                kw = {}
                if first:
                    kw["mv"] = refresh[k]
                    if track_hb:
                        kw["hbv"] = hbv[k]
                if last and return_converged:
                    sl = owned[k]
                    kw["check"] = (mv_b[k][sl], alive_b[k], alive_b[k][sl])
                if last and fd_phase == "fused":
                    b = blocks[k]
                    kw["hbv"] = hbv[k]
                    kw["fd"] = pairs_pull.FdOperands(
                        new_tick, b.last_change, b.imean, b.icount, b.live_view, hb0s[k],
                        params,
                    )
                out = pairs_pull.pairs_pull(
                    ws[k], hbs[k] if track_hb else None, gm, cc, valid, salt_of(c),
                    run_salt, cfg.budget, totals=totals[k], owner_offset=offsets[k], **kw,
                )
                if out is not None:
                    flags.append(out)
            if flags:
                flag = reduce_blocks(flags, "min")[0]
    else:
        hb0s = _plain_exchanges(cfg, blocks, ws, hbs, offsets, matching, refresh, hbv,
                                salt_of, run_salt)

    for k, b in enumerate(blocks):
        if fd_phase == "kernel":
            fd_mod.fused_fd(
                new_tick, hbs[k], hb0s[k], hbv[k], b.last_change, b.imean, b.icount,
                b.live_view, params, owner_offset=offsets[k],
            )
        elif fd_phase == "plain":
            # The reference's XLA block (no lifecycle); hb0's diagonal is
            # refreshed again, idempotently.
            fd_mod.fused_fd_plain(
                new_tick, hbs[k], hb0s[k], hbv[k], b.last_change, b.imean, b.icount,
                b.live_view, params, owner_offset=offsets[k],
            )
            counters.plain_calls["fd"] += 1

    ticks = rep(head.tick + 1)
    new_blocks = [
        b.replace(
            tick=ticks[k], max_version=mv_b[k], heartbeat=hbt_b[k], w=ws[k], hb_known=hbs[k],
        )
        for k, b in enumerate(blocks)
    ]
    if not return_converged:
        return new_blocks
    if flag is not None:
        return new_blocks, flag[0] > 0
    return new_blocks, blocks_converged(new_blocks, offsets)


def run_rounds(
    blocks: list[SimState], key: torch.Tensor, cfg: SimConfig, *, offsets, m: int,
    tick: int, tracked: bool, run_salt: int | None = None,
    device_key: torch.Tensor | None = None,
):
    """Queue ``m`` rounds of the blocks from host tick ``tick``, with no
    host sync: the chunk's draws in one batched pass on the first block's
    device, then each round (``step_blocks``). Returns the new
    blocks and a device scalar holding the first converged tick among
    the rounds (0 if none; always 0 unless ``tracked``). The draws and
    each round are ``torch.profiler`` ranges (``aiocluster_torch.draws``
    / ``aiocluster_torch.sim_step``)."""
    dev = blocks[0].w.device
    if run_salt is None:
        run_salt = prng.run_salt(key)
    if device_key is None:
        device_key = key.to(dev)
    with record_function("aiocluster_torch.draws"):
        gm, c, p = prng.round_draws(device_key, tick + 1, m, cfg.n_nodes, cfg.fanout)
    first = torch.zeros((), dtype=torch.int32, device=dev)
    for r in range(m):
        with record_function("aiocluster_torch.sim_step"):
            out = step_blocks(
                blocks, key, cfg, offsets=offsets, return_converged=tracked,
                tick=tick + r, draws=(gm[r], c[r], p[r]), run_salt=run_salt,
            )
        if tracked:
            blocks, conv = out
            first = torch.where((first == 0) & conv, blocks[0].tick, first)
        else:
            blocks = out
    return blocks, first


def _m8_exchanges(cfg, pull, ws, hbs, offsets, matching, refresh, hbv, salt_of, run_salt):
    """The round's sub-exchanges on the m8 forms, block after block, in
    ``ws``/``hbs`` (replaced per block): each pull reads the
    pre-exchange w/hb and writes other buffers. The buffer a
    sub-exchange consumed takes the next one's output (``sim_step``
    consumes its input state), so a round holds two w matrices, not
    fanout + 1; the input hb stays intact when the FD phase reads it
    afterwards. The first sub-exchange refreshes the owner diagonal;
    on the two-pass form every block's totals are summed before any
    block's pull."""
    track_hb = cfg.track_heartbeats
    keep_hb0 = cfg.track_failure_detector
    hb0s = list(hbs)
    blocks = range(len(ws))
    w_spare = [None for _ in blocks]
    hb_spare = [None for _ in blocks]
    for c in range(cfg.fanout):
        first = c == 0
        ops = list(matching(c))
        totals = [None for _ in blocks]
        if pull == "m8_two_pass":
            totals = reduce_blocks([
                m8_totals.m8_totals(
                    ws[k], gm, cc, valid, mv=refresh[k] if first else None,
                    owner_offset=offsets[k],
                )
                for k, (gm, cc, _, valid) in enumerate(ops)
            ], "sum")
        for k, (gm, cc, _, valid) in enumerate(ops):
            out = m8_pull.m8_pull(
                ws[k], hbs[k] if track_hb else None, gm, cc, valid, salt_of(c),
                run_salt, cfg.budget, mv=refresh[k] if first else None,
                hbv=hbv[k] if first and track_hb else None, owner_offset=offsets[k],
                totals=totals[k], out=(w_spare[k], hb_spare[k] if track_hb else None),
            )
            w_spare[k], ws[k] = ws[k], out[0] if track_hb else out
            if track_hb:
                hb_spare[k] = None if (keep_hb0 and hbs[k] is hb0s[k]) else hbs[k]
                hbs[k] = out[1]


def _plain_exchanges(cfg, blocks, ws, hbs, offsets, matching, refresh, hbv, salt_of,
                     run_salt):
    """The round's sub-exchanges as plain PyTorch ops, block after block,
    in ``ws``/``hbs`` (new tensors): the owner diagonal refreshed, then
    each sub-exchange's deficits taken per block, their row totals
    summed over the blocks, and each block advanced with the global
    totals (the reference's XLA round; one block is the unsharded
    round). Returns the round-start hb of each block (refreshed)."""
    n = cfg.n_nodes
    track_hb, packed = cfg.track_heartbeats, is_packed_w(ws[0])
    owners = []
    for k, b in enumerate(blocks):
        dev = b.w.device
        ids = torch.arange(n, device=dev)
        cols = offsets[k] + torch.arange(state_n_local(b), device=dev)
        owners.append(cols)
        diag = ids[:, None] == cols[None, :]
        if packed:
            # Owner writes raise every observer's residual (saturating),
            # then each owner's residual on itself is 0.
            w = packed_writes_shift(b.w, refresh[k]) if cfg.writes_per_round != 0 else b.w.clone()
            ws[k] = packed_diag_zero_(w, ids, offsets[k])
        else:
            ws[k] = torch.where(diag, refresh[k].to(b.w.dtype)[None, :], b.w)
        if track_hb:
            hbs[k] = torch.where(diag, hbv[k].to(b.hb_known.dtype)[None, :], b.hb_known)
    hb0s = list(hbs)
    for c in range(cfg.fanout):
        ops = list(matching(c))
        peers = [w[p] for w, (_, _, p, _) in zip(ws, ops)]
        if packed:
            totals = reduce_blocks([
                packed_totals(w, peer, valid) for w, peer, (_, _, _, valid) in zip(ws, peers, ops)
            ], "sum")
        else:
            ds = [deficits(w, peer, valid) for w, peer, (_, _, _, valid) in zip(ws, peers, ops)]
            totals = reduce_blocks([deficit_totals(d) for d in ds], "sum")
        for k, (_, _, p, valid) in enumerate(ops):
            if packed:
                a_lo, a_hi = packed_adv_halves(
                    ws[k], peers[k], cfg.budget, valid, salt_of(c), owners[k], run_salt,
                    totals[k],
                )
                ws[k] = packed_apply(ws[k], a_lo, a_hi)
            else:
                scale = budget_scale(totals[k], cfg.budget)
                adv = proportional_advance(ds[k], scale, salt_of(c), owners[k], run_salt)
                ws[k] = ws[k] + adv.to(ws[k].dtype)
            if track_hb:
                hbs[k] = torch.maximum(hbs[k], torch.where(valid[:, None], hbs[k][p], 0))
            counters.plain_calls["pull"] += 1
    return hb0s


# -- the round of a sweep's lanes -----------------------------------------------------


def lane_fanouts(cfg: SimConfig, sweep: SweepParams, lanes: int, device) -> torch.Tensor:
    """(S,) int64 fanout of each lane: the swept values, else the
    config's for all."""
    if sweep.fanout is not None:
        return sweep.fanout.to(device=device, dtype=torch.int64)
    return torch.full((lanes,), cfg.fanout, dtype=torch.int64, device=device)


def lane_salt_table(
    first_tick: int, rounds: int, fanout: int, lane_fanout: torch.Tensor,
    run_salts: torch.Tensor,
) -> torch.Tensor:
    """(rounds, fanout, S) int32 salt_mix of every sub-exchange of rounds
    ``first_tick ..`` (post-increment ticks) and every lane, built on the
    lanes' device in one pass: the reference's salt ``tick * (2 *
    f_lane) + 2 * c`` (a lane's salt spacing is its own fanout's) xor
    the lane's run salt."""
    dev = lane_fanout.device
    ticks = torch.arange(first_tick, first_tick + rounds, dtype=torch.int64, device=dev)
    subs = torch.arange(fanout, dtype=torch.int64, device=dev)
    salt = ticks[:, None, None] * (2 * lane_fanout)[None, None, :] + 2 * subs[None, :, None]
    return prng.salt_mix(salt, run_salts.to(dev)[None, None, :])


def lane_configs(cfg: SimConfig, sweep: SweepParams, lanes: int) -> list[SimConfig]:
    """Each lane's config as a sequential run would hold it (the swept
    values as static fields), pinned to the plain round: the sweep's
    plain route runs every lane through ``sim_step`` with it."""
    values = {
        name: getattr(sweep, name).tolist()
        for name in ("fanout", "phi_threshold", "writes_per_round")
        if getattr(sweep, name) is not None
    }
    return [
        dataclasses.replace(
            cfg, use_pallas=False, use_pallas_fd=False,
            **{k: v[s] for k, v in values.items()},
        )
        for s in range(lanes)
    ]


def sweep_step(
    states: SimState,
    keys: torch.Tensor,
    cfg: SimConfig,
    sweep: SweepParams,
    *,
    tick: int,
    draws: tuple[torch.Tensor, torch.Tensor, torch.Tensor],
    salts: torch.Tensor,
    run_salts: list[int],
    active: torch.Tensor | None,
    return_converged: bool = False,
):
    """Advance every lane of a sweep by one gossip round (the reference's
    ``sim_step`` under its lane ``vmap``): lane s equals ``sim_step`` of
    a sequential run with seed ``keys[s]`` and the lane's values of
    ``sweep`` as static config fields.

    ``states`` is lane-batched (``init_lanes``), ``keys`` the (S, 2) lane
    keys, ``tick`` the host value of the (shared) pre-round tick.
    ``draws`` are the round's (gm, c, p) of every lane, (fanout, S, ...)
    (``prng.round_draws`` of the keys), ``salts`` the round's (fanout, S)
    salt_mix table (``lane_salt_table``), ``run_salts`` the lanes' run
    salts as host ints and ``active`` the (fanout, S) bool table of the
    sub-exchanges each lane runs (``c < f_lane``; None when fanout is not
    swept).

    On the pairs forms each sub-exchange is one lane launch for all S
    lanes (two in the two-pass form: the totals, then the pull), on the
    lanes' salts; a lane whose fanout is below the config's voids its
    sub-exchanges ``c >= f_lane`` (``valid`` all 0) while the refresh
    still rides c = 0 and the check and the FD epilogue (with the lane's
    phi) c = fanout - 1. Elsewhere every lane runs the plain round.
    ``return_converged=True`` also returns the (S,) bool flags."""
    reason = unported_reason(cfg)
    if reason is not None:
        counters.refuse(reason)
    lanes, new_tick = states.w.shape[0], tick + 1
    phases = resolve_phases(cfg, states.w.device, sweep=True)
    for why in (phases.pull_fallback, phases.fd_fallback):
        if why is not None:
            counters.fallbacks[why] += 1
    if phases.pull not in PAIRS_FORMS:
        return _plain_lanes(states, keys, cfg, sweep, tick, draws, run_salts,
                            return_converged)
    gm_all, c_all, p_all = draws

    alive = states.alive
    alive_i32 = alive.to(torch.int32)
    heartbeat = states.heartbeat + alive_i32
    wpr = cfg.writes_per_round
    if sweep.writes_per_round is not None:
        wpr = sweep.writes_per_round.to(torch.int32)[:, None]
    max_version = states.max_version + wpr * alive_i32
    track_hb, packed = cfg.track_heartbeats, is_packed_w(states.w)
    fused = phases.fd == "fused"
    w, hb = states.w, states.hb_known
    # As in sim_step: the FD epilogue reads the round-start hb unless it
    # fuses into a fanout-1 round's only launch.
    hb_round_start = None
    if cfg.track_failure_detector and not (fused and cfg.fanout == 1):
        hb_round_start = hb.clone()
    flag = None
    for c in range(cfg.fanout):
        first, last = c == 0, c == cfg.fanout - 1
        valid = alive & torch.gather(alive, 1, p_all[c].long())
        if active is not None:
            valid &= active[c][:, None]
        kw = {}
        if first:
            kw["mv"] = max_version - states.max_version if packed else max_version
            if track_hb:
                kw["hbv"] = heartbeat
        if phases.pull == "pairs_two_pass":
            kw["totals"] = pairs_totals.pairs_totals_lanes(
                w, gm_all[c], c_all[c], valid, mv=kw.get("mv")
            )
        if last and return_converged:
            kw["check"] = (max_version, alive, alive)
        if last and fused:
            kw["hbv"] = heartbeat
            kw["fd"] = pairs_pull.FdOperands(
                new_tick, states.last_change, states.imean, states.icount,
                states.live_view, hb_round_start, FdParams.from_config(cfg),
                phi=sweep.phi_threshold,
            )
        out = pairs_pull.pairs_pull_lanes(
            w, hb if track_hb else None, gm_all[c], c_all[c], valid, salts[c],
            cfg.budget, **kw,
        )
        if out is not None:
            flag = out
    if cfg.track_failure_detector and not fused:
        # use_pallas_fd=False: the plain FD phase, lane by lane with
        # each lane's phi (the epilogue's input hb0 kept above).
        for s, lane_cfg in enumerate(lane_configs(cfg, sweep, lanes)):
            fd_mod.fused_fd_plain(
                new_tick, hb[s], hb_round_start[s], heartbeat[s], states.last_change[s],
                states.imean[s], states.icount[s], states.live_view[s],
                FdParams.from_config(lane_cfg),
            )
            counters.plain_calls["fd"] += 1
    new = states.replace(
        tick=states.tick + 1, max_version=max_version, heartbeat=heartbeat, w=w,
        hb_known=hb,
    )
    if not return_converged:
        return new
    return new, flag > 0


def _plain_lanes(states, keys, cfg, sweep, tick, draws, run_salts, return_converged):
    """The plain route of ``sweep_step``: each lane runs ``sim_step``'s
    plain round with its own config on its views of the batch, and what
    the round wrote into new tensors is copied back into the batch."""
    gm_all, c_all, p_all = draws
    flags = []
    for s, lane_cfg in enumerate(lane_configs(cfg, sweep, states.w.shape[0])):
        f = lane_cfg.fanout
        view = lane(states, s)
        out = sim_step(
            view, keys[s], lane_cfg, tick=tick, run_salt=run_salts[s],
            draws=(gm_all[:f, s], c_all[:f, s], p_all[:f, s]),
            return_converged=return_converged,
        )
        new, conv = out if return_converged else (out, None)
        for name in STATE_FIELDS:
            src, dst = getattr(new, name), getattr(view, name)
            if src.data_ptr() != dst.data_ptr() and src.numel():
                dst.copy_(src)
        flags.append(conv)
    if not return_converged:
        return states
    return states, torch.stack(flags)


# -- row blocks ---------------------------------------------------------------------


# Rows per block of the reductions and plain passes over (N, N) matrices:
# about 2^26 elements, so a block's float32 and bool transients stay near
# 256 MB at any width (the whole (N, N) float32 fraction matrix is 40 GB
# at N = 100,352).
ROW_BLOCK_ELEMS = 1 << 26


def row_blocks(n: int, n_cols: int | None = None):
    """(r0, r1) bounds of consecutive blocks of the rows of an (n,
    n_cols) matrix (square by default), about ``ROW_BLOCK_ELEMS``
    elements each."""
    rows = max(1, ROW_BLOCK_ELEMS // (n if n_cols is None else n_cols))
    return ((r0, min(r0 + rows, n)) for r0 in range(0, n, rows))


def pair_row_blocks(p: torch.Tensor, leaders: torch.Tensor | None = None):
    """The rows of an involution ``p``'s pairs in blocks of about
    ``ROW_BLOCK_ELEMS`` elements: each block holds whole pairs (leader
    rows ``i <= p[i]``, then their partners that are other rows) and each
    row lies in one block, so a pass that writes a block's rows from
    their pre-exchange values may update the matrix in place. Yields
    ``(rows, p[rows])`` as int64 tensors. ``leaders`` (int64 leader
    rows) restricts the blocks to those rows' pairs."""
    n = p.shape[0]
    if leaders is None:
        ids = torch.arange(n, device=p.device)
        leaders = ids[ids <= p]
    per = max(1, ROW_BLOCK_ELEMS // (2 * n))
    for k in range(0, leaders.numel(), per):
        lead = leaders[k : k + per]
        part = p[lead]
        rows = torch.cat((lead, part[part != lead]))
        yield rows, p[rows]


def refreshed_rows(
    m: torch.Tensor, rows: torch.Tensor, diag, dtype=None, col0: int = 0
) -> torch.Tensor:
    """A copy of the rows ``rows`` of an (N, n_cols) matrix ``m`` (in
    ``dtype`` if given) whose owner diagonal reads ``diag`` ((n_cols,),
    the round's first sub-exchange refreshes it), or as stored when
    ``diag`` is None. ``m`` holds the owners ``col0 ..`` (a column block;
    the whole width by default): row r's diagonal is local column
    ``r - col0``, where that lies in the block."""
    x = m[rows] if dtype is None else m[rows].to(dtype)
    if diag is not None:
        local = rows - col0
        hit = (local >= 0) & (local < m.shape[1])
        at = torch.arange(rows.numel(), device=m.device)[hit]
        x[at, local[hit]] = diag[local[hit]].to(x.dtype)
    return x


# -- convergence ------------------------------------------------------------------
#
# Each reduction takes a column block of the owners (``col0`` its first
# global owner; the whole width by default) and the ``*_blocks`` forms
# combine the blocks' partials with ``reduce_blocks``, as the reference's
# sharded reductions psum / pmin / pmax them over the "owners" axis.


def _needed_in_w_dtype(state: SimState, owned: slice) -> torch.Tensor:
    """The owners' max_version in w's dtype (clamped to its largest
    value: a need beyond it is out of every row's reach, which
    ``_owners_caught_up`` accounts for), so the comparisons never widen
    w."""
    top = torch.iinfo(state.w.dtype).max
    return torch.clamp(state.max_version[owned], max=top).to(state.w.dtype)


def _owners_caught_up(state: SimState, col0: int = 0) -> torch.Tensor:
    """(n_local,) bool over the block's owners: every alive row's
    watermark on owner j has reached j's max_version, or owner j is dead.
    Reduced over blocks of rows in w's own dtype; on the packed rung a
    zero residual IS caught up, read straight off the bytes."""
    w, alive = state.w, state.alive
    n, n_local = alive.shape[0], state_n_local(state)
    owned = slice(col0, col0 + n_local)
    if is_packed_w(w):
        ok_lo = torch.ones(n_local // 2, dtype=torch.bool, device=w.device)
        ok_hi = ok_lo.clone()
        for r0, r1 in row_blocks(n, n_local):
            dead = ~alive[r0:r1, None]
            ok_lo &= (((w[r0:r1] & 0xF) == 0) | dead).all(dim=0)
            ok_hi &= (((w[r0:r1] >> 4) == 0) | dead).all(dim=0)
        return torch.stack((ok_lo, ok_hi), dim=-1).reshape(n_local) | ~alive[owned]
    need = _needed_in_w_dtype(state, owned)
    # A need that w's dtype cannot hold is reached by no row, and an alive
    # owner's own row is alive.
    ok = state.max_version[owned] <= torch.iinfo(w.dtype).max
    for r0, r1 in row_blocks(n, n_local):
        ok &= ((w[r0:r1] >= need) | ~alive[r0:r1, None]).all(dim=0)
    return ok | ~alive[owned]


def all_converged_flag(state: SimState) -> torch.Tensor:
    """Bool scalar: every alive node's watermark has reached every alive
    owner's max_version (dead observers and dead owners excused)."""
    return _owners_caught_up(state).all()


def blocks_converged(blocks: Sequence[SimState], offsets: Sequence[int]) -> torch.Tensor:
    """``all_converged_flag`` of a state held as column blocks: the min
    over the blocks of each block's flag (the reference's pmin)."""
    flags = [
        _owners_caught_up(b, off).all().to(torch.int32) for b, off in zip(blocks, offsets)
    ]
    return reduce_blocks(flags, "min")[0] > 0


def convergence_metrics(state: SimState) -> dict[str, torch.Tensor]:
    """How replicated the cluster is right now (the reference's
    ``convergence_metrics``): converged owners, the all-converged flag,
    the worst and mean watermark fraction over alive pairs, the alive
    count, the key-versions known, and the FD's false positives.
    Reduced over blocks of rows: the fraction sum in float64, the
    key-versions known exactly in int64, each rounded to float32 once.
    The packed rungs are widened a block at a time (sim/packed.py)."""
    return convergence_metrics_blocks([state], (0,))


def _metric_partials(state: SimState, col0: int) -> dict[str, torch.Tensor]:
    """One column block's share of ``convergence_metrics``: its converged
    owners, worst fraction, fraction sum (float64), key-versions known
    (int64) and FD false positives (int64)."""
    w, alive = state.w, state.alive
    dev, total, n_local = w.device, alive.shape[0], state_n_local(state)
    owned = slice(col0, col0 + n_local)
    cols = col0 + torch.arange(n_local, device=dev)
    packed = is_packed_w(w)
    need = state.max_version[owned] if packed else _needed_in_w_dtype(state, owned)
    need_f = torch.clamp(state.max_version[owned], min=1).to(torch.float32)
    alive_owner = alive[owned]
    rows_ids = torch.arange(total, device=dev)
    track_fd = state.live_view.numel() > 0
    frac_min = torch.ones((), dtype=torch.float32, device=dev)
    frac_sum = torch.zeros((), dtype=torch.float64, device=dev)
    kv_known = torch.zeros((), dtype=torch.int64, device=dev)
    fp = torch.zeros((), dtype=torch.int64, device=dev)
    # _owners_caught_up, in this pass: a packed watermark never exceeds
    # its owner's max_version, an unpacked need beyond w's dtype is out
    # of reach.
    caught_up = (
        torch.ones(n_local, dtype=torch.bool, device=dev)
        if packed
        else state.max_version[owned] <= torch.iinfo(w.dtype).max
    )
    for r0, r1 in row_blocks(total, n_local):
        wb = watermarks_i32(state, cols, rows=slice(r0, r1)) if packed else w[r0:r1]
        caught_up &= ((wb >= need) | ~alive[r0:r1, None]).all(dim=0)
        pair = alive[r0:r1, None] & alive_owner[None, :]
        frac = torch.where(pair, wb.to(torch.float32) / need_f, 1.0)
        frac_min = torch.minimum(frac_min, frac.min())
        frac_sum += torch.where(pair, torch.clamp(frac, max=1.0), 0.0).sum(
            dtype=torch.float64
        )
        kv_known += torch.where(pair, torch.minimum(wb, need), 0).sum(
            dtype=torch.int64
        )
        if track_fd:
            off_diag = rows_ids[r0:r1, None] != cols[None, :]
            live = live_view_bool(state, rows=slice(r0, r1))
            fp += (pair & off_diag & ~live).sum()
    return {
        "converged": (caught_up | ~alive_owner).sum(), "frac_min": frac_min,
        "frac_sum": frac_sum, "kv_known": kv_known, "fp": fp,
    }


def convergence_metrics_blocks(
    blocks: Sequence[SimState], offsets: Sequence[int]
) -> dict[str, torch.Tensor]:
    """``convergence_metrics`` of a state held as column blocks: each
    block's partials, then their sums (the minimum of the worst
    fractions) over the blocks, as the reference's sharded metrics."""
    parts = [_metric_partials(b, off) for b, off in zip(blocks, offsets)]
    ops = {"converged": "sum", "frac_min": "min", "frac_sum": "sum", "kv_known": "sum",
           "fp": "sum"}
    red = {k: reduce_blocks([p[k] for p in parts], op)[0] for k, op in ops.items()}
    alive = blocks[0].alive
    total = alive.shape[0]
    n_alive = alive.sum()
    pair_count = n_alive * n_alive
    n_converged = red["converged"]
    out = {
        "converged_owners": n_converged,
        "all_converged": n_converged == total,
        "min_fraction": torch.clamp(red["frac_min"], max=1.0),
        "mean_fraction": (red["frac_sum"] / torch.clamp(pair_count, min=1)).to(torch.float32),
        "alive_count": n_alive,
        "kv_known": red["kv_known"].to(torch.float32),
    }
    if blocks[0].live_view.numel() > 0:
        denom = pair_count - n_alive  # alive pairs off the diagonal
        fp = red["fp"]
        out["fd_false_positives"] = fp
        out["fd_false_positive_fraction"] = fp / torch.clamp(denom, min=1)
    return out


# -- staleness ----------------------------------------------------------------------

# The nearest-rank percentiles the staleness tensor is compressed to (the
# reference's obs.sim.STALENESS_PCTS): keys ``staleness_p<label>``.
STALENESS_PCTS = (("50", 0.50), ("99", 0.99), ("100", 1.0))


def staleness_tensor(state: SimState, col0: int = 0) -> torch.Tensor:
    """(N,) int32 per-node staleness (the reference's
    ``staleness_tensor``): how many key-versions node ``i`` lags behind
    the alive owner it is most behind on (of the block's owners from
    ``col0``; all of them by default), 0 for dead observers and at full
    convergence. Reduced over blocks of rows, the packed rung widened a
    block at a time."""
    alive = state.alive
    n, n_local = alive.shape[0], state_n_local(state)
    owned = slice(col0, col0 + n_local)
    cols = col0 + torch.arange(n_local, device=alive.device)
    need = state.max_version[owned].to(torch.int32)
    out = torch.empty(n, dtype=torch.int32, device=alive.device)
    for r0, r1 in row_blocks(n, n_local):
        pair = alive[r0:r1, None] & alive[owned][None, :]
        lag = torch.where(
            pair, need[None, :] - watermarks_i32(state, cols, rows=slice(r0, r1)), 0
        )
        out[r0:r1] = torch.clamp(lag.max(dim=1).values, min=0)
    return out


def staleness_tensor_blocks(blocks: Sequence[SimState], offsets: Sequence[int]) -> torch.Tensor:
    """``staleness_tensor`` of a state held as column blocks: each row's
    lag over each block's owners, maxed over the blocks (the reference's
    pmax)."""
    return reduce_blocks([staleness_tensor(b, off) for b, off in zip(blocks, offsets)], "max")[0]


def version_spread(state: SimState) -> torch.Tensor:
    """The worst version lag over alive (observer, owner) pairs: the max
    of ``staleness_tensor``."""
    return staleness_tensor(state).max()


def _nearest_rank(n: int, q: float) -> int:
    """Nearest-rank pick index over n sorted values."""
    return min(n - 1, int(q * (n - 1) + 0.5))


def staleness_percentiles(state: SimState, per_node: torch.Tensor | None = None) -> dict:
    """The staleness tensor (``per_node``, computed when not given)
    compressed to its nearest-rank percentiles ``staleness_p50`` /
    ``p99`` / ``p100``, as device scalars."""
    if per_node is None:
        per_node = staleness_tensor(state)
    ordered = torch.sort(per_node).values
    n = int(per_node.shape[0])
    return {f"staleness_p{label}": ordered[_nearest_rank(n, q)] for label, q in STALENESS_PCTS}


def metrics_sample(state: SimState) -> dict[str, torch.Tensor]:
    """``convergence_metrics`` with the version spread and the staleness
    percentiles (the reference's ``_metrics_sample``, a sweep's per-lane
    bundle), one staleness pass for both."""
    return metrics_sample_blocks([state], (0,))


def metrics_sample_blocks(
    blocks: Sequence[SimState], offsets: Sequence[int]
) -> dict[str, torch.Tensor]:
    """``metrics_sample`` of a state held as column blocks (the
    reference's ``sharded_metrics_fn``)."""
    out = convergence_metrics_blocks(blocks, offsets)
    per_node = staleness_tensor_blocks(blocks, offsets)
    out["version_spread"] = per_node.max()
    out.update(staleness_percentiles(blocks[0], per_node))
    return out
