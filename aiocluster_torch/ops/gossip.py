"""The batched gossip round in PyTorch: one ScuttleButt round for all N
nodes as tensor passes over the (N, N) watermark, heartbeat and
failure-detector matrices — the port of the reference's ops/gossip.py:
churn, the matching (grouped, or unrestricted off n % 128 == 0),
permutation and choice pairings (uniform, categorical, the view draw,
adjacency topologies), both budget policies, the dead-node lifecycle,
fault plans and heterogeneity (faults/sim.py: crash windows with
amnesiac restarts, link faults and partitions, the quarantine of the
choice draw, byzantine guard blocks, cadence classes, WAN classes and
zone bias) and every rung of the memory ladder. The packed u4r rung
computes on the nibbles (the packed helpers below), and the shrunk FD
bookkeeping stores int8 counters and the live bitmap.

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
  two-pass form). ``pairs_pull.pull_form`` is the rule. Churn keeps
  these forms: the kernels take the post-churn alive masks, and cadence
  classes fold into the same pair validity. A config
  the kernels cannot take runs its pull plain only on the routes the
  reference itself serves with XLA for want of a kernel, each counted in
  ``counters.fallbacks`` under the reference's reason
  (``plain_pull_reason``: "topology", "fault_plan", "pairing",
  "packed_dtype", "fanout", "shape", "budget_policy", "lifecycle"); the
  FD phase of those
  rounds is the standalone kernel, except under the lifecycle and on the
  shrunk bookkeeping ("fd_packed_bookkeeping"), which run it plain;
- ``pallas_variant="m8"`` on a CUDA device: the single-pass pull
  (ops/m8_pull.py, out of place), which runs the pairs pull's frame and
  takes its forms by the same rule under its own names: one launch a
  sub-exchange staged by one CTA a pair ("m8") or by a cluster of CTAs
  ("m8_cluster"), or the m8 deficit totals (ops/m8_totals.py) and then
  the pull fed those totals ("m8_two_pass"); the FD phase is the
  standalone kernel ("kernel") and the convergence flag the plain
  reduction, as in the reference;
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
chunk's draws once, no host sync); ``block_width`` is the rule for
the widths a mesh's blocks may take, ``resolve_phases`` the rule for
the widths the kernels take.

``sim_step``, ``step_blocks`` and ``sweep_step`` consume their input
state, as the reference's donated buffers do: the matrices are updated
in place where a phase can.
"""

from __future__ import annotations

import dataclasses
import functools
import os
from collections.abc import Sequence
from typing import NamedTuple

import numpy as np
import torch
from torch.profiler import record_function

from ..faults import sim as fsim
from ..obs.sim import STALENESS_PCTS
from ..sim.config import SimConfig
from ..sim.packed import (
    U4_MAX,
    is_packed_live,
    is_packed_w,
    live_view_bool,
    unpack_bits,
    watermarks_i32,
)
from ..sim.state import DTYPES, STATE_FIELDS, SimState, SweepParams, lane, state_n_local
from . import counters, m8_pull, m8_totals, pairs_pull, pairs_totals, prng
from . import fd as fd_mod
from .fd import FdParams, fma32

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


VARIANT_ENV = "AIOCLUSTER_TPU_PALLAS_VARIANT"


def resolve_variant_env(cfg: SimConfig) -> SimConfig:
    """Fold the ``AIOCLUSTER_TPU_PALLAS_VARIANT`` override (the A/B and
    kill-switch knob, the reference's variable) into the config once, at
    construction: ``Simulator`` and ``SweepSimulator`` apply it, so the
    resolved variant is what provenance reads from ``sim.cfg``.

    Precedence: an EXPLICIT ``cfg.pallas_variant`` ("m8"/"pairs") wins
    over the variable, which steers only configs that left the choice to
    "auto". A set value is validated loudly: a typo must not measure the
    wrong kernel."""
    env = os.environ.get(VARIANT_ENV)
    if not env:
        return cfg
    if env not in ("auto", "m8", "pairs"):
        raise ValueError(f"{VARIANT_ENV} must be auto/m8/pairs, got {env!r}")
    if env == "auto" or cfg.pallas_variant != "auto":
        return cfg
    return dataclasses.replace(cfg, pallas_variant=env)


PAIRS_FORMS = ("pairs", "pairs_cluster", "pairs_two_pass")
M8_FORMS = ("m8", "m8_cluster", "m8_two_pass")


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


def block_width(cfg: SimConfig, blocks: int) -> int:
    """The owners of each of ``blocks`` column blocks (a mesh's
    n_local): the blocks must be whole and their packed forms whole
    bytes (two owners a byte of w, eight a byte of the live bitmap: a
    multiple of 16 owners). Raises a ValueError naming the width
    otherwise. Whether the kernels take such blocks is the round's
    decision (``resolve_phases``)."""
    n = cfg.n_nodes
    if n % blocks or (n // blocks) % 16:
        raise ValueError(
            f"a mesh of {blocks} blocks does not split n_nodes={n} into "
            "column blocks of a multiple of 16 owners"
        )
    return n // blocks


def kernel_pull_form(cfg: SimConfig, n_local: int | None = None) -> tuple[str, int]:
    """The kernel form of a config's sub-exchanges and the CTAs that
    stage a row pair (1 where none or one does): the pairs pull's from
    ``pairs_pull.pull_form`` (staged by one CTA or a cluster, or two
    launches a sub-exchange; always two on column blocks of a mesh,
    ``n_local`` owners of n a block; a packed row is n / 2 bytes);
    ``pallas_variant="m8"`` pins the single-pass pull, which runs the same
    frame and takes the same form and cluster size under its own name
    ("m8", "m8_cluster", "m8_two_pass")."""
    n = cfg.n_nodes
    blocks = 1 if n_local is None else n // n_local
    row_len, itemsize = (n // 2, 1) if cfg.version_dtype == "u4r" else (
        n, DTYPES[cfg.version_dtype].itemsize)
    form, k = pairs_pull.pull_form(row_len, itemsize, blocks)
    if cfg.pallas_variant == "m8":
        return form.replace("pairs", "m8"), k
    return form, k


def plain_pull_reason(cfg: SimConfig, has_topology: bool = False) -> str | None:
    """Why a config that asks for the kernels runs its pull plain — the
    reference's reason name, its first failing gate in the order of its
    ``pallas_fallback_reason`` — or None when a kernel form serves it:
    "topology" (an adjacency run: the choice path), "fault_plan" (the
    effective plan injects link, crash or byzantine behaviour, which the
    kernels carry no mask for; cadence classes alone keep the kernels),
    "pairing"
    (permutation or choice), "packed_dtype" (the u4r rung with
    heartbeats, or pinned to m8: only the pairs kernels carry the nibble
    codec, and only in the lean profile), "fanout" (fanout 0: no
    sub-exchange exists to carry the diagonal refresh and the FD
    epilogue), "shape" (n % 128 != 0: off the grouped matching's
    domain), "budget_policy" (greedy) or "lifecycle" (the kernels carry
    no scheduled-for-deletion mask)."""
    if has_topology:
        return "topology"
    if round_faults(cfg).active:
        return "fault_plan"
    if cfg.pairing != "matching":
        return "pairing"
    if cfg.version_dtype == "u4r" and (cfg.track_heartbeats or cfg.pallas_variant == "m8"):
        return "packed_dtype"
    if cfg.fanout < 1:
        return "fanout"
    if cfg.n_nodes % 128 != 0:
        return "shape"
    if cfg.budget_policy != "proportional":
        return "budget_policy"
    if lifecycle_enabled(cfg):
        return "lifecycle"
    return None


class RoundFaults(NamedTuple):
    """What a config's fault plan and heterogeneity inject, resolved once
    per config (``round_faults``): the effective plan (the configured one
    plus the WAN classes' link faults) and the static predicates the
    round branches on, as the reference's ``sim_step`` does."""

    plan: object | None
    links: bool  # partitions or link faults with a nonzero failure rate
    nodes: bool  # crash windows
    amnesia: bool  # crash windows restarting with recovery="amnesia"
    byzantine: bool  # byzantine entries with a nonzero rate
    quarantine: bool  # cfg.quarantine and a link fault it acts on
    cadence: object | None  # the heterogeneity model when it has cadence classes

    @property
    def active(self) -> bool:
        """Whether the plan injects anything the kernels carry no mask for
        (the reference's ``_fault_plan_active``; cadence is not)."""
        return self.links or self.nodes or self.byzantine


@functools.lru_cache(maxsize=64)
def round_faults(cfg: SimConfig) -> RoundFaults:
    """The config's ``RoundFaults`` (static: resolved once per config)."""
    plan = fsim.effective_fault_plan(cfg.fault_plan, cfg.heterogeneity)
    het = cfg.heterogeneity
    return RoundFaults(
        plan=plan,
        links=fsim.plan_affects_links(plan),
        nodes=fsim.plan_affects_nodes(plan),
        amnesia=fsim.plan_amnesia_restarts(plan),
        byzantine=fsim.plan_affects_byzantine(plan),
        quarantine=cfg.quarantine and fsim.plan_quarantines(plan),
        cadence=het if het is not None and het.cadence_effective() else None,
    )


def lifecycle_enabled(cfg: SimConfig) -> bool:
    """Whether the two-stage dead-node lifecycle runs (the FD on and a
    grace set)."""
    return cfg.track_failure_detector and cfg.dead_grace_ticks is not None


def resolve_phases(
    cfg: SimConfig, device, sweep: bool = False, n_local: int | None = None,
    has_topology: bool = False,
) -> Phases:
    """Resolve both phases of a round once (the counterpart of the
    reference's ``pallas_fallback_reason`` / ``pallas_path_engaged`` /
    ``fd_phase_engaged``).

    The pull is "pairs", "pairs_cluster" or "pairs_two_pass" (the
    pair-fused pull: one launch a sub-exchange staged by one CTA or by a
    cluster of CTAs, or two launches; ``pairs_pull.pull_form``), "m8",
    "m8_cluster" or "m8_two_pass" (the same forms of the single-pass
    pull, pinned by ``pallas_variant="m8"``), or "plain": no kernels
    wanted, or a route the reference serves with XLA for want of a
    kernel (``plain_pull_reason``; ``has_topology``: the round draws its
    peers from an adjacency).

    The FD phase is "fused" (the epilogue of the round's last pairs
    sub-exchange), "kernel" (the standalone pass: the m8 forms' and the
    plain routes', as in the reference), "plain", or "off" (no failure
    detector). The lifecycle's FD runs plain (it rewrites w and hb and
    carries dead_since), as does the shrunk bookkeeping off the pairs
    path, which the standalone kernel (nor the reference's) does not
    take: where the kernels are wanted that is "fd_packed_bookkeeping".
    The standalone kernel takes blocks of a multiple of ``fd.FD_ALIGN``
    owners; the reference's gates its own on n_local % 128 == 0, the
    TPU's lane tiling, which a CUDA kernel does not need (the state is
    bit-equal either way), so here a width such as 10,000 runs it.

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
    unsharded forms. A kernel form on more than one block needs
    lane-aligned blocks (``BLOCK_ALIGN``, the reference's sharded kernel
    domain): off it the round is refused naming the width; a plain pull
    takes any block ``block_width`` gives."""
    wanted = kernels_wanted(cfg, device)
    pull_fallback = plain_pull_reason(cfg, has_topology) if wanted else None
    pull = kernel_pull_form(cfg, n_local)[0] if wanted and pull_fallback is None else "plain"
    if pull != "plain" and n_local is not None and n_local < cfg.n_nodes and n_local % BLOCK_ALIGN:
        raise ValueError(
            f"column blocks of n_local={n_local} owners are off the kernels' "
            f"domain (n_local % {BLOCK_ALIGN} == 0, the reference's "
            "lane-aligned shard); use fewer blocks or use_pallas=False"
        )
    if sweep and pull in M8_FORMS:
        pull, pull_fallback = "plain", "sweep_needs_pairs"
    fd, fd_fallback = "off", None
    width = cfg.n_nodes if n_local is None else n_local
    if cfg.track_failure_detector:
        if cfg.use_pallas_fd is False or lifecycle_enabled(cfg):
            fd = "plain"
        elif pull in PAIRS_FORMS:
            fd = "fused"
        elif sweep or fd_bookkeeping_packed(cfg):
            fd = "plain"
            if wanted and fd_bookkeeping_packed(cfg):
                fd_fallback = "fd_packed_bookkeeping"
        elif (cfg.use_pallas_fd is True or wanted) and width % fd_mod.FD_ALIGN == 0:
            fd = "kernel"
        else:
            fd = "plain"
    return Phases(pull, pull_fallback, fd, fd_fallback)


def pull_phase_engaged(
    cfg: SimConfig, device, n_local: int | None = None, has_topology: bool = False
) -> str:
    """The form that serves the sub-exchanges (``resolve_phases``)."""
    return resolve_phases(cfg, device, n_local=n_local, has_topology=has_topology).pull


def pull_fallback_reason(cfg: SimConfig, device) -> str | None:
    """Why a config that asks for the kernels runs its pull plain anyway
    (``plain_pull_reason``), or None (``resolve_phases``)."""
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
    draws=None,
    run_salt: int | None = None,
    adjacency: torch.Tensor | None = None,
    degrees: torch.Tensor | None = None,
):
    """Advance the whole cluster by one gossip round.

    ``key`` is the run's key (``prng.key(seed)``). ``tick`` is the host
    value of ``state.tick`` and ``draws`` the round's ``prng.RoundDraws``
    on the state's device (``prng.chunk_draws(...).round(r)``) — both
    derived here when not given (reading
    ``state.tick`` then costs a device sync); ``Simulator`` passes them,
    drawn a chunk at a time on the device, so its loop never syncs.
    ``run_salt`` is ``prng.run_salt(key)``. ``adjacency`` / ``degrees``
    (a ``Topology``'s arrays as tensors) restrict each node's peers to
    its adjacency row, as the reference's topology runs.

    ``return_converged=True`` also returns the all-converged flag of the
    new state (a bool tensor); on the pairs path it rides the round's
    last sub-exchange.
    """
    out = step_blocks(
        [state], key, cfg, offsets=(0,), return_converged=return_converged,
        tick=tick, draws=draws, run_salt=run_salt, adjacency=adjacency, degrees=degrees,
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
    draws=None,
    run_salt: int | None = None,
    adjacency: torch.Tensor | None = None,
    degrees: torch.Tensor | None = None,
):
    """One gossip round of a state held as column blocks of the owners
    (the reference's ``sim_step(axis_name="owners")`` under shard_map):
    ``blocks[k]`` holds the (N, n_local) matrices of the global owners
    ``offsets[k] ..`` and the replicated (N,) vectors and tick. The
    replicated work (the churn, the draws) runs once, on the first
    block's device, and is copied to the others; every phase then runs
    block after block between the collectives (``reduce_blocks``): each
    sub-exchange's deficit totals (greedy: the earlier blocks' row sums)
    are reduced over the blocks before any block's pull reads them (the
    two-pass kernel forms; the plain round likewise), the view draw
    takes each block's best peer and then the best over the blocks, the
    FD phase runs per block at its offset, and the convergence flag is
    the min over the blocks. ``sim_step`` is this round on one block of
    every owner. Returns the new blocks (and the flag with
    ``return_converged``); the other arguments are ``sim_step``'s."""
    head = blocks[0]
    n_local = state_n_local(head)
    dev = head.w.device
    rep = _replicas([b.w.device for b in blocks])
    owned = [slice(o, o + n_local) for o in offsets]
    if tick is None:
        tick = int(head.tick)
    new_tick = tick + 1
    if run_salt is None:
        run_salt = prng.run_salt(key)
    has_topology = adjacency is not None
    if cfg.quarantine and has_topology:
        raise ValueError(
            "quarantine is not supported with a topology (the "
            "adjacency draw carries no per-peer mask)"
        )
    if draws is None:
        draws = prng.chunk_draws(
            key.to(dev), new_tick, 1, cfg, alive=head.alive, adjacency=adjacency,
            degrees=degrees,
        ).round(0)

    alive = head.alive
    if draws.dies is not None:
        # Churn (the ground truth): the round's flips, written into the
        # new state; heartbeats, writes and every pair's validity follow
        # the flipped mask.
        alive = torch.where(alive, ~draws.dies, draws.revives)
    # The fault plan (faults/sim.py): a crash window overrides the
    # round's effective liveness (the node's heartbeat and writes freeze,
    # its exchanges void) without touching the churn ground truth, and an
    # amnesiac restart resets the node's knowledge rows before the
    # exchanges. Cadence classes gate each handshake by its initiator.
    faults, n = round_faults(cfg), cfg.n_nodes
    eff_alive = alive
    if faults.nodes and fsim.crashes_now(faults.plan, new_tick):
        eff_alive = alive & ~fsim.crash_mask(faults.plan, n, new_tick, dev)
    if faults.amnesia and fsim.restarts_now(faults.plan, new_tick):
        reset = fsim.amnesia_restart_mask(faults.plan, n, new_tick, dev)
        for b, r, off in zip(blocks, rep(reset), offsets):
            amnesia_reset_(cfg, b, r, off)
    cad = None
    if faults.cadence is not None:
        cad = fsim.cadence_on(faults.cadence, n, new_tick, dev)
    eff_i32 = eff_alive.to(torch.int32)
    heartbeat = head.heartbeat + eff_i32
    max_version = head.max_version + cfg.writes_per_round * eff_i32
    alive_b, eff_b = rep(alive), rep(eff_alive)
    hbt_b, mv_b = rep(heartbeat), rep(max_version)
    track_hb = cfg.track_heartbeats
    phases = resolve_phases(
        cfg, dev, n_local=None if len(blocks) == 1 else n_local, has_topology=has_topology
    )
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
        p = draws.p[c]
        valid = eff_alive & eff_alive[p]
        if cad is not None:
            # A matched pair exchanges when either side is on-cadence.
            valid = valid & (cad | cad[p])
        return zip(rep(draws.gm[c]), rep(draws.c[c]), rep(p), rep(valid))

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
                    kw["check"] = (mv_b[k][sl], eff_b[k], eff_b[k][sl])
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
        # The lifecycle's digest exclusion, from the pre-round stamps.
        scheds = [scheduled_for_deletion_mask(b, cfg, new_tick) for b in blocks]
        hb0s = _plain_exchanges(
            cfg, blocks, ws, hbs, offsets, refresh, hbv, salt_of, run_salt, draws,
            eff_b, scheds, view_salt=-(new_tick + 1) * cfg.fanout,
            choice=has_topology or cfg.pairing == "choice",
            faults=_FaultRound(cfg, faults, new_tick) if faults.active else None, cad=cad,
        )

    for k, b in enumerate(blocks):
        if fd_phase == "kernel":
            fd_mod.fused_fd(
                new_tick, hbs[k], hb0s[k], hbv[k], b.last_change, b.imean, b.icount,
                b.live_view, params, owner_offset=offsets[k],
            )
        elif fd_phase == "plain":
            # The reference's XLA block; hb0's diagonal is refreshed
            # again, idempotently.
            fd_mod.fused_fd_plain(
                new_tick, hbs[k], hb0s[k], hbv[k], b.last_change, b.imean, b.icount,
                b.live_view, params, owner_offset=offsets[k],
            )
            counters.plain_calls["fd"] += 1
            if lifecycle_enabled(cfg):
                lifecycle_(cfg, new_tick, ws[k], hbs[k], b.last_change, b.live_view,
                           b.dead_since, eff_b[k])

    ticks = rep(head.tick + 1)
    new_blocks = [
        b.replace(
            tick=ticks[k], max_version=mv_b[k], heartbeat=hbt_b[k], alive=alive_b[k], w=ws[k],
            hb_known=hbs[k],
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
    device_key: torch.Tensor | None = None, adjacency: torch.Tensor | None = None,
    degrees: torch.Tensor | None = None,
):
    """Queue ``m`` rounds of the blocks from host tick ``tick``, with no
    host sync: the chunk's draws in one batched pass on the first block's
    device (``prng.chunk_draws``, the categorical peers carried through
    the chunk's churn from the blocks' alive mask), then each round
    (``step_blocks``, on the topology ``adjacency`` / ``degrees`` when
    given). Returns the new blocks and a device scalar holding the first
    converged tick among the rounds (0 if none; always 0 unless
    ``tracked``). The draws and each round are ``torch.profiler`` ranges
    (``aiocluster_torch.draws`` / ``aiocluster_torch.sim_step``)."""
    dev = blocks[0].w.device
    if run_salt is None:
        run_salt = prng.run_salt(key)
    if device_key is None:
        device_key = key.to(dev)
    with record_function("aiocluster_torch.draws"):
        draws = prng.chunk_draws(
            device_key, tick + 1, m, cfg, alive=blocks[0].alive, adjacency=adjacency,
            degrees=degrees,
        )
    first = torch.zeros((), dtype=torch.int32, device=dev)
    for r in range(m):
        with record_function("aiocluster_torch.sim_step"):
            out = step_blocks(
                blocks, key, cfg, offsets=offsets, return_converged=tracked,
                tick=tick + r, draws=draws.round(r), run_salt=run_salt,
                adjacency=adjacency, degrees=degrees,
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


def _plain_exchanges(cfg, blocks, ws, hbs, offsets, refresh, hbv, salt_of, run_salt, draws,
                     alive, scheds, view_salt, choice, faults=None, cad=None):
    """The round's sub-exchanges as plain PyTorch ops, block after block,
    in ``ws``/``hbs`` (new tensors): the owner diagonal refreshed, then
    each sub-exchange's handshake directions (``_direction_stats``: the
    deficits' row totals or greedy offsets reduced over the blocks first;
    then ``_advance_rows`` a block of rows at a time) applied from the
    pre-exchange matrices — the reference's XLA round; one block is the
    unsharded round. A matching is one direction; a permutation two, row
    i pulling from ``p[i]`` and from ``inv[i]``, joined by their max; a
    choice sub-exchange is the initiator's pull from its peer and the
    responder's scatter-max of its own advance into the peer's row (the
    peers drawn, or the view draw of the blocks' pre-round live views).
    Each row block's advances are applied as they are computed, so no
    (N, n_local) advance matrix is held. ``alive`` (the round's effective
    liveness: churn and crash windows) and ``scheds`` (the lifecycle's
    scheduled-for-deletion masks, or None) are per block; ``faults`` (a
    ``_FaultRound``, or None) adds the link permits and the byzantine
    guard blocks, ``cad`` (the cadence mask, or None) gates each
    handshake by its initiator (a matched pair by either side). Returns
    the round-start hb of each block (refreshed)."""
    n = cfg.n_nodes
    track_hb, packed = cfg.track_heartbeats, is_packed_w(ws[0])
    rep = _replicas([w.device for w in ws])
    owners = []
    for k, b in enumerate(blocks):
        dev = b.w.device
        ids = torch.arange(n, device=dev)
        local = torch.arange(state_n_local(b), device=dev)
        cols = offsets[k] + local
        owners.append(cols)
        # The owner diagonal (w[j, j] = max_version[j], the heartbeat's
        # likewise) written into copies: the element (cols[j], j).
        if packed:
            # Owner writes raise every observer's residual (saturating),
            # then each owner's residual on itself is 0.
            w = packed_writes_shift(b.w, refresh[k]) if cfg.writes_per_round != 0 else b.w.clone()
            ws[k] = packed_diag_zero_(w, ids, offsets[k])
        else:
            ws[k] = b.w.clone()
            ws[k][cols, local] = refresh[k].to(b.w.dtype)
        if track_hb:
            hbs[k] = b.hb_known.clone()
            hbs[k][cols, local] = hbv[k].to(b.hb_known.dtype)
    hb0s = list(hbs)
    byz_in = [None if faults is None else faults.byz_in(own) for own in owners]

    def direction(p, salt: int, gate=None, outbound: bool = False):
        """One handshake direction of every block: row i advances toward
        its peer ``p[i]`` (``outbound``: the peer row toward row i) where
        both ends are alive, ``gate`` (N,) allows and the fault plan
        permits the link; with its byzantine guard blocks."""
        dns = []
        gates = [None] * len(ws) if gate is None else rep(gate)
        for k, (a, q, g) in enumerate(zip(alive, rep(p), gates)):
            v = a & a[q]
            if g is not None:
                v = v & g
            blk = hblk = None
            if faults is not None:
                ids = torch.arange(n, device=q.device)
                snd, rcv = (ids, q) if outbound else (q, ids)
                v, blk, hblk = faults.direction(v, snd, rcv, salt, owners[k], byz_in[k])
            dns.append(_Direction(q, None, v, salt, blk, hblk) if outbound
                       else _Direction(None, q, v, salt, blk, hblk))
        return dns

    def absorb(k, dn):
        """The hb rows a direction's receivers take from their senders
        (their advertised heartbeats, 0 where masked)."""
        ok = dn.valid[:, None]
        if scheds[k] is not None:
            ok = ok & ~_gather(scheds[k], dn.send)
        return _zero_blocked(torch.where(ok, _gather(hbs[k], dn.send), 0), dn.hb_block)

    if choice:
        peers = draws.peers
        if peers is None:
            peers = view_peers(cfg, blocks, offsets, view_salt, run_salt)
        for c in range(cfg.fanout):
            p = peers[:, c]
            # Row i initiates this handshake: its cadence gates both
            # directions (responders serve but never initiate).
            d_in = direction(p, salt_of(c), cad)
            d_out = direction(p, salt_of(c) + 1, cad, outbound=True)
            st_in = _direction_stats(cfg, ws, scheds, d_in)
            st_out = _direction_stats(cfg, ws, scheds, d_out)
            for k, w in enumerate(ws):
                q = d_out[k].recv
                # The initiator applies the responder's delta, then the
                # responder ours (a max: any scatter order is exact),
                # both from the pre-exchange w.
                w_next = torch.empty_like(w)
                blocks_k = list(row_blocks(n, w.shape[1]))
                for r0, r1 in blocks_k:
                    w_next[r0:r1] = w[r0:r1] + _advance_rows(
                        cfg, w, d_in[k], scheds[k], owners[k], st_in[k], run_salt, r0, r1)
                for r0, r1 in blocks_k:
                    a_out = _advance_rows(
                        cfg, w, d_out[k], scheds[k], owners[k], st_out[k], run_salt, r0, r1)
                    scatter_max_rows_(w_next, q[r0:r1], w[q[r0:r1]] + a_out)
                ws[k] = w_next
                if track_hb:
                    hb_next = torch.maximum(hbs[k], absorb(k, d_in[k]))
                    ok = d_out[k].valid[:, None]
                    if scheds[k] is not None:
                        ok = ok & ~scheds[k]
                    sent = _zero_blocked(torch.where(ok, hbs[k], 0), d_out[k].hb_block)
                    scatter_max_rows_(hb_next, q, sent)
                    hbs[k] = hb_next
                counters.plain_calls["pull"] += 1
        return hb0s
    for c in range(cfg.fanout):
        p = draws.p[c]
        if draws.inv is None:
            # A matched pair exchanges when either side is on-cadence.
            dirs = [direction(p, salt_of(c), None if cad is None else cad | cad[p])]
        else:
            # The permutation: row i's pull from p[i] belongs to the
            # handshake i initiated, its pull through the inverse (the
            # responder's role, from the same pre-exchange matrices) to
            # the one inv[i] initiated; each is gated by its initiator.
            inv = draws.inv[c]
            dirs = [direction(p, salt_of(c), cad),
                    direction(inv, salt_of(c) + 1, None if cad is None else cad[inv])]
        stats = [_direction_stats(cfg, ws, scheds, dns) for dns in dirs]
        for k, w in enumerate(ws):
            w_next = torch.empty_like(w)
            for r0, r1 in row_blocks(n, w.shape[1]):
                advs = [_advance_rows(cfg, w, dns[k], scheds[k], owners[k], st[k], run_salt, r0, r1)
                        for dns, st in zip(dirs, stats)]
                if packed:
                    a_lo = functools.reduce(torch.maximum, [a[0] for a in advs])
                    a_hi = functools.reduce(torch.maximum, [a[1] for a in advs])
                    w_next[r0:r1] = packed_apply(w[r0:r1], a_lo, a_hi)
                else:
                    w_next[r0:r1] = w[r0:r1] + functools.reduce(torch.maximum, advs)
            ws[k] = w_next
            if track_hb:
                hbs[k] = functools.reduce(
                    torch.maximum, [torch.maximum(hbs[k], absorb(k, dns[k])) for dns in dirs]
                )
            counters.plain_calls["pull"] += 1
    return hb0s


class _Direction(NamedTuple):
    """One handshake direction of a plain sub-exchange in one block: at
    position i, row ``recv[i]`` (None: row i) advances toward row
    ``send[i]`` (None: row i) where ``valid[i]``; the dither hashes row
    id i with ``salt``. ``block`` / ``hb_block`` (``fsim.ByzBlock`` or
    None) are the owner columns whose advances / heartbeats the
    receivers' byzantine guards reject, by position."""

    recv: torch.Tensor | None
    send: torch.Tensor | None
    valid: torch.Tensor
    salt: int
    block: fsim.ByzBlock | None = None
    hb_block: fsim.ByzBlock | None = None


class _FaultRound:
    """A round's fault plan lowered for the plain exchanges
    (``faults/sim.py`` at the round's tick): per handshake direction the
    link permits ANDed into its validity, and its byzantine guard blocks
    — the sender-side ones (``byz_out_block``) joined with the
    receiver-side starvation (``byz_in_block``, gathered at the
    receivers), and the heartbeat block (``byz_hb_block``)."""

    def __init__(self, cfg: SimConfig, faults: RoundFaults, tick: int):
        self.plan, self.faults, self.tick, self.n = faults.plan, faults, tick, cfg.n_nodes

    def byz_in(self, owners: torch.Tensor):
        if not self.faults.byzantine:
            return None
        return fsim.byz_in_block(self.plan, self.n, self.tick, owners)

    def direction(self, valid, snd, rcv, salt: int, owners, byz_in):
        """(valid, block, hb_block) of the direction ``snd[i] -> rcv[i]``
        with dither salt ``salt`` over the block's ``owners``."""
        if self.faults.links:
            valid = valid & fsim.link_ok(self.plan, self.n, self.tick, snd, rcv, salt)
        if not self.faults.byzantine:
            return valid, None, None
        blk = fsim.byz_out_block(self.plan, self.n, self.tick, snd, owners, salt)
        if byz_in is not None:
            blk = byz_in.gather(rcv) | blk
        hblk = fsim.byz_hb_block(self.plan, self.n, self.tick, snd, owners, salt)
        return valid, blk, hblk


def _zero_blocked(x: torch.Tensor, blk) -> torch.Tensor:
    """``x`` with the entries of the guard block ``blk`` (or None) zeroed,
    in place, a block of rows at a time."""
    if blk is not None:
        for r0, r1 in row_blocks(x.shape[0], x.shape[1]):
            x[r0:r1].masked_fill_(blk.rows(r0, r1), 0)
    return x


def amnesia_reset_(cfg: SimConfig, b: SimState, reset: torch.Tensor, col0: int) -> None:
    """The amnesiac restart of the rows ``reset`` ((N,) bool) in one
    column block (the owners ``col0 ..``), in place: the knowledge rows
    return to the fresh-boot state — watermarks, heartbeat knowledge and
    the FD bookkeeping zeroed, the live view believing only the node
    itself, no dead stamps. Owner ground truth is untouched."""
    rows = reset[:, None]
    b.w.masked_fill_(rows, 0)
    if cfg.track_heartbeats:
        b.hb_known.masked_fill_(rows, 0)
    if cfg.track_failure_detector:
        for m in (b.last_change, b.imean, b.icount, b.live_view):
            m.masked_fill_(rows, 0)
        ids = torch.arange(reset.numel(), device=reset.device)
        local = ids - col0
        own = reset & (local >= 0) & (local < b.live_view.shape[1])
        b.live_view[ids[own], local[own]] = True
        if b.dead_since.numel():
            b.dead_since.masked_fill_(rows, 0)


def _gather(m: torch.Tensor, idx: torch.Tensor | None, r0: int = 0, r1: int | None = None):
    """Rows ``idx[r0:r1]`` of ``m`` (rows ``r0:r1`` when ``idx`` is None)."""
    if idx is None:
        return m[r0:r1]
    return m[idx[r0:r1]]


def _direction_deficits(w, dn: _Direction, sched, r0: int, r1: int) -> torch.Tensor:
    """Positions ``r0:r1`` of a direction's deficits, zero where the pair
    is not alive or the sender has scheduled the owner for deletion (the
    reference's ``col_ok``)."""
    d = deficits(_gather(w, dn.recv, r0, r1), _gather(w, dn.send, r0, r1), dn.valid[r0:r1])
    if sched is not None:
        d = torch.where(_gather(sched, dn.send, r0, r1), 0, d)
    return d


def _direction_stats(cfg, ws, scheds, dns) -> list:
    """The first pass of one handshake direction (``dns``, one
    ``_Direction`` per block) of the reference's ``_budgeted_advance``:
    every block's row totals of the deficits (proportional: float32,
    summed over the blocks; greedy: exact sums, each block offset by the
    earlier blocks'), one (N,) tensor per block. The budget counts every
    column, the byzantine-blocked ones too."""
    n = ws[0].shape[0]
    packed = is_packed_w(ws[0])
    greedy = cfg.budget_policy == "greedy"
    parts = []
    for w, dn, sched in zip(ws, dns, scheds):
        part = torch.empty(n, dtype=torch.int64 if greedy else torch.float32, device=w.device)
        for r0, r1 in row_blocks(n, w.shape[1]):
            if packed:
                part[r0:r1] = packed_totals(
                    _gather(w, dn.recv, r0, r1), _gather(w, dn.send, r0, r1), dn.valid[r0:r1]
                )
                continue
            d = _direction_deficits(w, dn, sched, r0, r1)
            part[r0:r1] = d.sum(dim=1, dtype=torch.int64) if greedy else deficit_totals(d)
        parts.append(part)
    if not greedy:
        return reduce_blocks(parts, "sum")
    # Global owner order across the blocks: block k's cumsum starts at
    # the row sums of blocks 0 .. k - 1.
    stats, acc = [], torch.zeros_like(parts[0])
    for part in parts:
        stats.append(acc.to(part.device))
        acc = acc + part.to(acc.device)
    return stats


def _advance_rows(cfg, w, dn: _Direction, sched, own, st, run_salt, r0: int, r1: int):
    """Positions ``r0:r1`` of one block's advances of a direction (the
    second pass of ``_budgeted_advance`` on the block's first-pass
    ``st``): in w's dtype, or on the packed rung the int32 nibble halves
    (a_lo, a_hi); zero on the columns of the direction's byzantine guard
    block, whose budget share was spent all the same."""
    ids = torch.arange(r0, r1, device=w.device)
    if is_packed_w(w):
        return packed_adv_halves(
            _gather(w, dn.recv, r0, r1), _gather(w, dn.send, r0, r1), cfg.budget,
            dn.valid[r0:r1], dn.salt, own, run_salt, st[r0:r1], row_ids=ids,
        )
    d = _direction_deficits(w, dn, sched, r0, r1)
    if cfg.budget_policy == "greedy":
        adv = greedy_advance(d, st[r0:r1], cfg.budget)
    else:
        scale = budget_scale(st[r0:r1], cfg.budget)
        adv = proportional_advance(d, scale, dn.salt, own, run_salt, ids).to(w.dtype)
    if dn.block is not None:
        adv.masked_fill_(dn.block.rows(r0, r1), 0)
    return adv


def greedy_advance(d: torch.Tensor, offset: torch.Tensor, budget: int) -> torch.Tensor:
    """The reference's greedy policy on deficit rows ``d``: each owner
    takes what is left of the budget after the owners before it in
    global order, ``clip(budget - c, 0, d)``, with ``c`` the exclusive
    cumsum of the row's deficits (``offset``: the rows' sums over the
    owners of earlier column blocks). The reference sums in int32, so
    ``c`` and ``budget - c`` wrap as int32 do (exact int64 sums, wrapped
    once: the same residues)."""
    d64 = d.to(torch.int64)
    c = torch.cumsum(d64, dim=1) - d64 + offset[:, None]
    left = prng.wrap_i32(budget - c)
    return torch.minimum(torch.clamp(left, min=0), d64).to(d.dtype)


def scatter_max_rows_(dst: torch.Tensor, rows: torch.Tensor, src: torch.Tensor) -> torch.Tensor:
    """``dst[rows[i]] = max(dst[rows[i]], src[i])`` for every i, in place
    (the reference's ``dst.at[rows].max(src)``): a max is order-free, so
    the order the repeated rows land in does not matter."""
    index = rows[:, None].expand(src.shape)
    return dst.scatter_reduce_(0, index, src.to(dst.dtype), "amax", include_self=True)


# -- the view draw ------------------------------------------------------------------
#
# peer_mode="view" samples each row's peer from its own live view by a
# Gumbel-max over the 32-bit hash of (row, global owner, salt): u =
# float32(h) * 2^-32, clipped to [1e-12, 1 - 2^-24], noise -log(-log(u)),
# +64 for live non-self peers, -1e30 for the row itself. The scores are
# quantised (ties are frequent at the top), so the port computes them with
# the float32 logarithm the reference gets from XLA on the CPU (Cephes'
# polynomial with the same fused multiply-adds), not a library log that
# differs from it in the last place.

NEG_INF = -1e30
LIVE_BONUS = 64.0
_LOG_P = tuple(float(np.float32(x)) for x in (
    7.0376836292e-2, -1.1514610310e-1, 1.1676998740e-1, -1.2420140846e-1,
    1.4249322787e-1, -1.6668057665e-1, 2.0000714765e-1, -2.4999993993e-1,
    3.3333331174e-1,
))
_LOG_Q1, _LOG_Q2 = float(np.float32(-2.12194440e-4)), float(np.float32(0.693359375))
_SQRT_HALF = float(np.float32(0.707106781186547524))


def xla_log(x: torch.Tensor) -> torch.Tensor:
    """The float32 natural log the reference's view draw takes on XLA's
    CPU backend, for positive normal float32 ``x``: Cephes' range
    reduction to [sqrt(1/2), sqrt(2)) and degree-8 polynomial, with the
    fused multiply-adds XLA emits (``fma32``); every other step rounds to
    float32 as it goes."""
    bits = x.view(torch.int32)
    e = 1.0 + ((bits >> 23) - 127).to(torch.float32)
    m = ((bits & 0x007FFFFF) | 0x3F000000).view(torch.float32)
    low = m < _SQRT_HALF
    m0 = torch.where(low, m, 0.0)
    m = m - 1.0
    e = e - low.to(torch.float32)
    m = m + m0
    x2 = m * m
    x3 = x2 * m
    p = _LOG_P
    y, y1, y2 = fma32(p[0], m, p[1]), fma32(p[3], m, p[4]), fma32(p[6], m, p[7])
    y, y1, y2 = fma32(y, m, p[2]), fma32(y1, m, p[5]), fma32(y2, m, p[8])
    y = fma32(y, x3, y1)
    y = fma32(y, x3, y2)
    y = fma32(y, x3, e * _LOG_Q1)
    m = m - x2 * 0.5
    m = m + y
    return m + e * _LOG_Q2


# Rows per block of the view draw's scores: about 2^22 elements, so its
# float64 transients stay near 32 MB each.
VIEW_BLOCK_ELEMS = 1 << 22


def view_block_best(live: torch.Tensor, salt: int, run_salt: int, col0: int = 0):
    """One column block's best view-draw peer of every row (the
    reference's ``_view_peer_choice`` before its cross-shard step):
    ``live`` is the (N, n_local) bool live view of the owners ``col0
    ..``. Returns the float32 best scores and their int64 global owner
    ids (ties to the lowest), (N,) each."""
    n, n_cols = live.shape
    dev = live.device
    cols = col0 + torch.arange(n_cols, device=dev)
    s = (int(salt) ^ int(run_salt)) & M32
    best_s = torch.empty(n, dtype=torch.float32, device=dev)
    best_i = torch.empty(n, dtype=torch.int64, device=dev)
    rows = max(1, VIEW_BLOCK_ELEMS // n_cols)
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        ids = torch.arange(r0, r1, device=dev)
        h = hash_mix_u32(ids[:, None], cols[None, :], s)
        u = torch.clamp(h.to(torch.float32) * 2.0**-32, min=1e-12, max=1.0 - 2.0**-24)
        g = -xla_log(-xla_log(u))
        is_self = ids[:, None] == cols[None, :]
        score = torch.where(
            live[r0:r1] & ~is_self, g + LIVE_BONUS, torch.where(is_self, NEG_INF, g)
        )
        best_s[r0:r1] = score.amax(dim=1)
        best_i[r0:r1] = cols[torch.argmax(score, dim=1)]
    return best_s, best_i


def view_peers(cfg: SimConfig, blocks, offsets, view_salt: int, run_salt: int) -> torch.Tensor:
    """(N, fanout) peers of the view draw (``peer_mode="view"``) over a
    state's column blocks: sub-exchange ``c`` salts the hash with
    ``view_salt + c``; each block's best, then the best over the blocks
    in block order (an earlier block wins a tie), as the reference's
    all_gather and argmax. On the first block's device."""
    dev = blocks[0].w.device
    cols = []
    for c in range(cfg.fanout):
        best = None
        for b, off in zip(blocks, offsets):
            sc, ix = (t.to(dev) for t in view_block_best(b.live_view, view_salt + c, run_salt, off))
            if best is None:
                best = (sc, ix)
            else:
                take = sc > best[0]
                best = (torch.where(take, sc, best[0]), torch.where(take, ix, best[1]))
        cols.append(best[1])
    return torch.stack(cols, dim=1)


# -- the dead-node lifecycle ------------------------------------------------------


def scheduled_for_deletion_mask(state: SimState, cfg: SimConfig, tick: int):
    """(N, n_local) bool: observer i has had owner j scheduled for
    deletion for at least half the grace at ``tick`` (the round's tick;
    from the pre-round stamps) — the digest-exclusion stage: such rows
    stop sending j's state and advertising j's heartbeat. None when the
    lifecycle is off."""
    if not lifecycle_enabled(cfg):
        return None
    ds = state.dead_since.to(torch.int32)
    return (ds > 0) & ((tick - ds) >= cfg.dead_grace_ticks // 2)


def lifecycle_(cfg: SimConfig, tick: int, w, hb, lc, live, dead_since, alive) -> None:
    """The lifecycle's step after the plain FD block, in place on one
    column block: an alive observer stamps a known owner dead at its
    live -> dead transition (a live owner clears the stamp); once the
    full grace has passed the pair is forgotten — watermark, heartbeat
    knowledge, last change and stamp reset to 0. ``live`` is the block's
    new live view (bool or bitmap), ``alive`` the round's effective
    liveness (the churn ground truth less the crash windows: a crashed
    node's FD bookkeeping freezes too)."""
    live = unpack_bits(live) if is_packed_live(live) else live
    row_alive = alive[:, None]
    known = ((w > 0) | (hb > 0)) & row_alive
    ds32 = dead_since.to(torch.int32)
    ds = torch.where(live, 0, torch.where((ds32 == 0) & known, tick, ds32))
    gc_now = (ds > 0) & ((tick - ds) >= cfg.dead_grace_ticks) & row_alive
    w.masked_fill_(gc_now, 0)
    hb.masked_fill_(gc_now, 0)
    lc.masked_fill_(gc_now, 0)
    dead_since.copy_(torch.where(gc_now, 0, ds))


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
    values as static fields; a lane's fault seed and attacker fraction
    as its own plan, ``replace(plan, seed=...)`` and
    ``fsim.with_byz_frac``), pinned to the plain round: the sweep's plain
    route runs every lane through ``sim_step`` with it."""
    values = {
        name: getattr(sweep, name).tolist()
        for name in ("fanout", "phi_threshold", "writes_per_round")
        if getattr(sweep, name) is not None
    }
    seeds = None if sweep.fault_seed is None else sweep.fault_seed.tolist()
    fracs = None if sweep.byz_frac is None else sweep.byz_frac.tolist()
    out = []
    for s in range(lanes):
        plan = cfg.fault_plan
        if seeds is not None:
            plan = dataclasses.replace(plan, seed=seeds[s])
        if fracs is not None:
            plan = fsim.with_byz_frac(plan, fracs[s])
        out.append(dataclasses.replace(
            cfg, use_pallas=False, use_pallas_fd=False, fault_plan=plan,
            **{k: v[s] for k, v in values.items()},
        ))
    return out


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
    ``draws`` are the round's ``prng.RoundDraws`` of every lane (the
    matchings (fanout, S, ...), the churn flips (S, n); ``chunk_draws``
    of the keys), ``salts`` the round's (fanout, S) salt_mix table (``lane_salt_table``), ``run_salts`` the lanes' run
    salts as host ints and ``active`` the (fanout, S) bool table of the
    sub-exchanges each lane runs (``c < f_lane``; None when fanout is not
    swept).

    On the pairs forms each sub-exchange is one lane launch for all S
    lanes (two in the two-pass form: the totals, then the pull), on the
    lanes' salts and each lane's post-churn alive mask; a lane whose fanout is below the config's voids its
    sub-exchanges ``c >= f_lane`` (``valid`` all 0) while the refresh
    still rides c = 0 and the check and the FD epilogue (with the lane's
    phi) c = fanout - 1. Elsewhere every lane runs the plain round.
    ``return_converged=True`` also returns the (S,) bool flags."""
    lanes, new_tick = states.w.shape[0], tick + 1
    phases = resolve_phases(cfg, states.w.device, sweep=True)
    for why in (phases.pull_fallback, phases.fd_fallback):
        if why is not None:
            counters.fallbacks[why] += 1
    if phases.pull not in PAIRS_FORMS:
        return _plain_lanes(states, keys, cfg, sweep, tick, draws, run_salts,
                            return_converged)
    gm_all, c_all, p_all = draws.gm, draws.c, draws.p

    alive = states.alive
    if draws.dies is not None:
        alive = torch.where(alive, ~draws.dies, draws.revives)
    alive_i32 = alive.to(torch.int32)
    heartbeat = states.heartbeat + alive_i32
    # On the pairs forms the effective plan injects nothing (else the
    # lanes run plain): cadence classes are the one fault-model input.
    cadence = round_faults(cfg).cadence
    cad = None if cadence is None else fsim.cadence_on(cadence, cfg.n_nodes, new_tick, alive.device)
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
        if cad is not None:
            valid &= cad | cad[p_all[c].long()]
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
        tick=states.tick + 1, max_version=max_version, heartbeat=heartbeat, alive=alive, w=w,
        hb_known=hb,
    )
    if not return_converged:
        return new
    return new, flag > 0


def _plain_lanes(states, keys, cfg, sweep, tick, draws, run_salts, return_converged):
    """The plain route of ``sweep_step``: each lane runs ``sim_step``'s
    plain round with its own config on its views of the batch, and what
    the round wrote into new tensors is copied back into the batch."""
    flags = []
    for s, lane_cfg in enumerate(lane_configs(cfg, sweep, states.w.shape[0])):
        view = lane(states, s)
        out = sim_step(
            view, keys[s], lane_cfg, tick=tick, run_salt=run_salts[s],
            draws=draws.lane(s, lane_cfg.fanout), return_converged=return_converged,
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
