"""FaultPlan compiled for the batched simulator: per-round link, crash,
quarantine and byzantine guard masks in PyTorch, on the state's device
(the port of the reference's ``faults/sim.py``).

The sim's unit of network activity is the per-round sub-exchange, so a
plan lowers to mask families that are pure functions of ``(plan, tick,
global indices)``:

- :func:`crash_mask` — (N,) bool, nodes inside a crash window this tick.
  The round freezes their heartbeats and writes and voids their
  exchanges without touching the churn ground truth; the window's end is
  the restart (:func:`amnesia_restart_mask` marks the amnesiac ones).
- :func:`link_ok` — (N,) bool per sub-exchange direction: whether
  traffic ``src[i] -> dst[i]`` is permitted. Partitions mask
  cross-group pairs; drops, mid-handshake EOFs and delays of >= 1 tick
  combine into one per-direction failure probability drawn from the
  gossip round's multiplicative hash of global indices
  (``ops.gossip.hash_mix_u32``), so a run on column blocks sees the
  same masks as the whole width.
- :func:`quarantine_mask` — (N,) bool, peers every breaker-equipped
  initiator has taken out of its choice draw.
- :func:`byz_out_block` / :func:`byz_hb_block` / :func:`byz_in_block` —
  the byzantine kinds lowered as the guarded outcome: owner columns of
  a pull whose advances (or heartbeats) the receiver's guards reject.
  They are (N, n_local) masks held in factored form (:class:`ByzBlock`:
  a row mask times an owner mask per plan entry), which the round
  expands a block of rows at a time.

Everything the reference computes in float32 is computed in float32
here against float32-rounded bounds: node coordinates ``i / n``, the
tick, window edges such as ``at + down_for`` (summed in float64 on the
host, then rounded, as JAX rounds a Python float), failure
probabilities and byzantine rates. The tick is a host integer, so the
windows are decided on the host and only the per-node masks are device
work; nothing here reads the run's random key or syncs the device.

Sweep lanes re-roll the probabilistic draws per lane by the plan's seed
and move the byzantine attacker window per lane; a lane runs
``dataclasses.replace(plan, seed=...)`` (sim/sweep.py), which the
reference's traced overrides equal by construction.
"""

from __future__ import annotations

import functools
from dataclasses import dataclass, replace

import numpy as np
import torch

from ..ops import prng
from .plan import ByzantineFault, FaultPlan, NodeSet, with_extra_links

M32 = prng.M32


def _f32(x: float) -> np.float32:
    """A Python float rounded to float32, as JAX rounds a weakly typed
    scalar against a float32 array (infinity stays infinite)."""
    return np.float32(x)


def _in_window(tick: int, start: float, end: float | None) -> bool:
    """``start <= t < end`` in float32, ``t`` the tick as float32 (end None:
    forever)."""
    t = np.float32(tick)
    return bool(t >= _f32(start)) and (end is None or bool(t < _f32(end)))


@functools.lru_cache(maxsize=256)
def _positions(n: int, device: torch.device) -> torch.Tensor:
    """(n,) float32 node coordinates ``i / n`` (correctly rounded)."""
    return torch.arange(n, dtype=torch.float32, device=device) / n


def _member(ns: NodeSet, n: int, device) -> torch.Tensor | None:
    """(n,) bool: which global indices fall in the fraction-addressed set
    (None = all; name-addressed sets were refused by
    ``check_sim_compatible``)."""
    if ns.matches_all():
        return None
    lo, hi = ns.frac
    return _frac_window(n, float(lo), float(hi), torch.device(device))


@functools.lru_cache(maxsize=256)
def _frac_window(n: int, lo: float, hi: float, device: torch.device) -> torch.Tensor:
    pos = _positions(n, device)
    return (pos >= float(_f32(lo))) & (pos < float(_f32(hi)))


def _pair_uniform(i: torch.Tensor, j: torch.Tensor, salt: int) -> torch.Tensor:
    """Deterministic (i, j, salt) -> [0, 1) draw per index pair: the top 24
    bits of the round's hash, through int32 to float32."""
    from ..ops.gossip import hash_mix_u32

    h = hash_mix_u32(i.to(torch.int64), j.to(torch.int64), salt)
    return (h >> 8).to(torch.int32).to(torch.float32) * (1.0 / 16777216.0)


def _fault_salt(plan: FaultPlan, tick: int, fault_idx: int, sub: int) -> int:
    """One salt per (plan seed, tick, fault entry, sub-exchange direction),
    as uint32 arithmetic."""
    return (
        ((tick & M32) * 0x51ED2701)
        ^ ((plan.seed & M32) * 0x9E3779B9)
        ^ (((fault_idx * 2 + 1) & M32) * 0x7FEB3527)
        ^ ((sub & M32) * 0x85EBCA6B)
    ) & M32


def crash_mask(plan: FaultPlan, n: int, tick: int, device) -> torch.Tensor:
    """(N,) bool: nodes down inside a crash window at this tick."""
    down = torch.zeros(n, dtype=torch.bool, device=device)
    for cr in plan.crashes:
        if not _in_window(tick, cr.at, cr.at + cr.down_for):
            continue
        members = _member(cr.nodes, n, device)
        down = torch.ones_like(down) if members is None else down | members
    return down


def crashes_now(plan: FaultPlan | None, tick: int) -> bool:
    """Whether any crash window is open at this tick (host only)."""
    return plan is not None and any(
        _in_window(tick, cr.at, cr.at + cr.down_for) for cr in plan.crashes
    )


def _link_failure_prob(lf) -> float:
    """Per-direction sub-exchange failure probability of one LinkFault:
    drop, mid-handshake EOF and a >= 1-tick delay each independently
    kill the exchange for the round."""
    p_ok = (1.0 - lf.drop) * (1.0 - lf.eof)
    if lf.delay >= 1.0:
        p_ok *= 1.0 - lf.delay_prob
    return 1.0 - p_ok


def link_ok(
    plan: FaultPlan, n: int, tick: int, src: torch.Tensor, dst: torch.Tensor, sub: int = 0,
) -> torch.Tensor:
    """(N,) bool: is traffic ``src[i] -> dst[i]`` permitted this tick?

    ``sub`` (the direction's dither salt) distinguishes the round's
    sub-exchange directions, so each draws fresh fault randomness: pass
    ``src=p, dst=arange(n)`` for the receive direction of a pull from
    peer ``p`` and ``src=arange(n), dst=p`` for the send direction."""
    dev = src.device
    ok = torch.ones(src.shape, dtype=torch.bool, device=dev)
    for part in plan.partitions:
        if _in_window(tick, part.start, part.end):
            g_src = (src.to(torch.int64) * part.n_groups) // n
            g_dst = (dst.to(torch.int64) * part.n_groups) // n
            ok &= g_src == g_dst
    for idx, lf in enumerate(plan.links):
        p_fail = _link_failure_prob(lf)
        if p_fail <= 0.0 or not _in_window(tick, lf.start, lf.end):
            continue
        hit = _pair_uniform(src, dst, _fault_salt(plan, tick, idx, sub)) < float(_f32(p_fail))
        src_m = _member(lf.src, n, dev)
        if src_m is not None:
            hit &= src_m[src]
        dst_m = _member(lf.dst, n, dev)
        if dst_m is not None:
            hit &= dst_m[dst]
        ok &= ~hit
    return ok


def plan_affects_links(plan: FaultPlan | None) -> bool:
    """Whether the plan carries any link-level behavior the sim must mask
    (partitions, or link faults with a nonzero per-round failure
    probability)."""
    if plan is None:
        return False
    return bool(plan.partitions) or any(_link_failure_prob(lf) > 0.0 for lf in plan.links)


def plan_affects_nodes(plan: FaultPlan | None) -> bool:
    return plan is not None and bool(plan.crashes)


def plan_amnesia_restarts(plan: FaultPlan | None) -> bool:
    """Whether any crash window restarts with ``recovery="amnesia"``."""
    return plan is not None and any(cr.recovery == "amnesia" for cr in plan.crashes)


def _restarts_now(cr, tick: int) -> bool:
    """Whether an amnesiac window ends exactly at this tick: the first
    integer tick with ``t >= at + down_for`` (float32, as the reference)."""
    end = _f32(cr.at + cr.down_for)
    t = np.float32(tick)
    return cr.recovery == "amnesia" and bool(t >= end) and bool(t - np.float32(1) < end)


def restarts_now(plan: FaultPlan | None, tick: int) -> bool:
    """Whether any amnesiac restart happens at this tick (host only)."""
    return plan is not None and any(_restarts_now(cr, tick) for cr in plan.crashes)


def amnesia_restart_mask(plan: FaultPlan, n: int, tick: int, device) -> torch.Tensor:
    """(N,) bool: nodes whose ``recovery="amnesia"`` crash window ended
    exactly at this tick — the restart instant, when the round resets
    their knowledge rows (w, hb_known, the FD bookkeeping) to the
    fresh-boot state. Owner ground truth (``max_version``) persists."""
    reset = torch.zeros(n, dtype=torch.bool, device=device)
    for cr in plan.crashes:
        if not _restarts_now(cr, tick):
            continue
        members = _member(cr.nodes, n, device)
        reset = torch.ones_like(reset) if members is None else reset | members
    return reset


# -- breaker quarantine -------------------------------------------------------
#
# The runtime's per-peer circuit breaker lowered to a per-round peer-
# selection mask: a link fault from every initiator that makes a
# destination set effectively unreachable (per-direction failure
# probability ~1) quarantines those destinations for every initiator,
# starting ``open_after`` ticks into the fault window and ending when it
# heals.

# Only a near-certain per-round failure opens a breaker deterministically
# enough to lower as a mask.
QUARANTINE_MIN_PFAIL = 0.999


def _quarantining(lf) -> bool:
    return (
        lf.src.matches_all()
        and not lf.dst.matches_all()
        and _link_failure_prob(lf) >= QUARANTINE_MIN_PFAIL
    )


def plan_quarantines(plan: FaultPlan | None) -> bool:
    """Whether the plan carries any link fault the quarantine mask acts on
    (all-initiator src, dst-restricted, effectively total failure)."""
    return plan is not None and any(_quarantining(lf) for lf in plan.links)


def quarantine_mask(
    plan: FaultPlan, n: int, tick: int, device, *, open_after: int = 3
) -> torch.Tensor:
    """(N,) bool: peers every initiator has quarantined from its target
    draw this tick (entries with a restricted ``src`` or an all-node
    ``dst`` contribute nothing, as in the reference)."""
    q = torch.zeros(n, dtype=torch.bool, device=device)
    for lf in plan.links:
        if _quarantining(lf) and _in_window(tick, lf.start + open_after, lf.end):
            q = q | _member(lf.dst, n, device)
    return q


def plan_affects_byzantine(plan: FaultPlan | None) -> bool:
    return plan is not None and any(bf.rate > 0.0 for bf in plan.byzantine)


# -- byzantine lowering (defense-on semantics) --------------------------------
#
# The sim cannot store a lie — its watermark matrix is the truth — so the
# byzantine kinds lower as the outcome the runtime's guards produce:
#
# - stale_replay / owner_violation: advances pulled FROM an attacker on
#   victim owner columns are zeroed (byz_out_block); stale_replay also
#   masks heartbeat absorption from the attacker on those columns
#   (byz_hb_block). owner_violation never blocks the attacker's own
#   column (it owns it).
# - digest_inflation: honest responders withhold the victims' data from
#   an attacker, so advances INTO an attacker row on victim columns are
#   zeroed (byz_in_block).
#
# The byzantine rate draws use a stream id base disjoint from the link
# faults' (both feed _fault_salt).
_BYZ_SALT_BASE = 0x10000


@dataclass(frozen=True)
class _ByzTerm:
    """One plan entry's share of a block: row ``i`` (of N) is hit where
    ``pair[i]``, on the owner columns where ``victims`` (None: all), and
    not on the column of the global owner ``own[i]`` when given."""

    pair: torch.Tensor  # (N,) bool
    victims: torch.Tensor | None  # (n_local,) bool
    own: torch.Tensor | None  # (N,) int64 global ids excluded on their column


@dataclass(frozen=True)
class ByzBlock:
    """An (N, n_local) bool mask over a column block's owners ``owners``
    (global ids), held as a union of row-mask x owner-mask terms so the
    round never materialises it whole: ``rows(r0, r1)`` expands a block
    of rows, ``gather(idx)`` re-indexes the rows (row i takes row
    ``idx[i]``), ``|`` joins two masks over the same owners (or None)."""

    terms: tuple[_ByzTerm, ...]
    owners: torch.Tensor

    def rows(self, r0: int, r1: int) -> torch.Tensor:
        out = torch.zeros((r1 - r0, self.owners.numel()), dtype=torch.bool,
                          device=self.owners.device)
        for t in self.terms:
            b = t.pair[r0:r1, None]
            if t.victims is not None:
                b = b & t.victims[None, :]
            if t.own is not None:
                b = b & (self.owners[None, :] != t.own[r0:r1, None])
            out |= b
        return out

    def gather(self, idx: torch.Tensor) -> "ByzBlock":
        return ByzBlock(tuple(
            _ByzTerm(t.pair[idx], t.victims, None if t.own is None else t.own[idx])
            for t in self.terms
        ), self.owners)

    def __or__(self, other: "ByzBlock | None") -> "ByzBlock":
        if other is None:
            return self
        return ByzBlock(self.terms + other.terms, self.owners)


def _byz_pair_mask(
    plan: FaultPlan, bf_idx: int, bf: ByzantineFault, n: int, tick: int,
    src: torch.Tensor, dst: torch.Tensor, sub: int,
) -> torch.Tensor:
    """(N,) bool: entry ``bf`` applies to the directed pair src[i] -> dst[i]
    this tick (window, attacker membership, rate)."""
    dev = src.device
    if not _in_window(tick, bf.start, bf.end):
        return torch.zeros(src.shape, dtype=torch.bool, device=dev)
    attackers = _member(bf.nodes, n, dev)
    hit = (torch.ones(src.shape, dtype=torch.bool, device=dev) if attackers is None
           else attackers[src])
    if bf.rate < 1.0:
        u = _pair_uniform(src, dst, _fault_salt(plan, tick, _BYZ_SALT_BASE + bf_idx, sub))
        hit = hit & (u < float(_f32(bf.rate)))
    return hit


def _byz_block(
    plan: FaultPlan, kinds: tuple[str, ...], n: int, tick: int, src: torch.Tensor,
    dst: torch.Tensor, owners: torch.Tensor, sub: int,
    exclude_own_col_kinds: tuple[str, ...] = (),
) -> ByzBlock | None:
    """The owner columns of the src[i] -> dst[i] transfer voided by the
    named byzantine kinds (None = nothing applies)."""
    terms = []
    for bf_idx, bf in enumerate(plan.byzantine):
        if bf.kind not in kinds or bf.rate <= 0.0:
            continue
        pair = _byz_pair_mask(plan, bf_idx, bf, n, tick, src, dst, sub)
        vic = _member(bf.victims, n, owners.device)
        terms.append(_ByzTerm(
            pair, None if vic is None else vic[owners],
            src.to(torch.int64) if bf.kind in exclude_own_col_kinds else None,
        ))
    return ByzBlock(tuple(terms), owners) if terms else None


def byz_out_block(
    plan: FaultPlan, n: int, tick: int, peer: torch.Tensor, owners: torch.Tensor, sub: int,
) -> ByzBlock | None:
    """Advances pulled FROM ``peer[i]`` (the sender) on owner column j that
    the receiver's guards reject — stale_replay + owner_violation."""
    rows = torch.arange(peer.shape[0], device=peer.device)
    return _byz_block(plan, ("stale_replay", "owner_violation"), n, tick, peer, rows, owners,
                      sub, exclude_own_col_kinds=("owner_violation",))


def byz_hb_block(
    plan: FaultPlan, n: int, tick: int, peer: torch.Tensor, owners: torch.Tensor, sub: int,
) -> ByzBlock | None:
    """Heartbeat knowledge absorbed from ``peer[i]`` on victim columns that
    the attacker's stale digests withhold — stale_replay only."""
    rows = torch.arange(peer.shape[0], device=peer.device)
    return _byz_block(plan, ("stale_replay",), n, tick, peer, rows, owners, sub)


def byz_in_block(plan: FaultPlan, n: int, tick: int, owners: torch.Tensor) -> ByzBlock | None:
    """Advances INTO attacker row i on victim column j that honest
    responders withhold — digest_inflation. Receiver-side, so one mask per
    round, joined into every pull."""
    rows = torch.arange(n, device=owners.device)
    return _byz_block(plan, ("digest_inflation",), n, tick, rows, rows, owners, 0)


def with_byz_frac(plan: FaultPlan, frac: float) -> FaultPlan:
    """``plan`` with every byzantine entry's attackers moved to the window
    [0, frac): the plan a ``byz_frac`` sweep lane runs (the reference's
    traced override, ``i / n < frac`` in float32)."""
    return replace(plan, byzantine=tuple(
        replace(bf, nodes=NodeSet(frac=(0.0, frac))) for bf in plan.byzantine
    ))


# -- heterogeneity lowering ---------------------------------------------------
#
# WAN latency/loss classes compile to derived LinkFaults appended to the
# effective plan; cadence classes lower to a per-tick initiator mask
# folded into sub-exchange validity; zone bias shapes the choice draw
# (ops/prng.py).


def effective_fault_plan(plan: FaultPlan | None, heterogeneity) -> FaultPlan | None:
    """The plan the sim injects: the configured plan plus the
    heterogeneity model's derived WAN LinkFaults (None when neither
    contributes)."""
    if heterogeneity is None:
        return plan
    return with_extra_links(plan, heterogeneity.wan_link_faults())


def cadence_on(heterogeneity, n: int, tick: int, device) -> torch.Tensor:
    """(N,) bool: nodes whose cadence class initiates gossip this tick
    (class-k nodes fire when tick % gossip_every[k] == 0; the last class
    takes every position at or above its start)."""
    pos = _positions(n, torch.device(device))
    on = torch.zeros(n, dtype=torch.bool, device=device)
    cum = 0.0
    last = len(heterogeneity.class_frac) - 1
    for k, frac in enumerate(heterogeneity.class_frac):
        lo, cum = cum, cum + frac
        if tick % int(heterogeneity.gossip_every[k]) != 0:
            continue
        member = pos >= float(_f32(lo))
        if k < last:
            member &= pos < float(_f32(cum))
        on |= member
    return on
