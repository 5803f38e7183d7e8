"""The batched gossip round in PyTorch: one ScuttleButt round for all N
nodes as tensor passes over the (N, N) watermark, heartbeat and
failure-detector matrices — the port of the reference's ops/gossip.py
for the slice it covers (grouped matching, proportional budget, FD on or
off, no churn, no lifecycle, no fault plan).

Two implementations serve a round, resolved once per call by
``pull_phase_engaged`` / ``fd_phase_engaged`` (the counterparts of the
reference's ``pallas_path_engaged`` / ``pallas_variant_engaged`` /
``fd_phase_engaged``):

- on a CUDA device (``use_pallas="auto"``): every sub-exchange is one
  launch of the pair-fused pull kernel (ops/pairs_pull.py); the first
  also refreshes the owner diagonal, the last also runs the FD phase
  ("fused") and the convergence check. A config the kernel cannot take
  is refused, never run plain;
- ``use_pallas=False, use_pallas_fd=True`` on a CUDA device: the pull
  runs as plain PyTorch ops and the FD phase as the standalone kernel
  (ops/fd.py, "kernel") — the reference's A/B seam;
- on the CPU: the same resolution, with every wrapper taking its plain
  version (so ``use_pallas="auto"`` runs the plain round).

ops/counters.py counts what served each phase, and every refusal.

``sim_step`` consumes its input state, as the reference's donated
buffers do: the matrices are updated in place where a phase can.
"""

from __future__ import annotations

import torch

from ..sim.config import SimConfig, unported_reason
from ..sim.state import DTYPES, SimState
from . import counters, pairs_pull, prng
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
    salt, n_rows: int, owner_ids: torch.Tensor, run_salt=None
) -> torch.Tensor:
    """Deterministic (row, global owner, salt) -> [0, 1) dither: the top
    24 hash bits through int32 to float32, clipped to
    [1e-12, 1 - 2^-24] — the reference's ``_hash_uniform(bits=24)``."""
    dev = owner_ids.device
    s = int(salt) & M32
    if run_salt is not None:
        s ^= int(run_salt) & M32
    i = torch.arange(n_rows, dtype=torch.int64, device=dev)[:, None]
    j = owner_ids.to(torch.int64)[None, :]
    h = hash_mix_u32(i, j, s)
    u = (h >> 8).to(torch.int32).to(torch.float32) * (1.0 / 16777216.0)
    return torch.clamp(u, min=1e-12, max=1.0 - 2.0**-24)


def budgeted_advance(
    w_recv, w_send, budget: int, valid, salt, owner_ids, run_salt=None
) -> torch.Tensor:
    """How far each receiver row advances toward its sender row under the
    per-exchange key-version budget: the reference's
    ``_budgeted_advance`` with the proportional policy. Deficits are
    scaled by min(1, budget/total) and rounded with the hashed dither.
    Row totals are summed exactly in int64 and rounded to float32 once:
    the reference's float32 sum equals that while a row total stays
    below 2^24."""
    dt = w_recv.dtype
    d = torch.clamp(w_send - w_recv, min=0) * valid[:, None].to(dt)
    total = d.sum(dim=1, dtype=torch.int64).to(torch.float32)
    # A tensor numerator: PyTorch computes ``scalar / tensor`` as a
    # reciprocal times the scalar, which is not the correctly rounded
    # quotient.
    quot = torch.full_like(total, float(budget)) / torch.clamp(total, min=1.0)
    scale = torch.clamp(quot, max=1.0)
    x = d.to(torch.float32) * scale[:, None]
    floor = torch.floor(x)
    bump = hash_uniform(salt, d.shape[0], owner_ids, run_salt) < (x - floor)
    adv = torch.minimum(
        floor.to(torch.int32) + bump.to(torch.int32), d.to(torch.int32)
    )
    return adv.to(dt)


# -- dispatch -------------------------------------------------------------------


def kernels_wanted(cfg: SimConfig, device) -> bool:
    """``use_pallas`` resolved for a device: True asks for the kernels,
    "auto" means "the state is on a CUDA device"."""
    return cfg.use_pallas is True or (
        cfg.use_pallas == "auto" and torch.device(device).type == "cuda"
    )


def pull_phase_engaged(cfg: SimConfig, device) -> str:
    """Which implementation serves the sub-exchanges: "pairs" (the
    pair-fused pull, one launch per sub-exchange) or "plain". A config
    that asks for the kernels and that the pull kernel cannot take raises
    ``NotImplementedError``."""
    if not kernels_wanted(cfg, device):
        return "plain"
    if cfg.pallas_variant == "m8":
        counters.refuse(
            "pallas_variant='m8' (the single-pass pull kernel) is not "
            "ported to the GPU: ROADMAP.md B3"
        )
    if cfg.fanout < 1:
        counters.refuse(
            "fanout=0 on the kernel path (no sub-exchange carries the "
            "diagonal refresh and the FD epilogue) is not ported yet: "
            "ROADMAP.md B1e"
        )
    if not pairs_pull.pairs_supported(
        cfg.n_nodes, DTYPES[cfg.version_dtype].itemsize
    ):
        counters.refuse(
            f"n_nodes={cfg.n_nodes} with {cfg.version_dtype} watermarks "
            "(two rows beyond one block's shared memory) is not ported "
            "yet: ROADMAP.md B1d"
        )
    return "pairs"


def fd_phase_engaged(cfg: SimConfig, device) -> str:
    """Which implementation serves the FD phase: "fused" (the epilogue of
    the round's last pairs sub-exchange), "kernel" (the standalone
    pass), "plain", or "off" (no failure detector)."""
    if not cfg.track_failure_detector:
        return "off"
    if cfg.use_pallas_fd is False:
        return "plain"
    if pull_phase_engaged(cfg, device) == "pairs":
        return "fused"
    if cfg.use_pallas_fd is True or kernels_wanted(cfg, device):
        return "kernel"
    return "plain"


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
    reason = unported_reason(cfg)
    if reason is not None:
        counters.refuse(reason)
    n = cfg.n_nodes
    dev = state.w.device
    if tick is None:
        tick = int(state.tick)
    new_tick = tick + 1
    if run_salt is None:
        run_salt = prng.run_salt(key)
    if draws is None:
        draws = [t[0] for t in prng.round_draws(key.to(dev), new_tick, 1, n, cfg.fanout)]
    gm_all, c_all, p_all = draws

    alive = state.alive
    alive_i32 = alive.to(torch.int32)
    heartbeat = state.heartbeat + alive_i32
    max_version = state.max_version + cfg.writes_per_round * alive_i32
    track_hb = cfg.track_heartbeats
    pull = pull_phase_engaged(cfg, dev)
    fd_phase = fd_phase_engaged(cfg, dev)
    params = FdParams.from_config(cfg)

    def salt_of(c: int) -> int:
        return new_tick * (2 * cfg.fanout) + 2 * c

    flag = None
    w, hb = state.w, state.hb_known
    if pull == "pairs":
        # The FD phase reads the round-start hb after the sub-exchanges
        # unless it fuses into a fanout-1 round's only call: keep a copy
        # (its owner diagonal is refreshed where it is read).
        hb_round_start = None
        if cfg.track_failure_detector and not (
            fd_phase == "fused" and cfg.fanout == 1
        ):
            hb_round_start = hb.clone()
        for c in range(cfg.fanout):
            first, last = c == 0, c == cfg.fanout - 1
            valid = alive & alive[p_all[c]]
            kw = {}
            if first:
                kw["mv"] = max_version
                if track_hb:
                    kw["hbv"] = heartbeat
            if last and return_converged:
                kw["check"] = (max_version, alive, alive)
            if last and fd_phase == "fused":
                kw["hbv"] = heartbeat
                kw["fd"] = pairs_pull.FdOperands(
                    new_tick, state.last_change, state.imean, state.icount,
                    state.live_view, hb_round_start, params,
                )
            out = pairs_pull.pairs_pull(
                w, hb if track_hb else None, gm_all[c], c_all[c], valid,
                salt_of(c), run_salt, cfg.budget, **kw,
            )
            if out is not None:
                flag = out
    else:
        diag = torch.eye(n, dtype=torch.bool, device=dev)
        w = torch.where(diag, max_version.to(w.dtype)[None, :], w)
        if track_hb:
            hb = torch.where(diag, heartbeat.to(hb.dtype)[None, :], hb)
        hb_round_start = hb
        owners = torch.arange(n, device=dev)
        for c in range(cfg.fanout):
            p = p_all[c]
            valid = alive & alive[p]
            w = w + budgeted_advance(
                w, w[p], cfg.budget, valid, salt_of(c), owners, run_salt
            )
            if track_hb:
                hb = torch.maximum(hb, torch.where(valid[:, None], hb[p], 0))
            counters.plain_calls["pull"] += 1

    if fd_phase == "kernel":
        fd_mod.fused_fd(
            new_tick, hb, hb_round_start, heartbeat, state.last_change,
            state.imean, state.icount, state.live_view, params,
        )
    elif fd_phase == "plain":
        # The reference's XLA block (no lifecycle); hb0's diagonal is
        # refreshed again, idempotently.
        fd_mod.fused_fd_plain(
            new_tick, hb, hb_round_start, heartbeat, state.last_change,
            state.imean, state.icount, state.live_view, params,
        )
        counters.plain_calls["fd"] += 1

    new_state = state.replace(
        tick=state.tick + 1,
        max_version=max_version,
        heartbeat=heartbeat,
        w=w,
        hb_known=hb,
    )
    if not return_converged:
        return new_state
    if flag is not None:
        return new_state, flag[0] > 0
    return new_state, all_converged_flag(new_state)


# -- convergence ------------------------------------------------------------------


def all_converged_flag(state: SimState) -> torch.Tensor:
    """Bool scalar: every alive node's watermark has reached every alive
    owner's max_version (dead observers and dead owners excused)."""
    needed = state.max_version[None, :]
    ok = (
        (state.w.to(torch.int32) >= needed)
        | ~state.alive[:, None]
        | ~state.alive[None, :]
    )
    return ok.all()


def convergence_metrics(state: SimState) -> dict[str, torch.Tensor]:
    """How replicated the cluster is right now (the reference's
    ``convergence_metrics``): converged owners, the all-converged flag,
    the worst and mean watermark fraction over alive pairs, the alive
    count, the key-versions known, and the FD's false positives."""
    wv = state.w.to(torch.int32)
    needed = state.max_version[None, :]
    alive = state.alive
    alive_rows = alive[:, None]
    caught_up = (wv >= needed) | ~alive_rows
    owner_ok = caught_up.all(dim=0) | ~alive
    pair_mask = alive_rows & alive[None, :]
    frac = torch.where(pair_mask, wv / torch.clamp(needed, min=1), 1.0)
    frac_sum = torch.where(pair_mask, torch.clamp(frac, max=1.0), 0.0).sum()
    pair_count = pair_mask.sum()
    n_converged = owner_ok.sum()
    kv_known = torch.where(
        pair_mask, torch.minimum(wv, needed).to(torch.float32), 0.0
    ).sum()
    total = alive.shape[0]
    out = {
        "converged_owners": n_converged,
        "all_converged": n_converged == total,
        "min_fraction": torch.clamp(frac.min(), max=1.0),
        "mean_fraction": frac_sum / torch.clamp(pair_count, min=1),
        "alive_count": alive.sum(),
        "kv_known": kv_known,
    }
    if state.live_view.numel():
        rows = torch.arange(total, device=wv.device)
        off_diag = rows[:, None] != rows[None, :]
        fp = (pair_mask & off_diag & ~state.live_view).sum()
        denom = (pair_mask & off_diag).sum()
        out["fd_false_positives"] = fp
        out["fd_false_positive_fraction"] = fp / torch.clamp(denom, min=1)
    return out
