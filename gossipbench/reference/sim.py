"""The plain gossip round, state and metrics of the configurations the
benchmark runs: ``n_nodes`` nodes each owning ``keys_per_node`` versions,
``fanout`` sub-exchanges a round over random matchings, the
proportional key-version budget with its hashed dither, heartbeats and
the phi-accrual failure detector where the configuration tracks them,
no churn, no writes, no faults.

Frozen from the port's plain round (``_plain_exchanges`` and
``fd_update`` / ``fd_store``) with the same operations in the same
dtypes, so each round is bit-equal to the program's. Two liberties keep
it fast enough to run on the card at the timed sizes, and neither
changes a bit:

- a sub-exchange runs over whole pairs of the matching a block of rows at
  a time and writes each block in place (a pair's rows read only each
  other);
- the dither is hashed only where it can decide a bump (where the scaled
  deficit has a fractional part), because ``u < 0`` never holds.

``precision="bfloat16"`` computes the budget's share in bfloat16 instead
of float32: the control, which has to come out as not correct.
"""

from __future__ import annotations

import dataclasses

import torch

from . import prng

M32 = prng.M32
K1, K2, K3, K4 = 0x9E3779B1, 0x85EBCA77, 0xC2B2AE3D, 0x27D4EB2F

DTYPES = {
    "bool": torch.bool,
    "int8": torch.int8,
    "int16": torch.int16,
    "int32": torch.int32,
    "bfloat16": torch.bfloat16,
    "float32": torch.float32,
}

# Elements of one block of rows; the metrics sample takes its blocks at
# the program's size, so its float64 sums add in the program's order.
ROW_BLOCK_ELEMS = 1 << 26
STALENESS_PCTS = (("50", 0.50), ("99", 0.99), ("100", 1.0))
HASH_DENSE_SHARE = 0.25

# Simulator fields the reference does not model, each at the one value
# it stands for (peer choice, faults, heterogeneity, kernel switches).
UNMODELLED = {
    "peer_mode": "alive", "fault_plan": None, "quarantine": False,
    "quarantine_open_after": 3, "heterogeneity": None, "use_pallas": "auto",
    "pallas_variant": "auto", "use_pallas_fd": "auto",
}


@dataclasses.dataclass(frozen=True)
class Config:
    """The fields of a configuration the reference reads, with the
    simulator's defaults."""

    n_nodes: int
    keys_per_node: int = 16
    fanout: int = 3
    budget: int = 64
    writes_per_round: int = 0
    track_failure_detector: bool = True
    phi_threshold: float = 8.0
    prior_mean_ticks: float = 5.0
    prior_weight: float = 5.0
    max_interval_ticks: int = 10
    window_ticks: int = 1000
    death_rate: float = 0.0
    revival_rate: float = 0.0
    dead_grace_ticks: int | None = None
    pairing: str = "matching"
    version_dtype: str = "int32"
    heartbeat_dtype: str = "int32"
    fd_dtype: str = "float32"
    icount_dtype: str = "int16"
    live_bits: bool = False
    budget_policy: str = "proportional"
    track_heartbeats: bool = True

    @classmethod
    def from_fields(cls, fields: dict) -> "Config":
        """The configuration of a benchmark file's simulator fields; a
        field the reference does not model must hold its default."""
        known = {f.name for f in dataclasses.fields(cls)}
        for name, value in fields.items():
            if name not in known and UNMODELLED.get(name, value) != value:
                raise NotImplementedError(f"the reference does not model {name}={value!r}")
        cfg = cls(**{k: v for k, v in fields.items() if k in known})
        unsupported = (
            cfg.writes_per_round != 0 or cfg.death_rate != 0 or cfg.revival_rate != 0
            or cfg.dead_grace_ticks is not None or cfg.pairing != "matching"
            or cfg.live_bits or cfg.budget_policy != "proportional"
            or cfg.version_dtype not in ("int8", "int16", "int32")
        )
        if unsupported:
            raise NotImplementedError(f"the reference does not model {cfg}")
        return cfg


@dataclasses.dataclass
class State:
    """One cluster's state; the (N, N) matrices are (0, 0) where the
    configuration does not track them."""

    tick: int
    max_version: torch.Tensor
    heartbeat: torch.Tensor
    w: torch.Tensor
    hb_known: torch.Tensor
    last_change: torch.Tensor
    imean: torch.Tensor
    icount: torch.Tensor
    live_view: torch.Tensor


MATRICES = ("w", "hb_known", "last_change", "imean", "icount", "live_view")


def init_state(cfg: Config, device) -> State:
    """Every node owns ``keys_per_node`` versions, knows only itself and
    has heartbeat 1."""
    n = cfg.n_nodes
    ids = torch.arange(n, device=device)
    kv = torch.full((n,), cfg.keys_per_node, dtype=torch.int32, device=device)
    w = torch.zeros((n, n), dtype=DTYPES[cfg.version_dtype], device=device)
    w[ids, ids] = kv.to(w.dtype)
    hdt = DTYPES[cfg.heartbeat_dtype]
    hb = torch.zeros((n, n) if cfg.track_heartbeats else (0, 0), dtype=hdt, device=device)
    if cfg.track_heartbeats:
        hb[ids, ids] = 1
    fd = (n, n) if cfg.track_failure_detector else (0, 0)
    live = torch.zeros(fd, dtype=torch.bool, device=device)
    if cfg.track_failure_detector:
        live[ids, ids] = True
    return State(
        tick=0, max_version=kv, heartbeat=torch.ones(n, dtype=torch.int32, device=device),
        w=w, hb_known=hb, last_change=torch.zeros(fd, dtype=hdt, device=device),
        imean=torch.zeros(fd, dtype=DTYPES[cfg.fd_dtype], device=device),
        icount=torch.zeros(fd, dtype=DTYPES[cfg.icount_dtype], device=device), live_view=live,
    )


# -- the budgeted pull --------------------------------------------------------


def _bits_i32(words: torch.Tensor) -> torch.Tensor:
    """uint32 words held in int64 as int32 tensors of the same bits."""
    return (((words + 2**31) & M32) - 2**31).to(torch.int32)


def dither(i: torch.Tensor, j: torch.Tensor, s: int) -> torch.Tensor:
    """The [0, 1) dither of (row ``i``, owner ``j``, salt ``s``), on
    broadcasting int64 ids: one multiplicative hash, its top 24 bits
    through int32 to float32, clipped to [1e-12, 1 - 2^-24]. The row and
    owner terms are mixed per id in int64; the broadcast part runs on
    int32 words, whose products wrap modulo 2**32 (shifts are made
    logical by masking)."""
    h = torch.bitwise_xor(
        _bits_i32(prng.mul32(i, K1) ^ ((s & M32) * K3 & M32)), _bits_i32(prng.mul32(j, K2)))
    h ^= (h >> 15) & 0x1FFFF
    h *= K4
    h ^= (h >> 13) & 0x7FFFF
    u = ((h >> 8) & 0xFFFFFF).to(torch.float32).mul_(1.0 / 16777216.0)
    return u.clamp_(min=1e-12, max=1.0 - 2.0**-24)


def dither_words(i: torch.Tensor, j: torch.Tensor, s: int) -> torch.Tensor:
    """``dither`` on int64 words throughout (the port's own arithmetic):
    the tests hold ``dither`` to it."""
    h = prng.mul32(i, K1) ^ prng.mul32(j, K2) ^ ((s & M32) * K3 & M32)
    h = prng.mul32(h ^ (h >> 15), K4)
    h = h ^ (h >> 13)
    u = (h >> 8).to(torch.int32).to(torch.float32) * (1.0 / 16777216.0)
    return torch.clamp(u, min=1e-12, max=1.0 - 2.0**-24)


def budget_scale(total: torch.Tensor, budget: int) -> torch.Tensor:
    quot = torch.full_like(total, float(budget)) / torch.clamp(total, min=1.0)
    return torch.clamp(quot, max=1.0)


def advance(d: torch.Tensor, rows: torch.Tensor, budget: int, s: int,
            precision: str = "float32") -> torch.Tensor:
    """The int32 advances of deficit rows ``d`` (global row ids ``rows``):
    each deficit scaled by min(1, budget / its row's total) and rounded
    down, plus one where the dither of (row, owner, ``s``) lies below the
    fraction, never past the deficit."""
    total = d.sum(dim=1, dtype=torch.int64).to(torch.float32)
    scale = budget_scale(total, budget)
    d32 = d.to(torch.int32)
    if precision == "float32":
        x = d.to(torch.float32) * scale[:, None]
    else:
        x = (d.to(torch.bfloat16) * scale.to(torch.bfloat16)[:, None]).to(torch.float32)
    floor = torch.floor(x)
    frac = x - floor
    adv = floor.to(torch.int32)
    hit = frac > 0
    n_hit = int(hit.sum())
    if n_hit > HASH_DENSE_SHARE * hit.numel():
        cols = torch.arange(d.shape[1], dtype=torch.int64, device=d.device)
        adv += (dither(rows[:, None], cols[None, :], s) < frac).to(torch.int32)
    elif n_hit:
        r, c = hit.nonzero(as_tuple=True)
        bump = dither(rows[r], c.to(torch.int64), s) < frac[r, c]
        adv[r, c] += bump.to(torch.int32)
    return torch.minimum(adv, d32)


def pair_blocks(p: torch.Tensor, n: int):
    """Whole pairs of the involution ``p`` a block of rows at a time: the
    leader rows ``i <= p[i]``, then their partners that are other rows."""
    ids = torch.arange(n, device=p.device)
    leaders = ids[ids <= p]
    per = max(1, ROW_BLOCK_ELEMS // (2 * n))
    for k in range(0, leaders.numel(), per):
        lead = leaders[k:k + per]
        part = p[lead]
        yield torch.cat((lead, part[part != lead]))


def exchange(st: State, cfg: Config, p: torch.Tensor, s: int, precision: str) -> None:
    """One sub-exchange over the matching ``p``, in place: every row
    advances toward its partner's watermarks under the budget and takes
    the larger of its own and its partner's heartbeat knowledge."""
    for rows in pair_blocks(p, cfg.n_nodes):
        w_recv, w_send = st.w[rows], st.w[p[rows]]
        d = torch.clamp(w_send - w_recv, min=0)
        st.w[rows] = w_recv + advance(d, rows, cfg.budget, s, precision).to(st.w.dtype)
        if cfg.track_heartbeats:
            st.hb_known[rows] = torch.maximum(st.hb_known[rows], st.hb_known[p[rows]])


# -- the failure detector ------------------------------------------------------


def fma32(a, b, c) -> torch.Tensor:
    """float32 ``a * b + c`` rounded once."""
    a, b, c = (torch.as_tensor(x, dtype=torch.float32) for x in (a, b, c))
    prod = a.to(torch.float64) * b.to(torch.float64)
    c64 = c.to(torch.float64)
    s = prod + c64
    bb = s - prod
    err = (prod - (s - bb)) + (c64 - bb)
    r = s.to(torch.float32)
    r64 = r.to(torch.float64)
    toward = torch.where(s > r64, float("inf"), float("-inf")).to(torch.float32)
    alt = torch.nextafter(r, toward)
    tie = (s != r64) & ((s - r64) == (alt.to(torch.float64) - s))
    flip = tie & (err != 0) & ((err > 0) == (alt.to(torch.float64) > r64))
    return torch.where(flip, alt, r)


def fd_phase(st: State, cfg: Config, hb0: torch.Tensor, tick: int) -> None:
    """The phi-accrual update of every (observer, owner) pair, in place,
    a block of rows at a time: a heartbeat that rose since the round's
    start samples its interval into the window's running mean; the pair
    is live while the elapsed time stays within phi of the prior-weighted
    mean; the diagonal stays live and a dead pair's window is wiped."""
    n = cfg.n_nodes
    max_interval, window = float(cfg.max_interval_ticks), int(cfg.window_ticks)
    prior_weight = float(cfg.prior_weight)
    prior_wm = float(cfg.prior_weight) * float(cfg.prior_mean_ticks)
    phi = float(cfg.phi_threshold)
    rows_per = max(1, ROW_BLOCK_ELEMS // n)
    cols = torch.arange(n, device=hb0.device)
    for r0 in range(0, n, rows_per):
        r1 = min(r0 + rows_per, n)
        hb = st.hb_known[r0:r1].to(torch.int32)
        h0 = hb0[r0:r1].to(torch.int32)
        lc = st.last_change[r0:r1].to(torch.int32)
        im32 = st.imean[r0:r1].to(torch.float32)
        ic = st.icount[r0:r1].to(torch.int32)
        increased = hb > h0
        never_seen = lc == 0
        interval = (tick - lc).to(torch.float32)
        sampled = increased & ~never_seen & (interval <= max_interval)
        icount = torch.clamp(ic + sampled.to(torch.int32), max=window)
        count = icount.to(torch.float32)
        denom = torch.clamp(count, min=1.0)
        imean = torch.where(sampled, im32 + (interval - im32) / denom, im32)
        lc2 = torch.where(increased, tick, lc)
        elapsed = (tick - lc2).to(torch.float32)
        lhs = elapsed * (count + prior_weight)
        rhs = fma32(imean, count, prior_wm) * phi
        live = (icount >= 1) & (lhs <= rhs)
        live = live | (torch.arange(r0, r1, device=hb.device)[:, None] == cols[None, :])
        st.last_change[r0:r1] = lc2.to(st.last_change.dtype)
        st.imean[r0:r1] = torch.where(live, imean, torch.zeros_like(imean)).to(st.imean.dtype)
        st.icount[r0:r1] = torch.where(live, icount, torch.zeros_like(icount)).to(st.icount.dtype)
        st.live_view[r0:r1] = live


# -- the round -------------------------------------------------------------------


def step(st: State, cfg: Config, run_key: torch.Tensor, salt0: int,
         precision: str = "float32") -> None:
    """One gossip round, in place: the heartbeats tick, every owner's
    diagonal is refreshed, ``fanout`` sub-exchanges run over the round's
    matchings with their dither salts, then the failure detector."""
    n = cfg.n_nodes
    tick = st.tick + 1
    ids = torch.arange(n, device=st.w.device)
    st.heartbeat = st.heartbeat + 1
    st.w[ids, ids] = st.max_version.to(st.w.dtype)
    if cfg.track_heartbeats:
        st.hb_known[ids, ids] = st.heartbeat.to(st.hb_known.dtype)
    hb0 = st.hb_known.clone() if cfg.track_failure_detector else None
    for c, p in enumerate(prng.matchings(run_key, tick, n, cfg.fanout)):
        s = ((tick * (2 * cfg.fanout) + 2 * c) & M32) ^ (salt0 & M32)
        exchange(st, cfg, p, s, precision)
    if cfg.track_failure_detector:
        fd_phase(st, cfg, hb0, tick)
    st.tick = tick


def converged(st: State) -> bool:
    """Every node's watermark has reached every owner's version count."""
    need = st.max_version.to(st.w.dtype)
    n = st.w.shape[0]
    rows_per = max(1, ROW_BLOCK_ELEMS // n)
    return all(bool((st.w[r0:r0 + rows_per] >= need[None, :]).all()) for r0 in range(0, n, rows_per))


class Run:
    """One seeded run of the reference: its key, its dither salt and its
    state, stepped a round at a time."""

    def __init__(self, cfg: Config, seed: int, device, state: State | None = None,
                 precision: str = "float32") -> None:
        self.cfg, self.precision = cfg, precision
        self.key = prng.key(seed, device)
        self.salt0 = prng.run_salt(self.key)
        self.state = init_state(cfg, device) if state is None else state

    def step(self) -> None:
        step(self.state, self.cfg, self.key, self.salt0, self.precision)

    def run_to(self, tick: int, first: int | None = None) -> int | None:
        """Step to ``tick``; returns the first tick at which the state had
        converged (``first`` if it already had), checked after every
        round."""
        while self.state.tick < tick:
            self.step()
            if first is None and converged(self.state):
                first = self.state.tick
        return first


# -- the metrics sample ------------------------------------------------------------


def metrics_sample(st: State) -> dict[str, float]:
    """The convergence metrics (converged owners, the worst and mean
    watermark fraction, the alive count, the key-versions known, the
    FD's false positives), the version spread and the staleness
    percentiles, with the program's reductions over blocks of rows."""
    w = st.w
    dev, n = w.device, w.shape[0]
    need = st.max_version.to(w.dtype)
    need_f = torch.clamp(st.max_version, min=1).to(torch.float32)
    rows_per = max(1, ROW_BLOCK_ELEMS // n)
    cols = torch.arange(n, device=dev)
    track_fd = st.live_view.numel() > 0
    frac_min = torch.ones((), dtype=torch.float32, device=dev)
    frac_sum = torch.zeros((), dtype=torch.float64, device=dev)
    kv_known = torch.zeros((), dtype=torch.int64, device=dev)
    fp = torch.zeros((), dtype=torch.int64, device=dev)
    caught_up = torch.ones(n, dtype=torch.bool, device=dev)
    stale = torch.empty(n, dtype=torch.int32, device=dev)
    for r0 in range(0, n, rows_per):
        r1 = min(r0 + rows_per, n)
        wb = w[r0:r1]
        caught_up &= (wb >= need).all(dim=0)
        frac = wb.to(torch.float32) / need_f
        frac_min = torch.minimum(frac_min, frac.min())
        frac_sum += torch.clamp(frac, max=1.0).sum(dtype=torch.float64)
        kv_known += torch.minimum(wb, need).sum(dtype=torch.int64)
        if track_fd:
            off_diag = torch.arange(r0, r1, device=dev)[:, None] != cols[None, :]
            fp += (off_diag & ~st.live_view[r0:r1]).sum()
        lag = st.max_version.to(torch.int32)[None, :] - wb.to(torch.int32)
        stale[r0:r1] = torch.clamp(lag.max(dim=1).values, min=0)
    n_conv = int(caught_up.sum())
    # Tensor denominators: a CUDA division by a host scalar multiplies by
    # its reciprocal, which is not the program's correctly rounded quotient.
    pairs = torch.tensor(n * n, dtype=torch.int64, device=dev)
    out = {
        "converged_owners": float(n_conv),
        "all_converged": float(n_conv == n),
        "min_fraction": float(torch.clamp(frac_min, max=1.0)),
        "mean_fraction": float((frac_sum / pairs).to(torch.float32)),
        "alive_count": float(n),
        "kv_known": float(kv_known.to(torch.float32)),
    }
    if track_fd:
        out["fd_false_positives"] = float(fp)
        out["fd_false_positive_fraction"] = float(fp / torch.clamp(pairs - n, min=1))
    ordered = torch.sort(stale).values
    out["version_spread"] = float(stale.max())
    for label, q in STALENESS_PCTS:
        out[f"staleness_p{label}"] = float(ordered[min(n - 1, int(q * (n - 1) + 0.5))])
    return out
