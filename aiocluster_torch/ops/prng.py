"""Threefry-2x32 counter-based random draws, bit-equal to ``jax.random``.

The reference draws every random choice of a round (the matchings or
permutations of the sub-exchanges, the churn flips, the choice peers)
from ``jax.random`` with ``jax_threefry_partitionable`` on. A port that
draws the same bits follows the same trajectory, so this module
re-implements the pieces the gossip round uses — ``key``, ``fold_in``,
``split``, ``bits``, ``randint``, ``uniform``, ``bernoulli``,
``categorical`` and ``permutation`` — with PyTorch integer ops, plus the
matchings built on them and the round's key schedule (``chunk_draws``).

Layout: a key is an int64 tensor whose last axis holds the two 32-bit
words (JAX's ``random.key_data``); leading axes batch independent keys,
so a whole chunk of rounds draws in one pass. Every word is held in
int64 and masked to 32 bits after each operation, because PyTorch's CPU
kernels have no uint32 shift, add or compare. The draws run on the
device of the keys: integer ops give the same bits on the CPU and on a
GPU, so a simulator draws on its state's device.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _t(x) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64)


def mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * k mod 2**32`` for words ``a`` and a 32-bit constant ``k``,
    split into 16-bit halves of ``k`` so no product leaves int64."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) on broadcastable word tensors;
    the same rotation and key-injection schedule as JAX's lowering."""
    k1, k2, x1, x2 = map(_t, (k1, k2, x1, x2))
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    a = (x1 + ks[0]) & M32
    b = (x2 + ks[1]) & M32
    for step in range(5):
        for r in _ROT[step % 2]:
            a = (a + b) & M32
            b = a ^ _rotl(b, r)
        a = (a + ks[(step + 1) % 3]) & M32
        b = (b + ks[(step + 2) % 3] + step + 1) & M32
    return a, b


def key(seed: int) -> torch.Tensor:
    """``jax.random.key_data(jax.random.key(seed))`` with 64-bit ints
    off: the low 32 bits of the seed, behind a zero word."""
    seed = int(seed)
    if not -(2**63) <= seed < 2**64:
        raise OverflowError(f"seed {seed} does not fit 64 bits")
    return torch.tensor([0, seed & M32], dtype=torch.int64)


def keys(seeds) -> torch.Tensor:
    """(S, 2) keys of a sweep's lanes, row s equal to ``key(seeds[s])``
    (the reference's ``vmap(random.key)`` over uint32 seeds, which admits
    seeds in [0, 2**32) only)."""
    seeds = [int(s) for s in seeds]
    if any(not 0 <= s < 2**32 for s in seeds):
        raise ValueError("sweep seeds must be in [0, 2**32)")
    return torch.tensor([[0, s] for s in seeds], dtype=torch.int64).reshape(-1, 2)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    """``jax.random.fold_in`` over a batch: ``data`` broadcasts against
    the keys' leading axes."""
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], 0, _t(data) & M32)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split`` (partitionable form): (..., 2) -> (..., num, 2)."""
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, counts)
    return torch.stack((y1, y2), dim=-1)


def bits(keys: torch.Tensor, shape: tuple[int, ...] = (), start: int = 0) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable form): the
    two output words of each counter, xor-ed; (..., 2) -> (..., *shape).
    ``start`` skips the first counters: the words ``start ..`` of a
    larger draw whose flat index begins there (a block of its rows)."""
    size = math.prod(shape)
    counts = torch.arange(start, start + size, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(
        keys[..., 0, None], keys[..., 1, None], counts >> 32, counts & M32
    )
    return (y1 ^ y2).reshape((*keys.shape[:-1], *shape))


def wrap_i32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) & M32) - 2**31


def randint(keys: torch.Tensor, shape: tuple[int, ...], minval: int, maxval) -> torch.Tensor:
    """``jax.random.randint`` into int32: two words of bits per value,
    combined modulo the span with the ``2**32 % span`` multiplier.
    ``maxval`` is an int or an integer tensor broadcasting against
    ``shape`` (a span per element, as the adjacency draw's degrees).
    Returns int64 values in [minval, maxval)."""
    ks = split(keys)
    higher = bits(ks[..., 0, :], shape)
    lower = bits(ks[..., 1, :], shape)
    lo = max(min(int(minval), 2**31 - 1), -(2**31))
    if torch.is_tensor(maxval):
        hi = torch.clamp(maxval.to(torch.int64), -(2**31), 2**31 - 1)
        span = torch.where(hi <= lo, 1, (hi - lo) & M32)
    else:
        hi = max(min(int(maxval), 2**31 - 1), -(2**31))
        span = 1 if hi <= lo else (hi - lo) & M32
    mult = ((2**16 % span) ** 2 & M32) % span  # the square wraps in uint32
    offset = ((((higher % span) * mult) & M32) + lower % span) & M32
    return wrap_i32(lo + offset % span)


def uniform_mantissas(keys: torch.Tensor, shape: tuple[int, ...], start: int = 0) -> torch.Tensor:
    """The 23-bit mantissas ``m`` of ``jax.random.uniform(key, shape,
    float32)``, whose values are exactly ``m * 2**-23`` in [0, 1)."""
    return bits(keys, shape, start) >> 9


def uniform(keys: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` on [0, 1)."""
    return uniform_mantissas(keys, shape).to(torch.float32) * 2.0**-23


def bernoulli(keys: torch.Tensor, p: float, shape: tuple[int, ...]) -> torch.Tensor:
    """``jax.random.bernoulli(key, p, shape)``: ``uniform < p`` with ``p``
    rounded to float32 (the comparison is exact in float64)."""
    p32 = float(np.float32(p))
    return uniform_mantissas(keys, shape).to(torch.float64) * 2.0**-23 < p32


# Elements of the (rows, fanout, n) uniform draw the categorical takes in
# one block of rows: its int64 transients stay near 300 MB at any width.
CATEGORICAL_BLOCK_ELEMS = 1 << 22


def categorical(key: torch.Tensor, alive: torch.Tensor, fanout: int) -> torch.Tensor:
    """``jax.random.categorical(key, where(alive, 0, -1e30), shape=(n,
    fanout))``: each draw's argmax over the categories of uniform noise
    plus the logits. A dead category scores -1e30 exactly, and
    ``u -> -log(-log(u))`` is strictly increasing on the float32 uniforms
    (multiples of 2**-23, clipped below at the smallest normal), so the
    pick is the alive category with the largest uniform mantissa, ties to
    the lowest index, and category 0 when none is alive: no logarithm is
    taken. ``key`` is one key; the (n, fanout, n) words are drawn a block
    of rows at a time. Returns int64 (n, fanout)."""
    n = alive.shape[0]
    out = torch.empty((n, fanout), dtype=torch.int64, device=alive.device)
    rows = max(1, CATEGORICAL_BLOCK_ELEMS // (fanout * n))
    for r0 in range(0, n, rows):
        r1 = min(r0 + rows, n)
        m = uniform_mantissas(key, (r1 - r0, fanout, n), start=r0 * fanout * n)
        out[r0:r1] = torch.argmax(torch.where(alive, m, -1), dim=-1)
    return out


def inverse_permutation(p: torch.Tensor) -> torch.Tensor:
    """The inverse of permutations ``p`` along the last axis (the
    reference's ``argsort(p)``)."""
    inv = torch.empty_like(p)
    ids = torch.arange(p.shape[-1], dtype=p.dtype, device=p.device)
    return inv.scatter_(-1, p, ids.expand_as(p).contiguous())


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: rounds of fresh 32-bit sort
    keys, each a stable sort (lax.sort_key_val); (..., 2) -> (..., n)."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device)
    x = x.expand(*keys.shape[:-1], n)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        ks = split(keys)
        keys, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def random_matching(keys: torch.Tensor, n: int) -> torch.Tensor:
    """A uniform random perfect matching as an involution ``p``: shuffle,
    then pair the first half with the second (odd ``n`` leaves one node
    self-paired). Mirrors the reference ``_random_matching``."""
    perm = permutation(keys, n)
    half = n // 2
    a, b = perm[..., :half], perm[..., half : 2 * half]
    p = torch.arange(n, dtype=torch.int64, device=perm.device)
    p = p.expand_as(perm).clone()
    p.scatter_(-1, a, b)
    p.scatter_(-1, b, a)
    return p


def grouped_matching(
    keys: torch.Tensor, n: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The reference ``_grouped_matching``: groups of 8 rows matched by
    the involution ``gm`` over n/8 groups, rows within a matched pair
    assigned by the rotation ``c``, so
    ``p[8g + r] = 8*gm[g] + (r - c[g]) % 8``. Partners g < h get
    rotations c and (8 - c) % 8; a self-matched group rotates by 0 or 4.
    Returns int64 (gm, c, p) with the keys' leading axes."""
    n_groups = n // 8
    ks = split(keys)
    gm = random_matching(ks[..., 0, :], n_groups)
    u = randint(ks[..., 1, :], (n_groups,), 0, 8)
    gid = torch.arange(n_groups, dtype=torch.int64, device=keys.device)
    c = torch.where(
        gid < gm,
        u,
        torch.where(gid > gm, (8 - torch.gather(u, -1, gm)) % 8, 4 * (u % 2)),
    )
    return gm, c, rows_of_groups(gm, c)


def rows_of_groups(gm: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """The row involution ``p[8g + r] = 8*gm[g] + (r - c[g]) % 8`` of a
    grouped matching (any leading axes, any integer dtype)."""
    n = gm.shape[-1] * 8
    rows = torch.arange(n, dtype=gm.dtype, device=gm.device)
    g, r = rows // 8, rows % 8
    return 8 * gm[..., g] + (r - c[..., g]) % 8


def run_salt(run_key: torch.Tensor) -> int:
    """The per-run constant mixed into every dither salt:
    ``random.bits(key, dtype=uint32)`` of the run key."""
    return int(bits(run_key))


def run_salts(lane_keys: torch.Tensor) -> torch.Tensor:
    """``run_salt`` of each lane's key: (S, 2) -> (S,) int64 words."""
    return bits(lane_keys)


def salt_mix(salt: torch.Tensor, run_salts: torch.Tensor) -> torch.Tensor:
    """The kernels' dither salt of each lane, ``(salt ^ run_salt) mod
    2**32`` as int32 bits (the lane launches read them as uint32)."""
    return wrap_i32((salt & M32) ^ (run_salts & M32)).to(torch.int32)


def _round_keys(run_key: torch.Tensor, first_tick: int, rounds: int):
    """(churn_keys, peer_keys), (rounds, *lead, 2) each: the reference's
    ``round_key = fold_in(key, tick)``, ``churn_key, peer_key =
    split(round_key)`` for the POST-increment ticks ``first_tick ..``."""
    lead = run_key.shape[:-1]
    ticks = torch.arange(first_tick, first_tick + rounds, dtype=torch.int64,
                         device=run_key.device)
    ticks = ticks.reshape(rounds, *(1 for _ in lead))
    return split(fold_in(run_key.expand(rounds, *lead, 2), ticks)).unbind(-2)


def _sub_keys(peer_keys: torch.Tensor, fanout: int, lead) -> torch.Tensor:
    """``fold_in(peer_key, c)`` of every sub-exchange: (rounds, fanout,
    *lead, 2)."""
    subs = torch.arange(fanout, dtype=torch.int64, device=peer_keys.device)
    return fold_in(peer_keys[:, None], subs.reshape(1, fanout, *(1 for _ in lead)))


def zone_biased(peers: torch.Tensor, peer_keys: torch.Tensor, cfg) -> torch.Tensor:
    """Zone-aware peer bias (``Heterogeneity.zone_bias``; the reference's
    ``_zone_biased``): with probability ``zone_bias`` a choice draw is
    replaced by a uniform pick from the node's own zone (contiguous
    coordinate blocks, ``i * zones // n``), from ``split(fold_in(
    peer_key, 0x5A))``: a ``randint`` below each row's zone size, then a
    ``bernoulli`` of the bias. ``peers`` (..., n, fanout) as is when the
    config carries no bias."""
    het = cfg.heterogeneity
    if het is None or het.zone_bias <= 0.0:
        return peers
    n, fanout = peers.shape[-2:]
    zones = het.zones
    # Zone z holds the rows i with i * zones // n == z: rows
    # ceil(z * n / zones) up to ceil((z + 1) * n / zones).
    z = torch.arange(n, dtype=torch.int64, device=peers.device) * zones // n
    zstart = (z * n + zones - 1) // zones
    zcount = ((z + 1) * n + zones - 1) // zones - zstart
    ks = split(fold_in(peer_keys, 0x5A))
    local = zstart[:, None] + randint(ks[..., 0, :], (n, fanout), 0, zcount[:, None])
    biased = bernoulli(ks[..., 1, :], het.zone_bias, (n, fanout))
    return torch.where(biased, local, peers)


class RoundDraws(NamedTuple):
    """Everything the rounds of one config draw from ``jax.random``, for
    a chunk of rounds (``chunk_draws``) or one round (``round(r)``);
    each field None where the config draws no such thing. With a batch of
    keys (a sweep's lanes, leading axes ``lead``):

    - ``gm``, ``c``: the grouped matchings' group involutions and
      rotations, (rounds, fanout, *lead, n/8);
    - ``p``: each sub-exchange's partner, (rounds, fanout, *lead, n): the
      grouped or unrestricted matching's involution, or the
      permutation; ``inv`` the permutation's inverse (the responder's
      pull);
    - ``dies``, ``revives``: the churn flips, bool (rounds, *lead, n);
    - ``peers``: the choice pairing's peers, int64 (rounds, *lead, n,
      fanout): uniform, categorical over the alive nodes (less crashed
      and quarantined ones), zone-biased, or drawn from an adjacency (the view draw is a hash of the state's live view,
      taken in the round)."""

    gm: torch.Tensor | None = None
    c: torch.Tensor | None = None
    p: torch.Tensor | None = None
    inv: torch.Tensor | None = None
    dies: torch.Tensor | None = None
    revives: torch.Tensor | None = None
    peers: torch.Tensor | None = None

    def round(self, r: int) -> "RoundDraws":
        """Round ``r`` of a chunk's draws."""
        return RoundDraws(*(None if t is None else t[r] for t in self))

    def lane(self, s: int, fanout: int) -> "RoundDraws":
        """Lane ``s`` of one round of a sweep's draws, with the first
        ``fanout`` sub-exchanges (the lane's own fanout)."""
        sub = ("gm", "c", "p", "inv")
        return RoundDraws(**{
            name: None if t is None else (t[:fanout, s] if name in sub else t[s])
            for name, t in zip(self._fields, self)
        })


def churn_flips(churn_keys: torch.Tensor, n: int, death_rate: float, revival_rate: float):
    """The churn of a round (the reference's ``dk, rk =
    split(churn_key)``; ``dies = bernoulli(dk, death_rate, (n,))``,
    ``revives = bernoulli(rk, revival_rate, (n,))``); the new ground
    truth is ``where(alive, ~dies, revives)``."""
    ks = split(churn_keys)
    return (bernoulli(ks[..., 0, :], death_rate, (n,)),
            bernoulli(ks[..., 1, :], revival_rate, (n,)))


def chunk_draws(
    run_key: torch.Tensor, first_tick: int, rounds: int, cfg, *,
    alive: torch.Tensor | None = None, adjacency: torch.Tensor | None = None,
    degrees: torch.Tensor | None = None,
) -> RoundDraws:
    """The draws of rounds ``first_tick .. first_tick + rounds - 1`` of
    config ``cfg`` (each the POST-increment tick a round runs at) on the
    device of ``run_key``, with no host sync: the reference's key
    schedule ``round_key = fold_in(key, tick)``, ``churn_key, peer_key =
    split(round_key)``. The churn flips come from ``churn_key``; a
    matching or permutation sub-exchange ``c`` from ``fold_in(peer_key,
    c)`` (the grouped family on n % 128 == 0, the unrestricted matching
    off it); the choice peers from ``peer_key`` itself: ``randint(0,
    n)`` on a statically churn-free config without a quarantine, else the
    categorical over each round's alive nodes (``alive`` is the ground
    truth before the chunk, carried through the chunk's flips) less the
    fault plan's crashed and quarantined ones at the round's tick, then
    the zone bias (``zone_biased``); or a uniform slot of the
    ``adjacency`` row below its ``degrees``. ``run_key`` may be a batch
    of keys (a sweep's lanes, ``alive`` then batched alike)."""
    dev = run_key.device
    n, fanout = cfg.n_nodes, cfg.fanout
    lead = run_key.shape[:-1]
    churn_keys, peer_keys = _round_keys(run_key, first_tick, rounds)
    out = {}
    churn = cfg.death_rate > 0 or cfg.revival_rate > 0
    if churn:
        out["dies"], out["revives"] = churn_flips(churn_keys, n, cfg.death_rate, cfg.revival_rate)
    if adjacency is not None:
        slot = randint(peer_keys, (n, fanout), 0, degrees.to(dev)[:, None])
        adj = adjacency.to(dev, torch.int64).expand(*slot.shape[:-1], adjacency.shape[-1])
        out["peers"] = torch.gather(adj, -1, slot)
    elif cfg.pairing == "choice" and cfg.peer_mode == "alive":
        from ..ops.gossip import round_faults  # the round's fault model

        faults = round_faults(cfg)
        if not churn and not faults.quarantine:
            peers = randint(peer_keys, (n, fanout), 0, n)
        else:
            # The masked categorical: over each round's alive nodes,
            # less those inside a crash window and those quarantined
            # (both pure functions of the tick), also on a churn-free
            # config when a quarantine applies.
            from ..faults import sim as fsim

            live = alive.to(dev).reshape(-1, n)
            peers = torch.empty((rounds, live.shape[0], n, fanout), dtype=torch.int64, device=dev)
            flat_keys = peer_keys.reshape(rounds, -1, 2)
            for r in range(rounds):
                if churn:
                    live = torch.where(live, ~out["dies"][r].reshape(-1, n),
                                       out["revives"][r].reshape(-1, n))
                tick, sel = first_tick + r, live
                if faults.nodes and fsim.crashes_now(faults.plan, tick):
                    sel = sel & ~fsim.crash_mask(faults.plan, n, tick, dev)
                if faults.quarantine:
                    sel = sel & ~fsim.quarantine_mask(
                        faults.plan, n, tick, dev, open_after=cfg.quarantine_open_after)
                for s in range(live.shape[0]):
                    peers[r, s] = categorical(flat_keys[r, s], sel[s], fanout)
            peers = peers.reshape(rounds, *lead, n, fanout)
        out["peers"] = zone_biased(peers, peer_keys, cfg)
    else:
        sub_keys = _sub_keys(peer_keys, fanout, lead)
        if cfg.pairing == "permutation":
            out["p"] = permutation(sub_keys, n)
            out["inv"] = inverse_permutation(out["p"])
        elif n % 128 == 0:
            out["gm"], out["c"], out["p"] = (t.to(torch.int32) for t in grouped_matching(sub_keys, n))
        else:
            out["p"] = random_matching(sub_keys, n)
    return RoundDraws(**out)
