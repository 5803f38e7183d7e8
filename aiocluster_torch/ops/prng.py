"""Threefry-2x32 counter-based random draws, bit-equal to ``jax.random``.

The reference draws every random choice of a round (the grouped
matchings of the sub-exchanges) from ``jax.random`` with
``jax_threefry_partitionable`` on. A port that draws the same bits
follows the same trajectory, so this module re-implements the pieces
the gossip round uses — ``key``, ``fold_in``, ``split``, ``bits``,
``randint`` and ``permutation`` — with PyTorch integer ops, plus the
matchings built on them and the round's key schedule.

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


def bits(keys: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    """``jax.random.bits(key, shape, uint32)`` (partitionable form): the
    two output words of each counter, xor-ed; (..., 2) -> (..., *shape)."""
    size = math.prod(shape)
    counts = torch.arange(size, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(
        keys[..., 0, None], keys[..., 1, None], counts >> 32, counts & M32
    )
    return (y1 ^ y2).reshape((*keys.shape[:-1], *shape))


def _wrap_i32(x: torch.Tensor) -> torch.Tensor:
    return ((x + 2**31) & M32) - 2**31


def randint(
    keys: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int
) -> torch.Tensor:
    """``jax.random.randint`` into int32 for int bounds: two words of
    bits per value, combined modulo the span with the ``2**32 % span``
    multiplier. Returns int64 values in [minval, maxval)."""
    ks = split(keys)
    higher = bits(ks[..., 0, :], shape)
    lower = bits(ks[..., 1, :], shape)
    lo = max(min(int(minval), 2**31 - 1), -(2**31))
    hi = max(min(int(maxval), 2**31 - 1), -(2**31))
    span = 1 if hi <= lo else (hi - lo) & M32
    mult = ((2**16 % span) ** 2 & M32) % span  # the square wraps in uint32
    offset = ((((higher % span) * mult) & M32) + lower % span) & M32
    return _wrap_i32(lo + offset % span)


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
    return _wrap_i32((salt & M32) ^ (run_salts & M32)).to(torch.int32)


def round_draws(
    run_key: torch.Tensor, first_tick: int, rounds: int, n: int, fanout: int
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The matchings of rounds ``first_tick .. first_tick + rounds - 1``
    (each the POST-increment tick a round runs at), following the
    reference's key schedule: ``round_key = fold_in(key, tick)``;
    ``churn_key, peer_key = split(round_key)``; sub-exchange ``c`` draws
    ``_grouped_matching(fold_in(peer_key, c), n)``. Returns int32
    ``(gm, c, p)`` of shape (rounds, fanout, ...) on the device of
    ``run_key``, with no host sync on the way. ``run_key`` may be a
    batch of keys (S, 2), a sweep's lanes: every lane's draws come out
    of the same one pass, laid out (rounds, fanout, S, ...) so that one
    sub-exchange of all lanes is one contiguous block."""
    dev = run_key.device
    lead = run_key.shape[:-1]
    ticks = torch.arange(first_tick, first_tick + rounds, dtype=torch.int64, device=dev)
    ticks = ticks.reshape(rounds, *(1 for _ in lead))
    round_keys = fold_in(run_key.expand(rounds, *lead, 2), ticks)
    peer_keys = split(round_keys)[..., 1, :]
    sub_keys = fold_in(
        peer_keys[:, None],
        torch.arange(fanout, dtype=torch.int64, device=dev).reshape(
            1, fanout, *(1 for _ in lead)
        ),
    )
    return tuple(t.to(torch.int32) for t in grouped_matching(sub_keys, n))
