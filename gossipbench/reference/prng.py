"""Threefry-2x32 draws of the gossip round, bit-equal to ``jax.random``
with ``jax_threefry_partitionable`` on: the run key, the per-tick key
schedule, and the matchings of a round's sub-exchanges (the grouped
family on n % 128 == 0, the unrestricted matching off it).

Every 32-bit word is held in int64 and masked after each operation, so
the same bits come out on the CPU and on a GPU.
"""

from __future__ import annotations

import math

import numpy as np
import torch

M32 = 0xFFFFFFFF
_ROT = ((13, 15, 26, 6), (17, 29, 16, 24))


def _t(x, device=None) -> torch.Tensor:
    return torch.as_tensor(x, dtype=torch.int64, device=device)


def mul32(a: torch.Tensor, k: int) -> torch.Tensor:
    """``a * k mod 2**32`` for words ``a`` and a 32-bit constant ``k``,
    split into 16-bit halves of ``k`` so no product leaves int64."""
    lo = a * (k & 0xFFFF)
    hi = ((a * (k >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl(x: torch.Tensor, d: int) -> torch.Tensor:
    return ((x << d) | (x >> (32 - d))) & M32


def threefry2x32(k1, k2, x1, x2) -> tuple[torch.Tensor, torch.Tensor]:
    """The Threefry-2x32 block (20 rounds) on broadcastable words."""
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


def key(seed: int, device=None) -> torch.Tensor:
    """The run key of a seed: the low 32 bits of the seed behind a zero
    word."""
    return torch.tensor([0, int(seed) & M32], dtype=torch.int64, device=device)


def fold_in(keys: torch.Tensor, data) -> torch.Tensor:
    y1, y2 = threefry2x32(keys[..., 0], keys[..., 1], 0, _t(data, keys.device) & M32)
    return torch.stack(torch.broadcast_tensors(y1, y2), dim=-1)


def split(keys: torch.Tensor, num: int = 2) -> torch.Tensor:
    counts = torch.arange(num, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], 0, counts)
    return torch.stack((y1, y2), dim=-1)


def bits(keys: torch.Tensor, shape: tuple[int, ...] = ()) -> torch.Tensor:
    size = math.prod(shape)
    counts = torch.arange(size, dtype=torch.int64, device=keys.device)
    y1, y2 = threefry2x32(keys[..., 0, None], keys[..., 1, None], counts >> 32, counts & M32)
    return (y1 ^ y2).reshape((*keys.shape[:-1], *shape))


def randint(keys: torch.Tensor, shape: tuple[int, ...], minval: int, maxval: int) -> torch.Tensor:
    """``jax.random.randint`` with integer bounds, as int64 values."""
    ks = split(keys)
    higher = bits(ks[..., 0, :], shape)
    lower = bits(ks[..., 1, :], shape)
    lo, hi = int(minval), int(maxval)
    span = 1 if hi <= lo else (hi - lo) & M32
    mult = ((2**16 % span) ** 2 & M32) % span
    offset = ((((higher % span) * mult) & M32) + lower % span) & M32
    return ((lo + offset % span + 2**31) & M32) - 2**31


def permutation(keys: torch.Tensor, n: int) -> torch.Tensor:
    """``jax.random.permutation(key, n)``: rounds of 32-bit sort keys,
    each a stable sort."""
    x = torch.arange(n, dtype=torch.int64, device=keys.device)
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(np.iinfo(np.uint32).max)))
    for _ in range(rounds):
        ks = split(keys)
        keys, sub = ks[..., 0, :], ks[..., 1, :]
        order = torch.sort(bits(sub, (n,)), dim=-1, stable=True).indices
        x = torch.gather(x, -1, order)
    return x


def random_matching(keys: torch.Tensor, n: int) -> torch.Tensor:
    """A uniform perfect matching as an involution: shuffle, then pair
    the first half with the second (odd n leaves one node alone)."""
    perm = permutation(keys, n)
    half = n // 2
    a, b = perm[:half], perm[half:2 * half]
    p = torch.arange(n, dtype=torch.int64, device=perm.device)
    p[a] = b
    p[b] = a
    return p


def grouped_matching(keys: torch.Tensor, n: int) -> torch.Tensor:
    """Groups of 8 rows matched by an involution over n/8 groups, the
    rows of a matched pair of groups paired by a rotation:
    ``p[8g + r] = 8*gm[g] + (r - c[g]) % 8``."""
    n_groups = n // 8
    ks = split(keys)
    gm = random_matching(ks[0], n_groups)
    u = randint(ks[1], (n_groups,), 0, 8)
    gid = torch.arange(n_groups, dtype=torch.int64, device=keys.device)
    c = torch.where(gid < gm, u, torch.where(gid > gm, (8 - u[gm]) % 8, 4 * (u % 2)))
    rows = torch.arange(n, dtype=torch.int64, device=keys.device)
    g, r = rows // 8, rows % 8
    return 8 * gm[g] + (r - c[g]) % 8


def run_salt(run_key: torch.Tensor) -> int:
    """The constant of a run mixed into every dither salt."""
    return int(bits(run_key))


def matchings(run_key: torch.Tensor, tick: int, n: int, fanout: int) -> list[torch.Tensor]:
    """The partners of each sub-exchange of the round that runs at
    ``tick`` (the tick after the increment): ``round_key =
    fold_in(key, tick)``, ``churn_key, peer_key = split(round_key)``,
    sub-exchange c from ``fold_in(peer_key, c)``."""
    peer_key = split(fold_in(run_key, tick))[1]
    out = []
    for c in range(fanout):
        sub = fold_in(peer_key, c)
        out.append(grouped_matching(sub, n) if n % 128 == 0 else random_matching(sub, n))
    return out
