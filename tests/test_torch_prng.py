"""The port's threefry draws equal jax.random bit for bit (partitionable
mode, 64-bit ints off): key layout, fold_in, split, bits, randint,
permutation, and the grouped matchings and key schedule built on them."""

import numpy as np
import pytest

import jax.numpy as jnp
from jax import random

from aiocluster_tpu.ops.gossip import _grouped_matching, _random_matching
from aiocluster_torch.ops import prng
from aiocluster_torch.sim.config import SimConfig
import torch

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)


def _kd(key) -> np.ndarray:
    return np.asarray(random.key_data(key)).astype(np.int64)


@pytest.mark.parametrize("seed", [0, 5, -1, -7, 2**31 - 1, 2**32 - 1, 2**32, 2**33 + 7])
def test_key_layout(seed):
    assert prng.key(seed).tolist() == _kd(random.key(seed)).tolist()


@pytest.mark.parametrize("seed", [0, 3, 2**32 - 5])
def test_fold_in_split_bits(seed):
    k, t = random.key(seed), prng.key(seed)
    for data in (0, 1, 24, 2**31 - 1, 2**32 - 1):
        assert prng.fold_in(t, data).tolist() == _kd(random.fold_in(k, data)).tolist()
    for num in (2, 3, 7):
        assert prng.split(t, num).tolist() == _kd(random.split(k, num)).tolist()
    assert int(prng.bits(t)) == int(random.bits(k, dtype=jnp.uint32))
    got = prng.bits(t, (4, 9)).numpy()
    want = np.asarray(random.bits(k, (4, 9), jnp.uint32)).astype(np.int64)
    assert np.array_equal(got, want)


@pytest.mark.parametrize(
    "lo, hi",
    [(0, 8), (0, 10_240), (-5, 1000), (3, 3), (7, 2), (0, 2**31 - 1), (-(2**31), 2**31 - 1)],
)
def test_randint(lo, hi):
    for seed in (1, 2):
        got = prng.randint(prng.key(seed), (64,), lo, hi).numpy()
        want = np.asarray(random.randint(random.key(seed), (64,), lo, hi))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("n", [1, 2, 5, 128, 1024, 1280, 10_240])
def test_permutation(n):
    for seed in (0, 9):
        got = prng.permutation(prng.key(seed), n).numpy()
        assert np.array_equal(got, np.asarray(random.permutation(random.key(seed), n)))


def test_permutation_multi_round_sort_ties():
    # Above ~1.6k elements JAX's shuffle takes two rounds of 32-bit sort
    # keys; at 2**18 elements ~8 colliding keys are expected per round, so
    # this pins the stable-sort tie order too.
    n = 2**18
    got = prng.permutation(prng.key(4), n).numpy()
    assert np.array_equal(got, np.asarray(random.permutation(random.key(4), n)))


@pytest.mark.parametrize("n", [128, 1024, 10_240])
@pytest.mark.parametrize("seed", [0, 77])
def test_grouped_matching(n, seed):
    gm, c, p = _grouped_matching(random.key(seed), n)
    tgm, tc, tp = prng.grouped_matching(prng.key(seed), n)
    assert np.array_equal(tgm.numpy(), np.asarray(gm))
    assert np.array_equal(tc.numpy(), np.asarray(c))
    assert np.array_equal(tp.numpy(), np.asarray(p))
    assert np.array_equal(tp.numpy()[tp.numpy()], np.arange(n))  # involution


@pytest.mark.parametrize("n", [7, 16, 160])
def test_random_matching(n):
    got = prng.random_matching(prng.key(2), n).numpy()
    assert np.array_equal(got, np.asarray(_random_matching(random.key(2), n)))


def test_round_key_schedule():
    """chunk_draws follows sim_step's schedule: fold_in(key, tick), split
    into (churn, peer), fold_in(peer, c), then _grouped_matching — over a
    batch of ticks and sub-exchanges in one pass."""
    n, fanout, seed = 256, 3, 11
    ticks = [9, 10, 11, 12]
    draws = prng.chunk_draws(prng.key(seed), 9, 4, SimConfig(n_nodes=n, fanout=fanout))
    gm, c, p = draws.gm, draws.c, draws.p
    key = random.key(seed)
    for r, tick in enumerate(ticks):
        _, peer_key = random.split(random.fold_in(key, jnp.asarray(tick, jnp.int32)))
        for s in range(fanout):
            rgm, rc, rp = _grouped_matching(random.fold_in(peer_key, s), n)
            assert np.array_equal(gm[r, s].numpy(), np.asarray(rgm))
            assert np.array_equal(c[r, s].numpy(), np.asarray(rc))
            assert np.array_equal(p[r, s].numpy(), np.asarray(rp))
    assert prng.run_salt(prng.key(seed)) == int(random.bits(key, dtype=jnp.uint32))
