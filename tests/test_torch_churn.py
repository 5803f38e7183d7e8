"""Churn (ROADMAP.md A6) in the port equals the reference bit for bit:
the float32 uniform and Bernoulli draws and the round's alive flips
against ``jax.random``, and every state field of churned rounds against
the reference's XLA ``sim_step`` on JAX CPU, round by round with
tolerance 0 — the plain round, the pairs and m8 dispatch (the kernel
wrappers' plain versions on CPU tensors, on the post-churn masks), over
a 4-block mesh, and as 3 sweep lanes (the pairs lane wrappers and the
plain lanes) against the reference's ``SweepSimulator``.

The helpers here (``run_against_reference``, ``run_mesh_against_reference``,
``sweep_against_reference``) also serve tests/test_torch_pairings.py and
tests/test_torch_lifecycle.py."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from aiocluster_tpu.ops.gossip import sim_step as ref_step
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim.state import init_state as ref_init
from aiocluster_tpu.sim.sweep import SweepSimulator as RefSweep
from aiocluster_torch import SimConfig, Simulator, SweepSimulator
from aiocluster_torch.ops import counters, gossip, prng
from aiocluster_torch.parallel import gather_state, init_blocks, make_mesh
from aiocluster_torch.sim.state import init_state, lane
from test_torch_sim import NARROW, _assert_states_equal

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

CHURN = dict(death_rate=0.05, revival_rate=0.2)
BASE = dict(n_nodes=256, keys_per_node=4, fanout=3, budget=24, writes_per_round=1)


def ref_config(kw) -> RefConfig:
    """The reference's config on its XLA path (its own tests pin that
    bit-equal to its kernels)."""
    return RefConfig(**dict(kw, use_pallas=False, use_pallas_fd=False))


def _topology_args(topology):
    if topology is None:
        return {}, {}
    ref = dict(adjacency=jnp.asarray(topology.adjacency), degrees=jnp.asarray(topology.degrees))
    port = dict(adjacency=torch.from_numpy(np.asarray(topology.adjacency)),
                degrees=torch.from_numpy(np.asarray(topology.degrees)))
    return ref, port


def run_against_reference(kw, rounds=4, seed=3, over=None, topology=None):
    """``rounds`` rounds of the reference's XLA ``sim_step`` and of the
    port's ``sim_step`` (``kw`` plus the port-only switches ``over``) from
    the same seed: every state field and the flag equal after each round.
    Returns the last reference state."""
    rcfg, pcfg = ref_config(kw), SimConfig(**kw, **(over or {}))
    rs, ps = ref_init(rcfg), init_state(pcfg, device="cpu")
    key, pkey = random.key(seed), prng.key(seed)
    rtop, ptop = _topology_args(topology)
    for r in range(rounds):
        rs, rflag = ref_step(rs, key, rcfg, return_converged=True, **rtop)
        ps, pflag = gossip.sim_step(ps, pkey, pcfg, return_converged=True, **ptop)
        _assert_states_equal(rs, ps, f"round {r + 1}")
        assert bool(rflag) == bool(pflag), f"round {r + 1}"
    return rs


def run_mesh_against_reference(kw, rounds=4, seed=5, blocks=4, over=None, topology=None):
    """The port's round over ``blocks`` column blocks of
    ``make_mesh(["cpu"] * blocks)`` (``step_blocks``) against the
    reference's unsharded XLA round: the gathered state and the flag
    equal after each round."""
    rcfg, pcfg = ref_config(kw), SimConfig(**kw, **(over or {}))
    mesh = make_mesh(["cpu"] * blocks)
    offsets = mesh.offsets(pcfg)
    parts, rs = init_blocks(pcfg, mesh), ref_init(rcfg)
    key, pkey = random.key(seed), prng.key(seed)
    rtop, ptop = _topology_args(topology)
    for r in range(rounds):
        rs, rflag = ref_step(rs, key, rcfg, return_converged=True, **rtop)
        parts, flag = gossip.step_blocks(parts, pkey, pcfg, offsets=offsets,
                                         return_converged=True, **ptop)
        _assert_states_equal(rs, gather_state(parts), f"round {r + 1}")
        assert bool(flag) == bool(rflag), f"round {r + 1}"


def sweep_against_reference(kw, seeds=(3, 4, 5), rounds=4, over=None, **lanes):
    """A 3-lane ``SweepSimulator`` of the port against the reference's
    on JAX CPU: every field of every lane equal after ``rounds`` rounds
    (two chunks)."""
    ref = RefSweep(ref_config(kw), list(seeds), chunk=2, **lanes)
    ref.run(rounds)
    want = jax.tree_util.tree_map(np.asarray, ref.states)
    sweep = SweepSimulator(SimConfig(**kw, **(over or {})), list(seeds), chunk=2,
                           device="cpu", **lanes)
    sweep.run(rounds)
    for s in range(len(seeds)):
        ref_lane = jax.tree_util.tree_map(lambda a: a[s], want)
        _assert_states_equal(ref_lane, lane(sweep.states, s), f"lane {s}")
    return sweep


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_uniform_and_bernoulli_equal_jax(seed):
    """``prng.uniform`` / ``prng.bernoulli`` are jax.random's float32
    forms: the same floats, the same flips at several rates (p rounded to
    float32), also batched over keys."""
    k, t = random.key(seed), prng.key(seed)
    assert np.array_equal(np.asarray(random.uniform(k, (4096,), jnp.float32)),
                          prng.uniform(t, (4096,)).numpy())
    for p in (0.0, 1e-3, 0.05, 0.2, 0.5, 1.0):
        assert np.array_equal(np.asarray(random.bernoulli(k, p, (4096,))),
                              prng.bernoulli(t, p, (4096,)).numpy()), p
    keys = prng.fold_in(t.expand(3, 2), torch.arange(3))
    got = prng.bernoulli(keys, 0.3, (512,))
    for s in range(3):
        want = random.bernoulli(random.fold_in(k, s), 0.3, (512,))
        assert np.array_equal(np.asarray(want), got[s].numpy())


def test_churn_flips_follow_the_key_schedule():
    """``chunk_draws`` flips each round's alive mask from ``split(
    fold_in(key, tick))[0]`` as the reference's sim_step does, for every
    round of a chunk."""
    cfg = SimConfig(**BASE, **CHURN)
    key, run_key = random.key(11), prng.key(11)
    draws = prng.chunk_draws(run_key, 4, 3, cfg)
    for r, tick in enumerate(range(4, 7)):
        churn_key, _ = random.split(random.fold_in(key, tick))
        dk, rk = random.split(churn_key)
        assert np.array_equal(np.asarray(random.bernoulli(dk, 0.05, (256,))), draws.dies[r].numpy())
        assert np.array_equal(np.asarray(random.bernoulli(rk, 0.2, (256,))), draws.revives[r].numpy())
    assert draws.gm is not None and draws.peers is None


CASES = {
    # The plain round; the pairs and m8 dispatch through the wrappers'
    # plain versions (the pairs path fuses the FD and carries the check).
    "plain": (dict(**BASE, **CHURN, **NARROW), {}),
    "pairs": (dict(**BASE, **CHURN, **NARROW), dict(use_pallas=True)),
    "m8": (dict(**BASE, **CHURN, **NARROW), dict(use_pallas=True, pallas_variant="m8")),
    "lean": (dict(**BASE, **CHURN, version_dtype="int16", track_failure_detector=False,
                  track_heartbeats=False), dict(use_pallas=True)),
    "revival_only": (dict(**BASE, revival_rate=0.3), dict(use_pallas=True)),
}


@pytest.mark.parametrize("case", list(CASES))
def test_churned_rounds_equal_reference(case):
    """Six churned rounds equal the reference's field for field (alive
    included: the flips are written into the new state); on the kernel
    dispatch no fallback is counted, the kernels take the post-churn
    masks."""
    kw, over = CASES[case]
    counters.reset()
    rs = run_against_reference(kw, rounds=6, over=over)
    alive = np.asarray(rs.alive)
    if case != "revival_only":
        assert 0 < alive.sum() < alive.size
    assert not counters.fallbacks and not counters.refusals
    if over:
        assert counters.plain_calls["pull" if case != "m8" else "m8_pull"] == 6 * 3


def test_churned_mesh_equals_reference():
    """Churn over 4 column blocks (the two-pass forms' plain versions on
    lane-aligned blocks of 128, and the plain round) equals the
    reference's unsharded rounds."""
    kw = dict(**BASE, **CHURN, **NARROW)
    run_mesh_against_reference(dict(kw, n_nodes=512), over=dict(use_pallas=True))
    run_mesh_against_reference(kw)


@pytest.mark.parametrize("use_pallas", [True, False], ids=["lanes", "plain"])
def test_churned_sweep_equals_reference(use_pallas):
    """Three churned lanes (with per-lane phi and write rates) equal the
    reference sweep's lanes: each lane flips its own alive mask from its
    own key, on the pairs lane wrappers and on the plain lanes."""
    counters.reset()
    sweep = sweep_against_reference(
        dict(**BASE, **CHURN, **NARROW), over=dict(use_pallas=use_pallas),
        phi_threshold=[7.0, 8.0, 9.0], writes_per_round=[0, 1, 2],
    )
    assert not counters.fallbacks
    if use_pallas:
        assert counters.plain_calls == {"pull": 4 * 3, "draws": 2}  # two chunks
    alive = sweep.states.alive
    assert not torch.equal(alive[0], alive[1])


def test_churned_simulator_converges_like_reference():
    """``Simulator.run`` under churn (chunked draws, the flips carried
    through each chunk) reaches the reference's state after 10 rounds."""
    kw = dict(**BASE, **CHURN, **NARROW)
    from aiocluster_tpu.sim import Simulator as RefSimulator

    ref = RefSimulator(ref_config(kw), seed=4, chunk=4)
    ref.run(10)
    sim = Simulator(SimConfig(**kw, use_pallas=True), seed=4, chunk=3, device="cpu")
    sim.run(10)
    _assert_states_equal(ref.state, sim.state, "tick 10")
