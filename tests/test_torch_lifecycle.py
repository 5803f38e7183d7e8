"""The greedy budget policy (ROADMAP.md A8) and the dead-node lifecycle
(A9) in the port equal the reference bit for bit: the greedy advance
with its int32 cumsum (wrapping as the reference's does) and its
owner-order offsets across column blocks, the scheduled-for-deletion
mask, and every state field of greedy and lifecycle rounds against the
reference's XLA ``sim_step`` on JAX CPU, tolerance 0 — unsharded, over a
4-block mesh and as 3 sweep lanes; each plain route counts the
reference's reason, and the lifecycle's FD runs plain."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from aiocluster_tpu.ops.gossip import _budgeted_advance
from aiocluster_tpu.ops.gossip import scheduled_for_deletion_mask as ref_sched
from aiocluster_tpu.ops.gossip import sim_step as ref_step
from aiocluster_tpu.sim.state import init_state as ref_init
from aiocluster_torch import SimConfig
from aiocluster_torch.ops import counters, gossip
from aiocluster_torch.sim.carry import state_from_numpy
from test_torch_churn import (
    BASE,
    CHURN,
    ref_config,
    run_against_reference,
    run_mesh_against_reference,
    sweep_against_reference,
)
from test_torch_sim import NARROW

# Tiny tensors: one thread each, leaving the cores to the suite's
# wall-clock tests running in other workers.
torch.set_num_threads(1)

GREEDY = dict(BASE, budget_policy="greedy", **NARROW)
# Deaths faster than the FD's detection, a short grace: stamps, the
# digest exclusion and forgetting all happen within a dozen rounds.
LIFECYCLE = dict(BASE, death_rate=0.1, revival_rate=0.1, dead_grace_ticks=4)


def test_greedy_advance_wraps_like_reference():
    """Deficits near 2^30 overflow the row cumsum: the port's advance
    wraps it as the reference's int32 cumsum does, and split into 4
    column blocks (each offset by the earlier blocks' row sums) it is the
    whole width's advance."""
    rng = np.random.default_rng(0)
    n = 64
    w_recv = rng.integers(0, 2**20, (n, n)).astype(np.int32)
    w_send = rng.integers(0, 2**30, (n, n)).astype(np.int32)
    valid = rng.random(n) < 0.9
    for budget in (64, 2**31 - 1):
        want = np.asarray(_budgeted_advance(
            jnp.asarray(w_recv), jnp.asarray(w_send), budget, jnp.asarray(valid), None,
            "greedy", jnp.asarray(0, jnp.int32), jnp.arange(n, dtype=jnp.int32),
        ))
        d = gossip.deficits(torch.from_numpy(w_recv), torch.from_numpy(w_send),
                            torch.from_numpy(valid))
        whole = gossip.greedy_advance(d, torch.zeros(n, dtype=torch.int64), budget)
        assert np.array_equal(want, whole.numpy()), budget
        offset = torch.zeros(n, dtype=torch.int64)
        parts = []
        for k in range(4):
            blk = d[:, 16 * k : 16 * (k + 1)]
            parts.append(gossip.greedy_advance(blk, offset, budget))
            offset = offset + blk.sum(dim=1, dtype=torch.int64)
        assert torch.equal(torch.cat(parts, dim=1), whole)
    assert (want > 0).any() and (want < d.numpy()).any()


@pytest.mark.parametrize(
    "case", ["plain", "kernels_wanted", "int32_choice", "permutation_churn"]
)
def test_greedy_rounds_equal_reference(case):
    """Five greedy rounds equal the reference's; a config that asks for
    the kernels runs the plain pull ("budget_policy") with the
    standalone FD kernel's plain version."""
    kw, over = GREEDY, {}
    if case == "kernels_wanted":
        over = dict(use_pallas=True)
    elif case == "int32_choice":
        kw = dict(BASE, budget_policy="greedy", pairing="choice", budget=8)
    elif case == "permutation_churn":
        kw = dict(GREEDY, pairing="permutation", **CHURN)
    counters.reset()
    run_against_reference(kw, rounds=5, over=over)
    if case == "kernels_wanted":
        assert counters.fallbacks == {"budget_policy": 5}
        assert counters.plain_calls == {"pull": 15, "fd": 5}


def test_greedy_mesh_and_sweep_equal_reference():
    """Greedy over 4 column blocks (global owner order through the
    blocks' offsets) and as 3 sweep lanes equals the reference."""
    run_mesh_against_reference(GREEDY, over=dict(use_pallas=True))
    run_mesh_against_reference(dict(GREEDY, pairing="choice", budget=8))
    sweep_against_reference(GREEDY, writes_per_round=[0, 1, 2])


def test_scheduled_for_deletion_mask_equals_reference():
    """The digest-exclusion mask of a stamped state at several ticks."""
    cfg = SimConfig(**LIFECYCLE)
    state = ref_init(ref_config(LIFECYCLE))
    ds = np.random.default_rng(1).integers(0, 9, (256, 256)).astype(np.int32)
    state = state.replace(dead_since=jnp.asarray(ds), tick=jnp.asarray(9, jnp.int32))
    arrays = {f: np.asarray(getattr(state, f)) for f in state.__dataclass_fields__}
    port = state_from_numpy(arrays, cfg, "cpu")
    for tick in (9, 10, 12):
        want = np.asarray(ref_sched(state, ref_config(LIFECYCLE), jnp.asarray(tick)))
        got = gossip.scheduled_for_deletion_mask(port, cfg, tick)
        assert np.array_equal(want, got.numpy()), tick
        assert want.any() and not want.all()
    assert gossip.scheduled_for_deletion_mask(port, SimConfig(**BASE), 9) is None


LIFECYCLE_CASES = {
    "view": (dict(LIFECYCLE, pairing="choice", peer_mode="view"), {}),
    "matching": (dict(LIFECYCLE, **NARROW), dict(use_pallas=True)),
    "categorical_greedy": (dict(LIFECYCLE, pairing="choice", budget_policy="greedy"), {}),
    "shrunk": (dict(LIFECYCLE, icount_dtype="int8", live_bits=True, window_ticks=100,
                    **NARROW), {}),
}


@pytest.mark.parametrize("case", list(LIFECYCLE_CASES))
def test_lifecycle_rounds_equal_reference(case):
    """Twelve rounds of churn under the lifecycle equal the reference's
    field for field (dead_since included) while nodes are stamped,
    excluded from digests and forgotten; a kernel-wanting config runs
    the plain pull ("lifecycle") and the plain FD."""
    kw, over = LIFECYCLE_CASES[case]
    counters.reset()
    rs = run_against_reference(kw, rounds=12, over=over)
    assert np.asarray(rs.dead_since).any()
    if over:
        assert counters.fallbacks == {"lifecycle": 12}
        assert counters.plain_calls["fd"] == 12 and not counters.launches


def test_lifecycle_stamps_excludes_and_forgets():
    """Along the reference's trajectory the lifecycle does all three of
    its things in 12 rounds: some pair is stamped dead, some stamp
    reaches half the grace (the sender drops the owner from its
    digests), and some pair is forgotten (its stamp reaches the full
    grace and is cleared)."""
    kw = LIFECYCLE_CASES["view"][0]
    rcfg = ref_config(kw)
    rs, key = ref_init(rcfg), random.key(3)
    stamped = excluded = forgotten = False
    for _ in range(12):
        before = np.asarray(rs.dead_since).astype(np.int32)
        rs = ref_step(rs, key, rcfg)
        tick = int(rs.tick)
        after = np.asarray(rs.dead_since)
        stamped |= bool((after > 0).any())
        excluded |= bool(((before > 0) & (tick - before >= 2)).any())
        forgotten |= bool(((before > 0) & (tick - before >= 4) & (after == 0)).any())
    assert stamped and excluded and forgotten


def test_lifecycle_mesh_and_sweep_equal_reference():
    """The lifecycle over 4 column blocks and as 3 sweep lanes equals the
    reference (the view draw across the blocks, each block's stamps)."""
    kw = LIFECYCLE_CASES["view"][0]
    run_mesh_against_reference(kw, rounds=8)
    sweep_against_reference(kw, rounds=8, phi_threshold=[6.0, 8.0, 10.0])
