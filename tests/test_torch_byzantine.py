"""Byzantine fault kinds (ROADMAP.md A10) in the port equal the
reference bit for bit: the guard blocks of ``aiocluster_torch.faults.sim``
(held in factored form, expanded a block of rows at a time) against the
reference's dense masks, the lanes' attacker fraction against the
reference's float32 override, and every state field of rounds under each
kind and the storm against the reference's ``sim_step`` on JAX CPU,
tolerance 0: the matching, permutation and choice pairings, on 4 column
blocks and as 3 ``byz_frac`` sweep lanes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aiocluster_tpu.faults import sim as ref_fsim
from aiocluster_torch import SimConfig, Simulator
from aiocluster_torch.faults import (
    BYZANTINE_KINDS,
    ByzantineFault,
    FaultPlan,
    NodeSet,
    byzantine_fraction,
    byzantine_storm,
)
from aiocluster_torch.faults import sim as fsim
from aiocluster_torch.ops import counters
from test_torch_faults import (
    BASE,
    LEAN,
    ref_plan,
    run_against_reference,
    run_mesh_against_reference,
    sweep_against_reference,
)
from test_torch_sim import NARROW

torch.set_num_threads(1)

MIXED = FaultPlan(seed=9, byzantine=(
    ByzantineFault("stale_replay", nodes=NodeSet(frac=(0.0, 1 / 3)),
                   victims=NodeSet(frac=(0.25, 0.75)), rate=0.6, start=1.0),
    ByzantineFault("owner_violation", nodes=NodeSet(frac=(0.5, 1.0)), rate=0.8, end=4.0),
    ByzantineFault("digest_inflation", nodes=NodeSet(frac=(1 / 3, 2 / 3)),
                   victims=NodeSet(frac=(0.0, 0.5)), rate=0.5),
    ByzantineFault("stale_replay", rate=0.0),  # no effect
))


def _owners(n, col0, width):
    return col0 + np.arange(width)


@pytest.mark.parametrize("n, col0, width", [(256, 0, 256), (10_240, 0, 10_240),
                                            (3 * 4096, 4096, 1024)])
def test_guard_blocks_equal_reference(n, col0, width):
    """``byz_out_block`` / ``byz_hb_block`` / ``byz_in_block`` (and the
    receiver block gathered at a permutation) over a column block's
    global owners equal the reference's masks at several ticks and
    salts, rows expanded block by block."""
    rp = ref_plan(MIXED)
    g = np.random.default_rng(n)
    peer = g.permutation(n)
    owners = _owners(n, col0, width)
    # A sample of rows keeps the dense reference masks small.
    rows = np.sort(g.choice(n, 256, replace=False))
    jpeer, jown = jnp.asarray(peer, jnp.int32), jnp.asarray(owners, jnp.int32)
    tpeer, town = torch.from_numpy(peer), torch.from_numpy(owners)
    for tick, sub in ((0, 0), (1, 7), (3, 2**31 - 3), (5, 12)):
        t = jnp.int32(tick)
        for fn in ("byz_out_block", "byz_hb_block"):
            want = getattr(ref_fsim, fn)(rp, n, t, jpeer, jown, jnp.int32(sub))
            got = getattr(fsim, fn)(MIXED, n, tick, tpeer, town, sub)
            assert (want is None) == (got is None), (fn, tick)
            if want is not None:
                assert np.array_equal(np.asarray(want)[rows], _rows(got, rows)), (fn, tick)
        want = ref_fsim.byz_in_block(rp, n, t, jown)
        got = fsim.byz_in_block(MIXED, n, tick, town)
        assert np.array_equal(np.asarray(want)[rows], _rows(got, rows)), tick
        assert np.array_equal(np.asarray(want)[peer[rows]], _rows(got.gather(tpeer), rows)), tick


def _rows(blk, rows):
    return np.stack([blk.rows(int(r), int(r) + 1)[0].numpy() for r in rows])


@pytest.mark.parametrize("n", [256, 10_240, 3 * 4096])
def test_attacker_fraction_equals_reference_override(n):
    """A lane's attacker fraction as a plan (``with_byz_frac``) gives the
    attackers of the reference's float32 ``byz_frac`` override, at the
    float32 edges of thirds and at 0 and 1."""
    plan = byzantine_storm(0.1)
    rp = ref_plan(plan)
    peer = torch.arange(n)
    owners = torch.arange(n)
    for f in (0.0, 1 / 3, 2 / 3, 0.1, 0.25, 1.0):
        want = ref_fsim.byz_out_block(rp, n, jnp.int32(2), jnp.arange(n, dtype=jnp.int32),
                                      jnp.arange(n, dtype=jnp.int32), jnp.int32(5),
                                      byz_frac=jnp.float32(f))
        got = fsim.byz_out_block(fsim.with_byz_frac(plan, f), n, 2, peer, owners, 5)
        want_rows = np.asarray(want).any(axis=1)
        got_rows = np.array([t.pair.numpy() for t in got.terms]).any(axis=0)
        assert np.array_equal(want_rows, got_rows), f


CASES = {
    **{kind: dict(fault_plan=byzantine_fraction(kind, 0.25, rate=0.7))
       for kind in BYZANTINE_KINDS},
    "storm": dict(fault_plan=byzantine_storm(0.3, victims=NodeSet(frac=(0.2, 0.9)))),
    "mixed": dict(fault_plan=MIXED),
    "permutation_storm": dict(pairing="permutation", fault_plan=byzantine_storm(0.25)),
    "choice_storm": dict(pairing="choice", fault_plan=byzantine_storm(0.3)),
    "choice_mixed": dict(pairing="choice", fault_plan=MIXED),
    "greedy_storm": dict(budget_policy="greedy", fault_plan=byzantine_storm(0.25)),
    "lifecycle_storm": dict(dead_grace_ticks=4, fault_plan=byzantine_storm(0.25)),
}


@pytest.mark.parametrize("case, profile", [
    (case, profile) for case in CASES for profile in ("full", "lean")
    if profile == "full" or "dead_grace_ticks" not in CASES[case]
])
def test_byzantine_rounds_equal_reference(case, profile):
    """Five rounds under each kind, the storm and a mixed plan equal the
    reference's field for field (the FD profile and the lean one), on the
    plain pull ("fault_plan")."""
    kw = dict(BASE, **CASES[case], **(NARROW if profile == "full" else LEAN))
    counters.reset()
    run_against_reference(kw, over=dict(use_pallas=True))
    assert dict(counters.fallbacks) == {"fault_plan": 5}


def test_byzantine_guards_take_effect():
    """Under digest inflation with every node attacking, no row advances on
    any owner but its own; a storm slows convergence against the clean
    run."""
    cfg = SimConfig(**BASE, **LEAN, fault_plan=byzantine_fraction("digest_inflation", 1.0))
    sim = Simulator(cfg, seed=1, device="cpu")
    sim.run(4)
    w = sim.state.w.to(torch.int32)
    assert int((w - torch.diag(torch.diagonal(w))).max()) == 0
    clean = Simulator(SimConfig(**BASE, **LEAN), seed=1, device="cpu")
    storm = Simulator(SimConfig(**BASE, **LEAN, fault_plan=byzantine_storm(0.5)), seed=1,
                      device="cpu")
    clean.run(6)
    storm.run(6)
    assert float(storm.metrics()["mean_fraction"]) < float(clean.metrics()["mean_fraction"])


def test_byzantine_mesh_equals_reference():
    """A mixed byzantine plan over 4 column blocks (each block's guard
    columns from its global owners) equals the reference's unsharded
    rounds."""
    run_mesh_against_reference(dict(BASE, **NARROW, fault_plan=MIXED),
                               over=dict(use_pallas=True))


def test_byz_frac_sweep_equals_reference():
    """Three ``byz_frac`` lanes (0, 0.25, 0.5) of the storm equal the
    reference sweep's lanes, and lane 0 the clean run."""
    kw = dict(BASE, **NARROW, fault_plan=byzantine_storm(0.1))
    counters.reset()
    sweep = sweep_against_reference(kw, over=dict(use_pallas=True), byz_frac=[0.0, 0.25, 0.5])
    assert counters.fallbacks["fault_plan"] == 4
    assert sweep.params["byz_frac"] == [0.0, 0.25, 0.5]
    assert not torch.equal(sweep.states.w[1], sweep.states.w[2])
