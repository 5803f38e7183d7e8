"""Fault plans (ROADMAP.md A10) in the port equal the reference bit for
bit: the plan dataclasses and their JSON forms against the reference's,
the config checks with the reference's messages, the mask functions of
``aiocluster_torch.faults.sim`` against ``aiocluster_tpu.faults.sim``
(at float32 window edges), and every state field of faulted rounds
against the reference's XLA ``sim_step`` on JAX CPU, tolerance 0:
partitions, flaky and slow links, warm and amnesiac crash windows and
the quarantine of the choice draw — unsharded, on 4 column blocks, and
as 3 ``fault_seeds`` sweep lanes.

The helpers here (``ref_kw``, ``run_against_reference``,
``run_mesh_against_reference``, ``sweep_against_reference``) also serve
tests/test_torch_byzantine.py and tests/test_torch_heterogeneity.py."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from aiocluster_tpu import faults as ref_faults
from aiocluster_tpu.faults import sim as ref_fsim
from aiocluster_tpu.models.topology import Heterogeneity as RefHet
from aiocluster_tpu.ops.gossip import sim_step as ref_step
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_tpu.sim.state import init_state as ref_init
from aiocluster_tpu.sim.sweep import SweepSimulator as RefSweep
from aiocluster_torch import SimConfig, Simulator, SweepSimulator
from aiocluster_torch import faults
from aiocluster_torch.faults import (
    FaultPlan,
    LinkFault,
    NodeCrash,
    NodeSet,
    Partition,
    flaky_links,
    rolling_restart,
    slow_third,
    split_brain,
)
from aiocluster_torch.faults import sim as fsim
from aiocluster_torch.models import Heterogeneity
from aiocluster_torch.ops import counters, gossip, prng
from aiocluster_torch.parallel import gather_state, init_blocks, make_mesh
from aiocluster_torch.sim.state import init_state, lane
from test_torch_sim import NARROW, _assert_states_equal

torch.set_num_threads(1)

BASE = dict(n_nodes=256, keys_per_node=4, fanout=3, budget=24, writes_per_round=1)
LEAN = dict(track_failure_detector=False, track_heartbeats=False)


def ref_plan(plan):
    """The reference's FaultPlan of a port plan, through the dict form."""
    return None if plan is None else ref_faults.FaultPlan.from_dict(plan.to_dict())


def ref_het(het):
    return None if het is None else RefHet(**dataclasses.asdict(het))


def ref_kw(kw) -> dict:
    """The reference's config fields for the port's ``kw``: its own plan
    and heterogeneity types, on its XLA path (its tests pin that
    bit-equal to its kernels)."""
    return dict(kw, use_pallas=False, use_pallas_fd=False,
                fault_plan=ref_plan(kw.get("fault_plan")),
                heterogeneity=ref_het(kw.get("heterogeneity")))


def run_against_reference(kw, rounds=5, seed=3, over=None):
    """``rounds`` rounds of the reference's ``sim_step`` and the port's
    (``kw`` plus the port-only switches ``over``) from the same seed:
    every state field and the flag equal after each round. Returns the
    last reference state."""
    rcfg, pcfg = RefConfig(**ref_kw(kw)), SimConfig(**kw, **(over or {}))
    rs, ps = ref_init(rcfg), init_state(pcfg, device="cpu")
    key, pkey = random.key(seed), prng.key(seed)
    for r in range(rounds):
        rs, rflag = ref_step(rs, key, rcfg, return_converged=True)
        ps, pflag = gossip.sim_step(ps, pkey, pcfg, return_converged=True)
        _assert_states_equal(rs, ps, f"round {r + 1}")
        assert bool(rflag) == bool(pflag), f"round {r + 1}"
    return rs


def run_mesh_against_reference(kw, rounds=4, seed=5, blocks=4, over=None):
    """The port's round over ``blocks`` column blocks (``step_blocks``)
    against the reference's unsharded round: the gathered state and the
    flag equal after each round."""
    rcfg, pcfg = RefConfig(**ref_kw(kw)), SimConfig(**kw, **(over or {}))
    mesh = make_mesh(["cpu"] * blocks)
    offsets = mesh.offsets(pcfg)
    parts, rs = init_blocks(pcfg, mesh), ref_init(rcfg)
    key, pkey = random.key(seed), prng.key(seed)
    for r in range(rounds):
        rs, rflag = ref_step(rs, key, rcfg, return_converged=True)
        parts, flag = gossip.step_blocks(parts, pkey, pcfg, offsets=offsets,
                                         return_converged=True)
        _assert_states_equal(rs, gather_state(parts), f"round {r + 1}")
        assert bool(flag) == bool(rflag), f"round {r + 1}"


def sweep_against_reference(kw, seeds=(3, 4, 5), rounds=4, over=None, **lanes):
    """A 3-lane ``SweepSimulator`` of the port against the reference's:
    every field of every lane equal after ``rounds`` rounds (two
    chunks)."""
    ref = RefSweep(RefConfig(**ref_kw(kw)), list(seeds), chunk=2, **lanes)
    ref.run(rounds)
    want = jax.tree_util.tree_map(np.asarray, ref.states)
    sweep = SweepSimulator(SimConfig(**kw, **(over or {})), list(seeds), chunk=2,
                           device="cpu", **lanes)
    sweep.run(rounds)
    for s in range(len(seeds)):
        ref_lane = jax.tree_util.tree_map(lambda a: a[s], want)
        _assert_states_equal(ref_lane, lane(sweep.states, s), f"lane {s}")
    return sweep


def simulator_against_reference(kw, rounds=8, seed=4, chunk=3, over=None):
    """``Simulator.run`` (the chunk's draws at once) against the
    reference's ``Simulator`` after ``rounds`` rounds."""
    ref = RefSimulator(RefConfig(**ref_kw(kw)), seed=seed, chunk=4)
    ref.run(rounds)
    sim = Simulator(SimConfig(**kw, **(over or {})), seed=seed, chunk=chunk, device="cpu")
    sim.run(rounds)
    _assert_states_equal(ref.state, sim.state, f"tick {rounds}")
    return sim


# -- the plan model ----------------------------------------------------------------


PLANS = {
    "split_brain": split_brain(3, start=1, heal=4, seed=2),
    "flaky": flaky_links(0.3, delay=2.0, delay_prob=0.1, duplicate=0.2, end=9.5),
    "slow_third": slow_third(1.5, delay_prob=0.6),
    "rolling": rolling_restart(4, recovery="warm"),
    "storm": faults.byzantine_storm(0.3, victims=NodeSet(frac=(0.5, 1.0))),
    "mixed": FaultPlan(
        seed=7, links=(LinkFault(src=NodeSet(frac=(0.0, 0.5)), eof=0.25, start=2.0),),
        partitions=(Partition(n_groups=2, start=1.0, end=3.0),),
        crashes=(NodeCrash(nodes=NodeSet(frac=(0.25, 0.5)), at=2.0, down_for=1.5),),
    ),
}


@pytest.mark.parametrize("name", list(PLANS))
def test_plans_round_trip_between_the_packages(name):
    """A plan's dict and JSON forms are the reference's: the port's plan
    loads in the reference and back, equal to the reference's own
    scenario builder's plan, and both check as sim-compatible."""
    plan = PLANS[name]
    ref = ref_faults.FaultPlan.from_json(plan.to_json())
    assert ref.to_json() == plan.to_json()
    assert FaultPlan.from_dict(json.loads(ref.to_json())) == plan
    assert FaultPlan.from_json(plan.to_json()) == plan
    plan.check_sim_compatible()
    if name in ref_faults.SCENARIOS:
        assert ref_faults.SCENARIOS[name]().to_dict() == faults.SCENARIOS[name]().to_dict()


def test_scenarios_and_helpers_match_reference():
    """Every named scenario at its defaults, ``with_extra_links`` and
    ``round_robin_groups`` give the reference's values."""
    assert sorted(faults.SCENARIOS) == sorted(ref_faults.SCENARIOS)
    for name, build in faults.SCENARIOS.items():
        assert build().to_dict() == ref_faults.SCENARIOS[name]().to_dict(), name
    extra = (LinkFault(drop=0.5),)
    assert faults.with_extra_links(None, ()) is None
    assert faults.with_extra_links(PLANS["mixed"], extra).to_dict() == \
        ref_faults.with_extra_links(ref_plan(PLANS["mixed"]), (ref_faults.LinkFault(drop=0.5),)).to_dict()
    names = [f"n{i}" for i in range(7)]
    assert faults.round_robin_groups(names, 3) == ref_faults.round_robin_groups(names, 3)


@pytest.mark.parametrize(
    "bad",
    [
        dict(links=(LinkFault(drop=1.5),)),
        dict(links=(LinkFault(delay=-1.0),)),
        dict(partitions=(Partition(n_groups=1),)),
        dict(partitions=(Partition(n_groups=2, groups=(("a",),)),)),
        dict(crashes=(NodeCrash(down_for=0.0),)),
        dict(crashes=(NodeCrash(recovery="cold"),)),
        dict(byzantine=(faults.ByzantineFault(kind="lie"),)),
        dict(byzantine=(faults.ByzantineFault(kind="stale_replay", rate=2.0),)),
        dict(byzantine=(faults.ByzantineFault(kind="stale_replay", amount=0),)),
    ],
)
def test_plan_checks_raise_like_reference(bad):
    with pytest.raises(ValueError) as port:
        FaultPlan(**bad)
    ref_bad = {k: tuple(_ref_entry(e) for e in v) for k, v in bad.items()}
    with pytest.raises(ValueError) as ref:
        ref_faults.FaultPlan(**ref_bad)
    assert str(port.value) == str(ref.value)


def _ref_entry(e):
    """The reference's dataclass of a port entry (built unchecked: the
    plan's own check is what raises)."""
    cls = getattr(ref_faults, type(e).__name__)
    d = {f.name: getattr(e, f.name) for f in dataclasses.fields(e)}
    for k, v in d.items():
        if isinstance(v, NodeSet):
            d[k] = ref_faults.NodeSet(names=v.names, frac=v.frac)
    return cls(**d)


@pytest.mark.parametrize(
    "over",
    [
        dict(fault_plan=FaultPlan(links=(LinkFault(src=NodeSet(names=("a",))),))),
        dict(fault_plan=FaultPlan(partitions=(Partition(n_groups=2, groups=(("a",), ("b",))),))),
        dict(fault_plan=faults.byzantine_fraction(), version_dtype="u4r"),
        dict(fault_plan=rolling_restart(2), version_dtype="u4r"),
        dict(fault_plan=rolling_restart(2), live_bits=True),
        dict(quarantine=True, pairing="choice",
             heterogeneity=Heterogeneity(gossip_every=(1, 2), class_frac=(0.5, 0.5))),
        dict(fault_plan="split"),
    ],
    ids=["names", "groups", "byz_u4r", "amnesia_u4r", "amnesia_live_bits",
         "quarantine_cadence", "not_a_plan"],
)
def test_config_refuses_with_reference_messages(over):
    """``SimConfig`` refuses what the reference's refuses, with its
    ``ValueError`` message word for word."""
    kw = dict(n_nodes=256, **over)
    with pytest.raises(ValueError) as port:
        SimConfig(**kw)
    rkw = dict(kw, heterogeneity=ref_het(kw.get("heterogeneity")))
    if isinstance(kw.get("fault_plan"), FaultPlan):
        rkw["fault_plan"] = ref_plan(kw["fault_plan"])
    with pytest.raises(ValueError) as ref:
        RefConfig(**rkw)
    assert str(port.value) == str(ref.value)


# -- the masks ---------------------------------------------------------------------

EDGE_NS = (256, 10_240, 3 * 4096, 3 * 2**15, 1000)


@pytest.mark.parametrize("n", EDGE_NS)
def test_crash_and_amnesia_masks_equal_reference(n):
    """``crash_mask`` and ``amnesia_restart_mask`` at window edges: thirds
    of the index space (i / n against 1/3 in float32) and windows whose
    end ``at + down_for`` rounds in float32."""
    plan = FaultPlan(crashes=(
        NodeCrash(nodes=NodeSet(frac=(0.0, 1 / 3)), at=1.0, down_for=2.0),
        NodeCrash(nodes=NodeSet(frac=(1 / 3, 2 / 3)), at=0.1, down_for=2.2, recovery="warm"),
        NodeCrash(nodes=NodeSet(frac=(2 / 3, 1.0)), at=2.9999999, down_for=1e-7),
        # Bounds that differ once rounded to float32: 3.0000001 -> 3.0
        # (the window opens at tick 3, its end 5.0000001 -> 5.0 restarts
        # at tick 5), and 0.30000001 equals float32(0.3) = float32(3 / 10).
        NodeCrash(nodes=NodeSet(frac=(0.30000001, 0.7)), at=3.0000001, down_for=2.0),
        NodeCrash(at=6.0, down_for=1.0),
    ))
    rp = ref_plan(plan)
    for tick in range(0, 9):
        t = jnp.int32(tick)
        assert np.array_equal(np.asarray(ref_fsim.crash_mask(rp, n, t)),
                              fsim.crash_mask(plan, n, tick, "cpu").numpy()), tick
        assert np.array_equal(np.asarray(ref_fsim.amnesia_restart_mask(rp, n, t)),
                              fsim.amnesia_restart_mask(plan, n, tick, "cpu").numpy()), tick
        # Every window's node set is non-empty at these widths.
        assert fsim.crashes_now(plan, tick) == bool(np.asarray(ref_fsim.crash_mask(rp, n, t)).any())
        assert fsim.restarts_now(plan, tick) == bool(
            np.asarray(ref_fsim.amnesia_restart_mask(rp, n, t)).any())


@pytest.mark.parametrize("n", EDGE_NS)
def test_link_and_quarantine_masks_equal_reference(n):
    """``link_ok`` (partitions, drops, EOFs, delays past a tick, directional
    windows in thirds) and ``quarantine_mask`` on random directed pairs
    at several ticks, salts and seeds."""
    plan = FaultPlan(
        seed=0xDEADBEEF1,
        links=(
            LinkFault(src=NodeSet(frac=(0.0, 1 / 3)), drop=0.3, start=1.0, end=5.0),
            LinkFault(dst=NodeSet(frac=(1 / 3, 2 / 3)), eof=0.1, delay=1.0, delay_prob=0.5),
            LinkFault(dst=NodeSet(frac=(2 / 3, 1.0)), drop=1.0, start=2.0, end=7.0),
            LinkFault(delay=0.5, delay_prob=1.0),  # sub-tick: no effect
            # float32 edges: 0.30000001 -> float32(0.3), 1.0000001 -> 1.0.
            LinkFault(src=NodeSet(frac=(0.30000001, 0.5)), drop=0.5, start=1.0000001),
        ),
        partitions=(Partition(n_groups=3, start=1.0, end=4.0),),
    )
    rp = ref_plan(plan)
    g = np.random.default_rng(n)
    src, dst = g.integers(0, n, 4096), g.integers(0, n, 4096)
    for tick, sub in ((0, 0), (1, 3), (3, 17), (6, 2**31 - 5), (8, 9)):
        want = ref_fsim.link_ok(rp, n, jnp.int32(tick), jnp.asarray(src, jnp.int32),
                                jnp.asarray(dst, jnp.int32), jnp.int32(sub))
        got = fsim.link_ok(plan, n, tick, torch.from_numpy(src), torch.from_numpy(dst), sub)
        assert np.array_equal(np.asarray(want), got.numpy()), (tick, sub)
        for after in (0, 3):
            want = ref_fsim.quarantine_mask(rp, n, jnp.int32(tick), open_after=after)
            got = fsim.quarantine_mask(plan, n, tick, "cpu", open_after=after)
            assert np.array_equal(np.asarray(want), got.numpy()), (tick, after)
    for fn in ("plan_affects_links", "plan_affects_nodes", "plan_amnesia_restarts",
               "plan_quarantines", "plan_affects_byzantine"):
        for p in (plan, *PLANS.values(), FaultPlan(), None):
            assert getattr(fsim, fn)(p) == getattr(ref_fsim, fn)(ref_plan(p)), (fn, p)


# -- faulted rounds against the reference's sim_step ----------------------------------

QUARANTINE = FaultPlan(links=(LinkFault(dst=NodeSet(frac=(0.0, 0.2)), drop=1.0),))
CASES = {
    "partition": dict(fault_plan=split_brain(3, start=1, heal=4)),
    "flaky": dict(fault_plan=flaky_links(0.3, seed=5)),
    "slow": dict(fault_plan=slow_third(1.5, delay_prob=0.6)),
    "warm": dict(fault_plan=rolling_restart(4, start=1, wave_every=1, down_for=1,
                                            recovery="warm")),
    "amnesia": dict(fault_plan=rolling_restart(4, start=1, wave_every=1, down_for=1)),
    "quarantine": dict(pairing="choice", quarantine=True, quarantine_open_after=1,
                       fault_plan=QUARANTINE),
    "choice_churn_crash": dict(pairing="choice", death_rate=0.05, revival_rate=0.2,
                               fault_plan=rolling_restart(2, start=1, wave_every=1,
                                                          down_for=2)),
    "permutation_flaky": dict(pairing="permutation", fault_plan=flaky_links(0.25)),
    "greedy_partition": dict(budget_policy="greedy", fault_plan=split_brain(2, heal=3)),
    "lifecycle_amnesia": dict(dead_grace_ticks=4, fault_plan=rolling_restart(
        2, start=1, wave_every=2, down_for=2)),
}


@pytest.mark.parametrize("case, profile", [
    (case, profile) for case in CASES for profile in ("full", "lean")
    if profile == "full" or "dead_grace_ticks" not in CASES[case]
])
def test_faulted_rounds_equal_reference(case, profile):
    """Five faulted rounds equal the reference's field for field, with
    the FD (int16/bfloat16) and in the lean profile; a kernel-wanting
    config counts the pull fallback "fault_plan" every round and serves
    its FD phase with the standalone kernel's wrapper."""
    kw = dict(BASE, **CASES[case])
    if profile == "lean":
        kw.update(LEAN)
    else:
        kw.update(NARROW)
    counters.reset()
    run_against_reference(kw, over=dict(use_pallas=True))
    assert dict(counters.fallbacks) == {"fault_plan": 5}
    lifecycle = kw.get("dead_grace_ticks") is not None
    fd_calls = counters.plain_calls.get("fd", 0)
    assert fd_calls == (5 if profile == "full" else 0)
    if profile == "full" and not lifecycle:
        assert gossip.resolve_phases(SimConfig(**kw, use_pallas=True), "cpu").fd == "kernel"


def test_faults_take_effect():
    """The masks act: a partition keeps the islands apart until it heals,
    a crash freezes the node's heartbeat, an amnesiac restart empties its
    row, a quarantine keeps its peers out of every draw."""
    cfg = SimConfig(**BASE, **NARROW, fault_plan=split_brain(2, heal=6))
    sim = Simulator(cfg, seed=1, device="cpu")
    sim.run(5)
    w = sim.state.w
    assert int(w[:128, 128:].max()) == 0 and int(w[128:, :128].max()) == 0
    runs = {}
    for recovery in ("warm", "amnesia"):
        cfg = SimConfig(**BASE, **NARROW, fault_plan=rolling_restart(
            2, start=3, wave_every=5, down_for=2, recovery=recovery))
        runs[recovery] = sim = Simulator(cfg, seed=1, device="cpu", chunk=1)
        hb = sim.state.heartbeat.clone()
        sim.run(4)  # the first wave is down at ticks 3 and 4
        assert torch.equal(sim.state.heartbeat[:128], hb[:128] + 2)
        assert torch.equal(sim.state.heartbeat[128:], hb[128:] + 4)
    assert torch.equal(runs["warm"].state.w, runs["amnesia"].state.w)
    for sim in runs.values():
        sim.run(1)  # tick 5: the first wave restarts, empty under amnesia
    assert int((runs["warm"].state.w[:128] > runs["amnesia"].state.w[:128]).sum()) > 0
    cfg = SimConfig(**BASE, pairing="choice", quarantine=True, quarantine_open_after=0,
                    fault_plan=QUARANTINE)
    draws = prng.chunk_draws(prng.key(2), 1, 4, cfg, alive=torch.ones(256, dtype=torch.bool))
    assert int(draws.peers.min()) >= int(0.2 * 256)


def test_quarantine_without_its_link_fault_keeps_the_uniform_draw():
    """``quarantine=True`` with no quarantining entry draws exactly as
    without it (the reference's static predicate)."""
    base = SimConfig(**BASE, pairing="choice")
    q = dataclasses.replace(base, quarantine=True, fault_plan=flaky_links(0.5))
    a = prng.chunk_draws(prng.key(3), 1, 2, base, alive=torch.ones(256, dtype=torch.bool))
    b = prng.chunk_draws(prng.key(3), 1, 2, q, alive=torch.ones(256, dtype=torch.bool))
    assert torch.equal(a.peers, b.peers)


def test_no_op_plans_keep_the_kernels():
    """An empty plan, or one with nothing effective (sub-tick delays,
    zero rates), resolves the kernel forms with no fallback, as in the
    reference; an effective one falls back first after "topology"."""
    for plan in (FaultPlan(), FaultPlan(links=(LinkFault(delay=0.5, delay_prob=1.0),)),
                 faults.byzantine_fraction(rate=0.0)):
        cfg = SimConfig(**BASE, **NARROW, fault_plan=plan, use_pallas=True)
        assert gossip.resolve_phases(cfg, "cpu") == ("pairs", None, "fused", None)
    cfg = SimConfig(**BASE, **NARROW, fault_plan=flaky_links(0.1), use_pallas=True,
                    pairing="permutation")
    assert gossip.resolve_phases(cfg, "cpu") == ("plain", "fault_plan", "kernel", None)
    assert gossip.resolve_phases(cfg, "cpu", has_topology=True).pull_fallback == "topology"


def test_faulted_mesh_equals_reference():
    """A partition healing mid-run and amnesiac restarts over 4 column
    blocks equal the reference's unsharded rounds."""
    kw = dict(BASE, **NARROW, fault_plan=FaultPlan(
        partitions=(Partition(n_groups=3, end=3.0),),
        crashes=(NodeCrash(nodes=NodeSet(frac=(0.1, 0.6)), at=1.0, down_for=1.0),),
        links=(LinkFault(drop=0.2),),
    ))
    run_mesh_against_reference(kw, over=dict(use_pallas=True))


def test_fault_seed_sweep_equals_reference():
    """Three ``fault_seeds`` lanes of a flaky plan with crash windows equal
    the reference sweep's lanes, each its own re-rolled link draws."""
    kw = dict(BASE, **NARROW, fault_plan=FaultPlan(
        links=(LinkFault(drop=0.3),),
        crashes=(NodeCrash(nodes=NodeSet(frac=(0.0, 0.25)), at=1.0, down_for=2.0),),
    ))
    counters.reset()
    sweep = sweep_against_reference(kw, over=dict(use_pallas=True), fault_seeds=[1, 2, 2**40 + 3])
    assert counters.fallbacks["fault_plan"] == 4
    assert sweep.params["fault_seeds"] == [1, 2, 2**40 + 3]
    assert not torch.equal(sweep.states.w[0], sweep.states.w[1])


def test_quarantine_simulator_chunks_equal_reference():
    """``Simulator.run`` under a quarantine and under crash windows with
    churn (the masked categorical of every round of a chunk, from the
    round's tick) reaches the reference's state."""
    simulator_against_reference(dict(BASE, **CASES["quarantine"]))
    simulator_against_reference(dict(BASE, **LEAN, **CASES["choice_churn_crash"]))


def test_sweep_fault_lanes_need_a_plan():
    """The reference's errors for fault lanes without the plan they
    override."""
    cfg = SimConfig(**BASE)
    with pytest.raises(ValueError, match="fault_seeds sweep requires cfg.fault_plan"):
        SweepSimulator(cfg, [0, 1], fault_seeds=[1, 2], device="cpu")
    with pytest.raises(ValueError, match="byz_frac sweep requires"):
        SweepSimulator(dataclasses.replace(cfg, fault_plan=flaky_links()), [0, 1],
                       byz_frac=[0.1, 0.2], device="cpu")
