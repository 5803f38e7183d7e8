"""Heterogeneity (ROADMAP.md A10) in the port equals the reference bit
for bit: the ``Heterogeneity`` model and its WAN link faults, the
cadence mask at float32 class edges, the zone-biased choice draw, and
every state field of rounds under cadence classes (each pairing; the
pairs and m8 kernel dispatch, whose pair validity carries the cadence,
also against the reference's Pallas kernels in interpret mode), WAN
classes and zone bias, against the reference's ``sim_step`` on JAX CPU,
tolerance 0 — unsharded, on 4 column blocks and as 3 sweep lanes."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax import random

from aiocluster_tpu.faults import sim as ref_fsim
from aiocluster_tpu.models.topology import Heterogeneity as RefHet
from aiocluster_tpu.ops import gossip as ref_gossip
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim.state import init_state as ref_init
from aiocluster_torch import SimConfig, Simulator
from aiocluster_torch.faults import FaultPlan
from aiocluster_torch.faults import sim as fsim
from aiocluster_torch.models import Heterogeneity, ring
from aiocluster_torch.ops import counters, gossip, prng
from aiocluster_torch.sim.state import init_state
from test_torch_faults import (
    BASE,
    LEAN,
    ref_het,
    ref_kw,
    run_against_reference,
    run_mesh_against_reference,
    simulator_against_reference,
    sweep_against_reference,
)
from test_torch_sim import NARROW, _assert_states_equal

torch.set_num_threads(1)

CADENCE = Heterogeneity(gossip_every=(1, 4), class_frac=(0.5, 0.5))
THIRDS = Heterogeneity(gossip_every=(2, 3, 5), class_frac=(1 / 3, 1 / 3, 1 / 3))
WAN = Heterogeneity(zones=3, wan_loss=0.2, wan_delay=1.5)
ZONES = Heterogeneity(zones=4, wan_loss=0.1, wan_delay=1.5, zone_bias=0.5)


@pytest.mark.parametrize(
    "bad",
    [
        dict(gossip_every=(1, 2), class_frac=(1.0,)),
        dict(gossip_every=(), class_frac=()),
        dict(gossip_every=(0,)),
        dict(gossip_every=(1.5,)),
        dict(gossip_every=(1, 2), class_frac=(-0.5, 1.5)),
        dict(gossip_every=(1, 2), class_frac=(0.5, 0.6)),
        dict(zones=0),
        dict(zones=2, wan_delay=-1.0),
        dict(zones=2, wan_loss=1.5),
        dict(zone_bias=2.0),
        dict(wan_loss=0.1),
    ],
)
def test_heterogeneity_checks_raise_like_reference(bad):
    with pytest.raises(ValueError) as port:
        Heterogeneity(**bad)
    with pytest.raises(ValueError) as ref:
        RefHet(**bad)
    assert str(port.value) == str(ref.value)


@pytest.mark.parametrize("het", [CADENCE, THIRDS, WAN, ZONES, Heterogeneity()])
def test_heterogeneity_model_equals_reference(het):
    """The classification, the predicates and the WAN link faults (as
    plans' dicts) are the reference's."""
    ref = ref_het(het)
    for f in np.linspace(0.0, 0.999, 37):
        assert het.class_of_frac(f) == ref.class_of_frac(f)
        assert het.zone_of_frac(f) == ref.zone_of_frac(f)
    for name in ("n1", "node-7", "10.0.0.3:7000"):
        assert het.gossip_every_of_name(name) == ref.gossip_every_of_name(name)
        assert het.zone_of_name(name) == ref.zone_of_name(name)
    for fn in ("cadence_effective", "wan_effective", "effective"):
        assert getattr(het, fn)() == getattr(ref, fn)()
    got = [dataclasses.asdict(lf) for lf in het.wan_link_faults()]
    want = [dataclasses.asdict(lf) for lf in ref.wan_link_faults()]
    assert got == want


@pytest.mark.parametrize("n", [256, 10_240, 3 * 4096, 3 * 2**15, 1000])
def test_cadence_mask_equals_reference(n):
    """``cadence_on`` at the float32 edges of thirds (the last class takes
    every position at or above its start)."""
    # (0.30000001, 0.69999999): the first class's end rounds to float32(0.3).
    for het in (CADENCE, THIRDS, Heterogeneity(gossip_every=(1, 2), class_frac=(0.7, 0.3)),
                Heterogeneity(gossip_every=(2, 3), class_frac=(0.30000001, 0.69999999))):
        for tick in range(0, 31):
            want = ref_fsim.cadence_on(ref_het(het), n, jnp.int32(tick))
            got = fsim.cadence_on(het, n, tick, "cpu")
            assert np.array_equal(np.asarray(want), got.numpy()), (het, tick)


@pytest.mark.parametrize("lanes", [1, 3])
def test_zone_biased_draw_equals_reference(lanes):
    """``prng.zone_biased`` (after the uniform draw, from the peer key) is
    the reference's ``_zone_biased``, also over a batch of lane keys."""
    cfg = SimConfig(n_nodes=1000, pairing="choice", heterogeneity=ZONES)
    rcfg = RefConfig(n_nodes=1000, pairing="choice", heterogeneity=ref_het(ZONES))
    keys = prng.keys(range(11, 11 + lanes))
    peers = prng.randint(keys, (1000, 3), 0, 1000)
    got = prng.zone_biased(peers, keys, cfg)
    for s in range(lanes):
        key = random.key(11 + s)
        want = ref_gossip._zone_biased(random.randint(key, (1000, 3), 0, 1000), key, rcfg)
        assert np.array_equal(np.asarray(want), got[s].numpy()), s
    assert not torch.equal(got, peers)


CASES = {
    # (config, the port's switches, the pull's fallback reason or None)
    "cadence_plain": (dict(heterogeneity=CADENCE), {}, None),
    "cadence_pairs": (dict(heterogeneity=CADENCE), dict(use_pallas=True), None),
    "cadence_m8": (dict(heterogeneity=THIRDS), dict(use_pallas=True, pallas_variant="m8"),
                   None),
    "cadence_churn_pairs": (dict(heterogeneity=THIRDS, death_rate=0.05, revival_rate=0.2),
                            dict(use_pallas=True), None),
    "cadence_permutation": (dict(heterogeneity=CADENCE, pairing="permutation"),
                            dict(use_pallas=True), "pairing"),
    "cadence_choice": (dict(heterogeneity=THIRDS, pairing="choice"), dict(use_pallas=True),
                       "pairing"),
    "wan": (dict(heterogeneity=WAN), dict(use_pallas=True), "fault_plan"),
    "wan_cadence_permutation": (
        dict(heterogeneity=dataclasses.replace(WAN, gossip_every=(1, 2), class_frac=(0.5, 0.5)),
             pairing="permutation"), dict(use_pallas=True), "fault_plan"),
    "zone_bias": (dict(heterogeneity=ZONES, pairing="choice"), dict(use_pallas=True),
                  "fault_plan"),
    "zone_bias_churn": (dict(heterogeneity=Heterogeneity(zones=3, zone_bias=0.7),
                             pairing="choice", death_rate=0.05, revival_rate=0.2),
                        dict(use_pallas=True), "pairing"),
}


@pytest.mark.parametrize("case, profile", [
    (case, profile) for case in CASES for profile in ("full", "lean")
])
def test_heterogeneous_rounds_equal_reference(case, profile):
    """Five rounds under cadence classes (each pairing; the pairs and m8
    dispatch carry the cadence in their pair validity: no fallback),
    WAN classes and zone bias equal the reference's field for field."""
    kw, over, reason = CASES[case]
    kw = dict(BASE, **kw, **(NARROW if profile == "full" else LEAN))
    counters.reset()
    run_against_reference(kw, over=over)
    assert dict(counters.fallbacks) == ({} if reason is None else {reason: 5})
    if case in ("cadence_pairs", "cadence_churn_pairs"):
        assert counters.plain_calls["pull"] == 5 * 3
    if case == "cadence_m8":
        assert counters.plain_calls["m8_pull"] == 5 * 3


def test_cadence_kernel_route_equals_reference_interpret():
    """At n = 256 a cadence run on the port's pairs dispatch equals the
    reference's fused Pallas kernels run in interpret mode
    (``use_pallas=True``), the FD fused into the last sub-exchange."""
    kw = dict(BASE, **NARROW, heterogeneity=CADENCE)
    rcfg = RefConfig(**dict(ref_kw(kw), use_pallas=True, use_pallas_fd="auto"))
    pcfg = SimConfig(**kw, use_pallas=True)
    assert ref_gossip.pallas_path_engaged(rcfg)
    assert ref_gossip.fd_phase_engaged(rcfg) == "fused"
    assert gossip.resolve_phases(pcfg, "cpu") == ("pairs", None, "fused", None)
    rs, ps = ref_init(rcfg), init_state(pcfg, device="cpu")
    key, pkey = random.key(6), prng.key(6)
    for r in range(3):
        rs, rflag = ref_gossip.sim_step(rs, key, rcfg, return_converged=True)
        ps, pflag = gossip.sim_step(ps, pkey, pcfg, return_converged=True)
        _assert_states_equal(rs, ps, f"round {r + 1}")
        assert bool(rflag) == bool(pflag)


def test_cadence_quiets_the_off_classes():
    """With every node in a period-3 class, rounds off the period exchange
    nothing (w moves only by the owners' own writes)."""
    het = Heterogeneity(gossip_every=(3,), class_frac=(1.0,))
    cfg = SimConfig(**BASE, **LEAN, heterogeneity=het)
    sim = Simulator(cfg, seed=0, device="cpu", chunk=1)
    sim.run(1)  # tick 1: off-cadence
    w = sim.state.w.to(torch.int32)
    assert int((w - torch.diag(torch.diagonal(w))).max()) == 0
    sim.run(2)  # tick 3 fires
    w = sim.state.w.to(torch.int32)
    assert int((w - torch.diag(torch.diagonal(w))).max()) > 0


def test_heterogeneous_mesh_equals_reference():
    """Cadence on 4 lane-aligned column blocks (the two-pass kernel forms'
    plain versions) and WAN classes on 4 blocks (the plain pull) equal the
    reference's unsharded rounds."""
    run_mesh_against_reference(dict(BASE, **NARROW, n_nodes=512, heterogeneity=THIRDS),
                               over=dict(use_pallas=True))
    run_mesh_against_reference(dict(BASE, **NARROW, heterogeneity=WAN))


@pytest.mark.parametrize("use_pallas", [True, False], ids=["lanes", "plain"])
def test_cadence_sweep_equals_reference(use_pallas):
    """Three cadence lanes (with per-lane phi) equal the reference sweep's:
    on the pairs lane wrappers with no fallback, and on the plain lanes."""
    counters.reset()
    sweep_against_reference(dict(BASE, **NARROW, heterogeneity=THIRDS),
                            over=dict(use_pallas=use_pallas), phi_threshold=[7.0, 8.0, 9.0])
    assert not counters.fallbacks
    if use_pallas:
        assert counters.plain_calls == {"pull": 4 * 3}


def test_wan_fault_seed_sweep_equals_reference():
    """Three ``fault_seeds`` lanes of WAN classes over an empty plan (the
    derived link faults re-roll per lane) equal the reference sweep's
    lanes."""
    sweep_against_reference(dict(BASE, **LEAN, heterogeneity=WAN, fault_plan=FaultPlan()),
                            over=dict(use_pallas=True), fault_seeds=[0, 5, 9])


def test_zone_bias_simulator_equals_reference():
    """``Simulator.run`` with zone bias (the chunk's biased draws) reaches
    the reference's state; a topology with zone bias is refused with the
    reference's message."""
    simulator_against_reference(dict(BASE, **LEAN, pairing="choice", heterogeneity=ZONES))
    cfg = SimConfig(**BASE, pairing="choice", heterogeneity=ZONES)
    with pytest.raises(ValueError, match="zone_bias does not support topology runs"):
        Simulator(cfg, topology=ring(256), device="cpu")


@pytest.mark.parametrize(
    "over",
    [
        dict(heterogeneity=ZONES),
        dict(heterogeneity=ZONES, pairing="choice", peer_mode="view"),
        dict(heterogeneity="zones"),
    ],
    ids=["zone_bias_matching", "zone_bias_view", "not_a_model"],
)
def test_config_refuses_heterogeneity_like_reference(over):
    kw = dict(n_nodes=256, **over)
    with pytest.raises(ValueError) as port:
        SimConfig(**kw)
    rkw = dict(kw)
    if isinstance(kw["heterogeneity"], Heterogeneity):
        rkw["heterogeneity"] = ref_het(kw["heterogeneity"])
    with pytest.raises(ValueError) as ref:
        RefConfig(**rkw)
    assert str(port.value) == str(ref.value)
