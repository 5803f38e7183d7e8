"""The port's SimConfig mirrors the reference's field for field, rejects
the same invalid inputs, takes every config of the reference's simulator
(fault plans and heterogeneity included) and every rung of the memory
ladder."""

import dataclasses

import pytest

from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_tpu.sim import budget_from_mtu
from aiocluster_torch import Simulator
from aiocluster_torch.faults import split_brain
from aiocluster_torch.models import Heterogeneity
from aiocluster_torch.sim.config import (
    HEADLINE_BUDGET,
    SimConfig,
    headline_config,
)
from aiocluster_torch.sim.state import DTYPES, expected_dtypes, expected_shapes


def test_fields_and_defaults_match_reference():
    ref = [(f.name, f.default) for f in dataclasses.fields(RefConfig)]
    port = [(f.name, f.default) for f in dataclasses.fields(SimConfig)]
    assert port == ref


def test_headline_budget_is_reference_mtu_budget():
    assert HEADLINE_BUDGET == budget_from_mtu(65_507) == 2618
    cfg = headline_config()
    ref = RefConfig(
        n_nodes=10_240, keys_per_node=16, fanout=3, budget=budget_from_mtu(65_507),
        version_dtype="int16", heartbeat_dtype="int16", fd_dtype="bfloat16",
    )
    assert dataclasses.asdict(cfg) == dataclasses.asdict(ref)


@pytest.mark.parametrize(
    "bad",
    [
        dict(n_nodes=1),
        dict(peer_mode="nope"),
        dict(pairing="ring"),
        dict(version_dtype="int64"),
        dict(heartbeat_dtype="u4r"),
        dict(fd_dtype="float16"),
        dict(icount_dtype="int32"),
        dict(window_ticks=2**15),
        dict(icount_dtype="int8", window_ticks=200),
        dict(version_dtype="u4r", budget_policy="greedy"),
        dict(version_dtype="u4r", n_nodes=129),
        dict(live_bits=True, track_failure_detector=False),
        dict(peer_mode="view"),
        dict(budget_policy="fifo"),
        dict(quarantine=True),
        dict(track_heartbeats=False),
        dict(dead_grace_ticks=1),
        dict(dead_grace_ticks=4, track_failure_detector=False),
        dict(use_pallas=1),
        dict(use_pallas="yes"),
        dict(pallas_variant="m16"),
        dict(use_pallas_fd=0),
    ],
)
def test_invalid_inputs_raise_like_reference(bad):
    kw = {"n_nodes": 256, **bad}
    with pytest.raises(ValueError):
        RefConfig(**kw)
    with pytest.raises(ValueError):
        SimConfig(**kw)


@pytest.mark.parametrize(
    "over, item",
    [
        (dict(death_rate=0.05), "A6"),
        (dict(revival_rate=0.1), "A6"),
        (dict(pairing="permutation"), "A7"),
        (dict(pairing="choice"), "A7"),
        (dict(n_nodes=200), "A7"),
        (dict(budget_policy="greedy"), "A8"),
        (dict(dead_grace_ticks=8), "A9"),
        (dict(fault_plan=split_brain(2, heal=1)), "A10"),
        (dict(heterogeneity=Heterogeneity(gossip_every=(1, 2), class_frac=(0.5, 0.5))),
         "A10"),
    ],
)
def test_out_of_slice_configs_are_refused(over, item):
    """No config is refused by roadmap ID any more. The configs of A6-A10
    (churn, the other pairings, the unrestricted matching, greedy, the
    lifecycle, fault plans and heterogeneity), once refused here case for
    case, construct and run two rounds on the CPU with their dtypes and
    shapes (tests/test_torch_churn.py, test_torch_pairings.py,
    test_torch_lifecycle.py, test_torch_faults.py and
    test_torch_heterogeneity.py hold them against the reference)."""
    kw = {"n_nodes": 256, **over}
    cfg = SimConfig(**kw, keys_per_node=4, budget=16)
    sim = Simulator(cfg, seed=0, device="cpu")
    sim.run(2)
    assert sim.tick == 2
    for name, dt in expected_dtypes(cfg).items():
        assert getattr(sim.state, name).dtype == DTYPES[dt], name
    for name, shape in expected_shapes(cfg).items():
        assert tuple(getattr(sim.state, name).shape) == shape, name


def test_in_slice_configs_construct():
    for kw in (
        dict(n_nodes=256),
        dict(n_nodes=512, version_dtype="int16", heartbeat_dtype="int16",
             fd_dtype="bfloat16", writes_per_round=1, fanout=1),
        dict(n_nodes=128, track_failure_detector=False, track_heartbeats=False),
        dict(n_nodes=128, use_pallas=False, use_pallas_fd=True),
    ):
        cfg = SimConfig(**kw)
        assert dataclasses.asdict(cfg) == dataclasses.asdict(RefConfig(**kw))


@pytest.mark.parametrize(
    "over",
    [
        dict(version_dtype="u4r"),
        dict(version_dtype="int8"),
        dict(heartbeat_dtype="int8"),
        dict(icount_dtype="int8", window_ticks=100),
        dict(live_bits=True),
    ],
    ids=["u4r", "int8", "hb_int8", "icount_int8", "live_bits"],
)
def test_ladder_rungs_construct_and_run(over):
    """The memory ladder's rungs (once refused) construct and run: two
    rounds on the CPU, every field stored in its rung's dtype."""
    cfg = SimConfig(n_nodes=256, keys_per_node=8, budget=24, **over)
    sim = Simulator(cfg, seed=0, device="cpu")
    sim.run(2)
    for name, dt in expected_dtypes(cfg).items():
        assert getattr(sim.state, name).dtype == DTYPES[dt], name
    m = sim.metrics()
    assert 0.0 < float(m["mean_fraction"]) <= 1.0 and int(m["alive_count"]) == 256
