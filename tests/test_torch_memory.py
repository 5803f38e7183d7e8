"""The bytes model and the memory planner (aiocluster_torch/sim/bytes.py,
sim/memory.py) against the reference's: ``budget_from_mtu`` over a
spread of MTUs and workload shapes (its refusals included) equals the
reference's wire-size arithmetic, and ``HEADLINE_BUDGET`` is its value
at 65,507; ``ladder``, ``per_round_bytes`` and ``roofline_models``
equal the reference's; ``plan``'s state bytes equal the reference's for
every rung, shard count and lane count, while its transients are the
port's own and its planned bytes stay at or above every peak measured
on the H100; the capacity is the card's or an explicit argument; the
port's boundary file holds only H100 evidence and scopes it by capacity
and shards."""

import dataclasses
import json

import pytest

from aiocluster_tpu.sim import bytes as ref_bytes
from aiocluster_tpu.sim import memory as ref_memory
from aiocluster_tpu.sim import SimConfig as RefConfig
from aiocluster_torch.sim import HEADLINE_BUDGET, SimConfig, bytes as port_bytes
from aiocluster_torch.sim import memory

MTUS = [1, 20, 40, 64, 65, 66, 100, 512, 1400, 1500, 9000, 65_507, 1_000_000]
SHAPES = [
    {},
    dict(stale_owners=4),
    dict(key_bytes=200, value_bytes=3000, node_name_bytes=150, version_scale=10**9),
    dict(key_bytes=0, value_bytes=0, version_scale=0),
]


def _ref_cfg(cfg: SimConfig) -> RefConfig:
    return RefConfig(**dataclasses.asdict(cfg))


@pytest.mark.parametrize("shape", range(len(SHAPES)))
def test_budget_from_mtu_equals_the_reference(shape):
    for mtu in MTUS + [0, -5]:
        try:
            want = ref_bytes.budget_from_mtu(mtu, **SHAPES[shape])
        except ValueError as exc:
            with pytest.raises(ValueError) as got:
                port_bytes.budget_from_mtu(mtu, **SHAPES[shape])
            assert str(got.value) == str(exc)
            continue
        assert port_bytes.budget_from_mtu(mtu, **SHAPES[shape]) == want, mtu
    assert HEADLINE_BUDGET == port_bytes.budget_from_mtu(65_507) == 2618


def test_ladder_and_traffic_model_equal_the_reference():
    assert port_bytes.ladder(2048) == ref_bytes.ladder(2048)
    configs = [SimConfig(n_nodes=1024), memory.lean_config(4096, "u4r"),
               memory.full_config(2048, "shrunk"), memory.lean_config(1024, "int8", fanout=1)]
    for cfg in configs:
        rcfg = _ref_cfg(cfg)
        fd_phases = ("fused", "kernel", "xla", None) if cfg.track_failure_detector else (
            "off", None)
        for variant in ("pairs", "m8", "xla"):
            for fd_phase in fd_phases:
                assert port_bytes.per_round_bytes(cfg, variant=variant, fd_phase=fd_phase) == \
                    ref_bytes.per_round_bytes(rcfg, variant=variant, fd_phase=fd_phase)
            fd = fd_phases[0]
            assert port_bytes.roofline_models(cfg, variant=variant, fd_phase=fd) == \
                ref_bytes.roofline_models(rcfg, variant=variant, fd_phase=fd)
    with pytest.raises(ValueError, match="unknown variant"):
        port_bytes.per_round_bytes(configs[0], variant="tiles")


@pytest.mark.parametrize("family", ["lean", "full"])
def test_plan_state_bytes_equal_the_reference_for_every_rung(family):
    rungs = {"lean": ("int32", "int16", "int8", "u4r"),
             "full": ("int32", "int16", "shrunk", "deep")}[family]
    for rung in rungs:
        for n in (1024, 10_240, 100_352):
            cfg = getattr(memory, f"{family}_config")(n, rung=rung)
            rcfg = getattr(ref_memory, f"{family}_config")(n, rung=rung)
            for shards, lanes in ((1, 1), (8, 1), (1, 3), (8, 2)):
                got = memory.plan(cfg, shards, lanes)
                assert got.state_bytes == ref_memory.plan(rcfg, shards, lanes).state_bytes
                assert got.planned_bytes == got.state_bytes + got.transient_bytes
                assert got.per_shard_bytes == got.planned_bytes // shards


# Peaks measured by chip_smoke.py on one H100 80GB HBM3 at 700.00 W
# (PERF.md): the north star, pinned to m8 (two copies of w), the choice
# runs at 32,768 and 65,536, the widest u4r run, and C2,
# full_config(65,536). C2's is its run's peak, read before chip_smoke's
# sampled round check: that check clones hb_known and keeps sampled rows
# beside the run (a second 8.6 GB matrix), which no run of the config
# holds, so the phase's own peak (67.72 GB, later 72.28 GB) is the
# check's, not the plan's.
MEASURED_PEAKS_GB = [
    (dict(family="lean", n=100_352, budget=2618), 21.29),
    (dict(family="lean", n=100_352, budget=2618, pallas_variant="m8"), 40.43),
    (dict(family="lean", n=32_768, budget=2618, pairing="choice"), 12.63),
    (dict(family="lean", n=65_536, budget=2618, pairing="choice"), 38.40),
    (dict(family="lean", n=262_144, rung="u4r"), 34.4),
    (dict(family="full", n=65_536, budget=2618), 55.85),
]


@pytest.mark.parametrize("case, peak_gb", MEASURED_PEAKS_GB,
                         ids=["north_star", "north_star_m8", "choice_32k", "choice_65k",
                              "widest_u4r", "c2_run"])
def test_planned_bytes_cover_the_measured_peaks(case, peak_gb):
    case = dict(case)
    family, n = case.pop("family"), case.pop("n")
    cfg = getattr(memory, f"{family}_config")(n, **case)
    assert memory.plan(cfg).planned_bytes >= peak_gb * 1e9
    # The boundary file records the same peak for the same run.
    recorded = [e["peak_bytes"] for e in memory.load_boundaries()
                if e["n_nodes"] == n and memory.engaged_variant(cfg) == e["variant"]
                and e["version_dtype"] == cfg.version_dtype and e["pairing"] == cfg.pairing
                and e["track_heartbeats"] == cfg.track_heartbeats]
    assert recorded == [round(peak_gb * 1e9)]


def test_engaged_variant_and_capacity():
    head = SimConfig(n_nodes=10_240)
    assert memory.engaged_variant(head) == "pairs"
    assert memory.engaged_variant(dataclasses.replace(head, pallas_variant="m8")) == "m8"
    assert memory.engaged_variant(dataclasses.replace(head, pallas_variant="m8"), lanes=2) == "xla"
    assert memory.engaged_variant(dataclasses.replace(head, pairing="choice")) == "xla"
    assert memory.engaged_variant(head, shards=160) == "xla"  # blocks of 64: off the domain
    assert memory.packed_kernel_engagement() == {"u4r": True, "shrunk": True, "deep": True}
    with pytest.raises(RuntimeError, match="no CUDA device"):
        memory.device_capacity()  # no card here: the capacity is an argument
    plan = memory.plan(head)
    assert plan.fits(plan.planned_bytes * 2) and not plan.fits(plan.planned_bytes)
    model = memory.max_scale_model("lean", "u4r", capacity_bytes=80 * 10**9)
    assert model["max_nodes_model"] % 256 == 0 and not model["certified"]
    assert memory.plan(memory.lean_config(model["max_nodes_model"], "u4r")).fits(80 * 10**9)
    assert memory.ladder_models(80 * 10**9)["full_fd_deepest"]["meets_target"]


def test_the_boundary_file_holds_h100_evidence_and_scopes_it(tmp_path):
    entries = memory.load_boundaries()
    assert entries
    for e in entries:
        assert "H100" in e["card"] and "W" in e["card"] and e["source"] and e["peak_bytes"]
    cap = entries[0]["capacity_bytes"]
    ns = memory.lean_config(100_352, budget=2618)
    verdict = memory.fits_verdict(ns, capacity_bytes=cap)
    assert verdict["fits"] and verdict["measured"]
    assert not memory.fits_verdict(ns, capacity_bytes=cap // 2)["measured"]
    assert not memory.fits_verdict(ns, shards=8, capacity_bytes=cap)["measured"]
    path = str(tmp_path / "b.json")
    small = memory.lean_config(1024)
    memory.record_boundary(small, 1, False, peak_bytes=1, card="test card", source="test",
                           path=path, capacity_bytes=10**9)
    memory.record_boundary(small, 1, True, peak_bytes=1, card="test card", source="later",
                           path=path, capacity_bytes=10**9)
    got = memory.fits_verdict(small, capacity_bytes=10**9, path=path)
    assert got["fits"] and got["measured"] and got["evidence"]["source"] == "later"
    assert len(json.load(open(path))["entries"]) == 2
