"""The port's digital twin (aiocluster_torch/twin) against the reference's
(aiocluster_tpu/twin), on the CPU, tolerance 0: both packages read the
same seeded traces (tools/twin_trace.py; no asyncio fleet is started).

Held: ``load_runtime_trace`` on torn tails and its header refusals;
``lift_sim_config`` with overrides; ``replay``'s rows, sim series and
converged round; ``fit_calibration``'s record, its JSON byte for byte
(each package loads the other's), and the schema refusals;
``check_drift``'s verdicts and exported gauges (unchanged, stretched,
and a mid-trace window where kv_scale is skipped); ``autotune``'s
recommendation on an 8-lane grid, the infeasible lanes, the input
checks, ``SLO`` with a fault plan, ``Recommendation.from_dict`` across
packages, and that the grid runs as ONE ``SweepSimulator`` whose
sub-exchanges are one lane call for all lanes; ``wavefront_prediction``;
the runtime ``Config`` / ``NodeId`` copies.

The metrics the twin reads are exact here: the traces' 16 keys a node
make every watermark fraction a multiple of 1/16 and every count an
integer below 2**24, so any float32 summation order gives the same sum.
Off that case (owner writes) the reference's ``mean_fraction`` is a
float32 sum in XLA's order, which the port does not reproduce (ROADMAP
C8; ``test_autotune_writes_axis``)."""

from __future__ import annotations

import dataclasses
import json
import warnings

import pytest
import torch

from aiocluster_tpu import twin as ref_twin
from aiocluster_tpu.core.config import Config as RefConfig
from aiocluster_tpu.core.config import FailureDetectorConfig as RefFdConfig
from aiocluster_tpu.core.config import PersistenceConfig as RefPersistence
from aiocluster_tpu.core.identity import NodeId as RefNodeId
from aiocluster_tpu.faults import split_brain as ref_split_brain
from aiocluster_tpu.obs.registry import MetricsRegistry as RefRegistry
from aiocluster_torch import twin
from aiocluster_torch.core import DEFAULT_MAX_PAYLOAD_SIZE, Config, FailureDetectorConfig, NodeId
from aiocluster_torch.core import PersistenceConfig
from aiocluster_torch.faults import split_brain
from aiocluster_torch.obs import MetricsRegistry
from aiocluster_torch.ops import counters
from aiocluster_torch.sim import sweep as sweep_mod
from test_torch_checkpoint import ref_config
from tools.twin_trace import stretch_loaded_trace, stretch_trace, write_twin_trace

torch.set_num_threads(1)

N_NODES = 128
WALL = ("step_seconds",)
# The largest gap seen between the reference's float32 sum of a lane's
# fractions and the port's exact one is 1.2e-5 (ROADMAP C8, 128 nodes);
# test_autotune_writes_axis allows 2.5 times that (test_torch_obs holds the
# same sums at rtol 1e-5).
WRITES_FRACTION_GAP = 3e-5


@pytest.fixture(scope="module")
def traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("twin")
    fleet = write_twin_trace(d / "fleet.jsonl", n_nodes=N_NODES, rounds=40, seed=1)
    return {"dir": d, "fleet": fleet, "slow": stretch_trace(fleet, d / "slow.jsonl", 2.0)}


@pytest.fixture(scope="module")
def replays(traces):
    """Both packages' replay of the fleet trace (the expensive part, shared)."""
    ref_trace = ref_twin.load_runtime_trace(traces["fleet"])
    port_trace = twin.load_runtime_trace(traces["fleet"])
    return (ref_twin.replay(ref_trace, seed=2), twin.replay(port_trace, seed=2, device="cpu"))


def _trace_dict(t):
    return {
        "path": t.path, "header": t.header, "nodes": t.nodes, "node_rounds": t.node_rounds,
        "rounds": [dataclasses.asdict(r) for r in t.rounds], "transitions": t.transitions,
        "skipped": t.skipped, "n_nodes": t.n_nodes,
    }


def _series(series):
    return [{k: v for k, v in s.items() if k not in WALL} for s in series]


def _raises_alike(fn_ref, fn_port, exc_ref, exc_port):
    with pytest.raises(exc_ref) as want:
        fn_ref()
    with pytest.raises(exc_port) as got:
        fn_port()
    assert str(got.value) == str(want.value)


# -- traces ----------------------------------------------------------------------


@pytest.mark.parametrize("cut", [0, 1, 37, 180])
def test_load_runtime_trace_on_torn_tails(cut, traces, tmp_path):
    """The trace cut ``cut`` bytes before its end (a crashed writer's torn
    last line, or whole lines lost), plus a transition event: both
    packages recover the same records, rounds and skip count."""
    raw = traces["fleet"].read_bytes()
    raw += json.dumps({"event": "node_transition", "ts": 1.0, "peer": "node-00003",
                       "to": "dead"}).encode() + b"\n"
    path = tmp_path / "torn.jsonl"
    path.write_bytes(raw[: len(raw) - cut] if cut else raw)
    want = ref_twin.load_runtime_trace(path)
    got = twin.load_runtime_trace(path)
    assert _trace_dict(got) == _trace_dict(want)
    assert got.skipped == (0 if cut in (0, 1) else 1)  # 1: only the newline is lost
    assert got.node_rates() == want.node_rates()
    assert got.node_rates(5, 25) == want.node_rates(5, 25)
    assert got.rounds_per_sec() == want.rounds_per_sec()
    assert got.rounds_per_sec(10, 30) == want.rounds_per_sec(10, 30)
    _raises_alike(lambda: want.rounds_per_sec(50), lambda: got.rounds_per_sec(50),
                  ValueError, ValueError)


@pytest.mark.parametrize("pkg", [twin, ref_twin], ids=["port", "reference"])
def test_stretch_loaded_trace_equals_the_stretched_file(pkg, traces):
    """The in-memory stretch (the chip check's, at 10,240 nodes) gives what
    loading ``stretch_trace``'s file gives, apart from the path."""
    got = _trace_dict(stretch_loaded_trace(pkg.load_runtime_trace(traces["fleet"]), 2.0))
    want = _trace_dict(pkg.load_runtime_trace(traces["slow"]))
    assert got.pop("path") != want.pop("path")
    assert got == want


def test_header_schema_refusals(traces, tmp_path):
    lines = traces["fleet"].read_text().splitlines()
    bad = tmp_path / "bad.jsonl"
    bad.write_text("\n".join([json.dumps({"event": "trace_header", "ts": 0,
                                          "schema": "aiocluster-trace/999"})] + lines[1:]) + "\n")
    _raises_alike(lambda: ref_twin.load_runtime_trace(bad), lambda: twin.load_runtime_trace(bad),
                  ref_twin.TraceSchemaError, twin.TraceSchemaError)
    headerless = tmp_path / "headerless.jsonl"
    headerless.write_text("\n".join(lines[1:]) + "\n")
    _raises_alike(lambda: ref_twin.load_runtime_trace(headerless),
                  lambda: twin.load_runtime_trace(headerless),
                  ref_twin.TraceSchemaError, twin.TraceSchemaError)
    assert _trace_dict(twin.load_runtime_trace(headerless, require_header=False)) == _trace_dict(
        ref_twin.load_runtime_trace(headerless, require_header=False))
    nodes_only = tmp_path / "nodes_only.jsonl"
    nodes_only.write_text("\n".join(lines[: 1 + N_NODES]) + "\n")
    _raises_alike(lambda: ref_twin.load_runtime_trace(nodes_only),
                  lambda: twin.load_runtime_trace(nodes_only), ValueError, ValueError)
    assert issubclass(twin.TraceSchemaError, ValueError)


@pytest.mark.parametrize("overrides", [{}, {"budget": 24}, {"fanout": 2, "keys_per_node": 8},
                                       {"version_dtype": "int16", "heartbeat_dtype": "int16",
                                        "fd_dtype": "bfloat16"}])
def test_lift_sim_config(overrides, traces, tmp_path):
    want = ref_twin.lift_sim_config(ref_twin.load_runtime_trace(traces["fleet"]), **overrides)
    got = twin.lift_sim_config(twin.load_runtime_trace(traces["fleet"]), **overrides)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    lone = write_twin_trace(tmp_path / "lone.jsonl", n_nodes=1, rounds=4)
    _raises_alike(lambda: ref_twin.lift_sim_config(ref_twin.load_runtime_trace(lone)),
                  lambda: twin.lift_sim_config(twin.load_runtime_trace(lone)),
                  ValueError, ValueError)


# -- replay and calibration ------------------------------------------------------


def test_replay_rows_series_and_converged_round(replays):
    want, got = replays
    assert got.sim_converged_round == want.sim_converged_round is not None
    assert got.to_dict() == want.to_dict()
    assert _series(got.sim_series) == _series(want.sim_series)
    assert len(got.rows) == 40 and got.seed == 2


def test_replay_with_a_given_config(traces):
    ref_trace = ref_twin.load_runtime_trace(traces["fleet"])
    port_trace = twin.load_runtime_trace(traces["fleet"])
    cfg = twin.lift_sim_config(port_trace, budget=512, fanout=2)
    want = ref_twin.replay(ref_trace, ref_config(cfg), seed=0, max_rounds=4)
    got = twin.replay(port_trace, cfg, seed=0, max_rounds=4, device="cpu")
    assert got.to_dict() == want.to_dict()
    assert _series(got.sim_series) == _series(want.sim_series)


def test_fit_calibration_record_and_json_both_ways(replays, tmp_path):
    want = ref_twin.fit_calibration(replays[0])
    got = twin.fit_calibration(replays[1])
    assert got.to_dict() == want.to_dict()
    for rounds in (0, 7, 500):
        assert got.predict_wall_seconds(rounds) == want.predict_wall_seconds(rounds)
    ref_twin.save_calibration(tmp_path / "ref.json", want)
    twin.save_calibration(tmp_path / "port.json", got)
    assert (tmp_path / "port.json").read_bytes() == (tmp_path / "ref.json").read_bytes()
    assert twin.load_calibration(tmp_path / "ref.json") == got
    assert ref_twin.load_calibration(tmp_path / "port.json") == want
    tight = twin.fit_calibration(replays[1], holdout_frac=0.25, tolerance=0.0001)
    assert tight.to_dict() == ref_twin.fit_calibration(
        replays[0], holdout_frac=0.25, tolerance=0.0001).to_dict()


def test_calibration_errors(replays, traces, tmp_path):
    _raises_alike(lambda: ref_twin.fit_calibration(replays[0], holdout_frac=1.0),
                  lambda: twin.fit_calibration(replays[1], holdout_frac=1.0),
                  ValueError, ValueError)
    short = write_twin_trace(tmp_path / "short.jsonl", n_nodes=N_NODES, rounds=3)
    want = ref_twin.replay(ref_twin.load_runtime_trace(short), max_rounds=2)
    got = twin.replay(twin.load_runtime_trace(short), max_rounds=2, device="cpu")
    _raises_alike(lambda: ref_twin.fit_calibration(want), lambda: twin.fit_calibration(got),
                  ref_twin.CalibrationError, twin.CalibrationError)
    _raises_alike(lambda: ref_twin.CalibrationRecord.predict_wall_seconds(
        ref_twin.fit_calibration(replays[0]), -1),
        lambda: twin.fit_calibration(replays[1]).predict_wall_seconds(-1), ValueError, ValueError)


def test_calibration_schema_errors(replays, tmp_path):
    raw = twin.fit_calibration(replays[1]).to_dict()
    cases = {
        "schema": dict(raw, schema="aiocluster-twin-calibration/999"),
        "missing": {k: v for k, v in raw.items() if k != "rounds_per_sec"},
        "not_object": [raw],
    }
    for name, body in cases.items():
        path = tmp_path / f"{name}.json"
        path.write_text(json.dumps(body))
        _raises_alike(lambda: ref_twin.load_calibration(path), lambda: twin.load_calibration(path),
                      ref_twin.CalibrationSchemaError, twin.CalibrationSchemaError)
    garbled = tmp_path / "garbled.json"
    garbled.write_text("{not json")
    _raises_alike(lambda: ref_twin.load_calibration(garbled),
                  lambda: twin.load_calibration(garbled),
                  ref_twin.CalibrationSchemaError, twin.CalibrationSchemaError)
    newer = tmp_path / "newer.json"
    newer.write_text(json.dumps(dict(raw, added_later=1)))
    with warnings.catch_warnings(record=True) as ref_w:
        warnings.simplefilter("always")
        want = ref_twin.load_calibration(newer)
    with warnings.catch_warnings(record=True) as port_w:
        warnings.simplefilter("always")
        got = twin.load_calibration(newer)
    assert [str(w.message) for w in port_w] == [str(w.message) for w in ref_w] != []
    assert got.to_dict() == want.to_dict() == raw


# -- drift -------------------------------------------------------------------------


@pytest.mark.parametrize("which, window, tolerance", [
    ("fleet", None, None), ("slow", None, None), ("fleet", 10, None), ("slow", 40, 0.9),
    ("fleet", 40, None),
], ids=["unchanged", "stretched", "mid_window", "stretched_from_round_0", "from_round_0"])
def test_check_drift_verdicts_and_gauges(which, window, tolerance, replays, traces):
    cal = ref_twin.fit_calibration(replays[0])
    ref_reg, reg = RefRegistry(), MetricsRegistry()
    want = ref_twin.check_drift(cal, traces[which], window=window, tolerance=tolerance,
                                registry=ref_reg)
    got = twin.check_drift(twin.CalibrationRecord.from_dict(cal.to_dict()), traces[which],
                           window=window, tolerance=tolerance, registry=reg, device="cpu")
    assert got.to_dict() == want.to_dict()
    assert got.ok == (which == "fleet" or tolerance is not None)
    assert [a.axis for a in got.drifted_axes] == [a.axis for a in want.drifted_axes]
    assert reg.snapshot() == ref_reg.snapshot()
    if window == 10:
        assert got.skipped_axes == ("kv_scale",)
    if window == 40:
        assert "kv_scale" in [a.axis for a in got.axes]


def test_check_drift_errors(replays, traces):
    cal = twin.fit_calibration(replays[1])
    ref_cal = ref_twin.fit_calibration(replays[0])
    for kw in ({"window": 1}, {"tolerance": 0.0}, {"tolerance": -1.0}):
        _raises_alike(lambda: ref_twin.check_drift(ref_cal, traces["fleet"], **kw),
                      lambda: twin.check_drift(cal, traces["fleet"], device="cpu", **kw),
                      ValueError, ValueError)


# -- autotune ----------------------------------------------------------------------


def _base(pkg_config, pkg_node):
    return pkg_config(node_id=pkg_node(name="op", generation_id=7,
                                       gossip_advertise_addr=("127.0.0.1", 1)))


@pytest.fixture(scope="module")
def eight_lanes(replays, traces):
    """Both packages' autotune over fanout [1, 2, 3, 4] x phi [8, 4]."""
    cal = ref_twin.fit_calibration(replays[0])
    port_cal = twin.CalibrationRecord.from_dict(cal.to_dict())
    cfg = twin.lift_sim_config(twin.load_runtime_trace(traces["fleet"]))
    grid = dict(fanout=[1, 2, 3, 4], phi_threshold=[8.0, 4.0])
    want = ref_twin.autotune(ref_twin.SLO(60.0, 0.5), cal, _base(RefConfig, RefNodeId),
                             ref_config(cfg), **grid)
    got = twin.autotune(twin.SLO(60.0, 0.5), port_cal, _base(Config, NodeId), cfg,
                        device="cpu", **grid)
    return want, got, port_cal, cfg


def test_autotune_recommendation_on_eight_lanes(eight_lanes):
    want, got, _, _ = eight_lanes
    assert got.to_dict() == want.to_dict()
    assert len(got.to_dict()["evidence"]["lanes"]) == 8
    assert got.lane == want.lane and got.predicted == want.predicted
    assert got.config.gossip_count == got.sim_config.fanout
    assert got.config.failure_detector.phi_threshhold == got.sim_config.phi_threshold
    assert got.predicted_rounds_per_sec == want.predicted_rounds_per_sec


def test_recommendation_from_dict_across_packages(eight_lanes):
    want, got, _, _ = eight_lanes
    blob = json.loads(json.dumps(want.to_dict()))
    port = twin.Recommendation.from_dict(blob, _base(Config, NodeId))
    assert port.to_dict() == got.to_dict()
    assert dataclasses.asdict(port.sim_config) == dataclasses.asdict(got.sim_config)
    assert port.config == got.config
    ref = ref_twin.Recommendation.from_dict(json.loads(json.dumps(got.to_dict())),
                                            _base(RefConfig, RefNodeId))
    assert ref.to_dict() == want.to_dict()
    _raises_alike(
        lambda: ref_twin.Recommendation.from_dict(dict(blob, schema="x"), _base(RefConfig, RefNodeId)),
        lambda: twin.Recommendation.from_dict(dict(blob, schema="x"), _base(Config, NodeId)),
        ValueError, ValueError)


def test_autotune_infeasible_lanes(eight_lanes, replays):
    _, _, cal, cfg = eight_lanes
    ref_cal = ref_twin.fit_calibration(replays[0])
    grid = dict(fanout=[2, 3], phi_threshold=[8.0, 6.0])
    with pytest.raises(ref_twin.AutotuneInfeasible) as want:
        ref_twin.autotune(ref_twin.SLO(1e-4), ref_cal, _base(RefConfig, RefNodeId),
                          ref_config(cfg), **grid)
    with pytest.raises(twin.AutotuneInfeasible) as got:
        twin.autotune(twin.SLO(1e-4), cal, _base(Config, NodeId), cfg, device="cpu", **grid)
    assert str(got.value) == str(want.value)
    assert got.value.lanes == want.value.lanes and len(got.value.lanes) == 4


def test_autotune_and_slo_input_checks(eight_lanes, replays):
    _, _, cal, cfg = eight_lanes
    ref_cal = ref_twin.fit_calibration(replays[0])
    base, ref_base = _base(Config, NodeId), _base(RefConfig, RefNodeId)
    lean = dataclasses.replace(cfg, track_failure_detector=False, track_heartbeats=False)
    cases = [
        (ref_twin.SLO(10.0), ref_config(cfg), twin.SLO(10.0), cfg, dict(fanout=[3])),
        (ref_twin.SLO(10.0), ref_config(cfg), twin.SLO(10.0), cfg, {}),
        (ref_twin.SLO(10.0, 0.1), ref_config(lean), twin.SLO(10.0, 0.1), lean,
         dict(fanout=[1, 2])),
    ]
    for ref_slo, ref_cfg, slo, port_cfg, grid in cases:
        _raises_alike(lambda: ref_twin.autotune(ref_slo, ref_cal, ref_base, ref_cfg, **grid),
                      lambda: twin.autotune(slo, cal, base, port_cfg, device="cpu", **grid),
                      ValueError, ValueError)
    for args in ((0.0,), (-1.0,), (1.0, 1.5), (1.0, -0.1)):
        _raises_alike(lambda: ref_twin.SLO(*args), lambda: twin.SLO(*args),
                      ValueError, ValueError)


def test_slo_with_a_fault_plan_round_trips():
    slo = twin.SLO(30.0, 0.2, fault_plan=split_brain(2, start=0.0, heal=6.0))
    ref = ref_twin.SLO(30.0, 0.2, fault_plan=ref_split_brain(2, start=0.0, heal=6.0))
    assert slo.to_dict() == ref.to_dict()
    blob = json.loads(json.dumps(slo.to_dict()))
    assert twin.SLO.from_dict(blob) == slo
    assert ref_twin.SLO.from_dict(blob) == ref
    assert twin.SLO.from_dict({"convergence_deadline_s": 5.0}) == twin.SLO(5.0)


def test_fault_conditioned_autotune(eight_lanes, replays):
    """Every lane under the SLO's split brain (the plan runs plain, as the
    reference serves it with XLA): the recommendation and its evidence
    equal the reference's."""
    _, _, cal, cfg = eight_lanes
    ref_cal = ref_twin.fit_calibration(replays[0])
    grid = dict(fanout=[2, 3], phi_threshold=[8.0, 4.0])
    slo = twin.SLO(120.0, fault_plan=split_brain(2, start=0.0, heal=6.0))
    ref_slo = ref_twin.SLO(120.0, fault_plan=ref_split_brain(2, start=0.0, heal=6.0))
    got = twin.autotune(slo, cal, _base(Config, NodeId), cfg, device="cpu", max_rounds=256, **grid)
    want = ref_twin.autotune(ref_slo, ref_cal, _base(RefConfig, RefNodeId), ref_config(cfg),
                             max_rounds=256, **grid)
    assert got.to_dict() == want.to_dict()
    assert got.sim_config.fault_plan == slo.fault_plan


def test_autotune_runs_one_sweep_one_lane_call_a_sub_exchange(eight_lanes, monkeypatch):
    """The grid's 8 lanes are ONE SweepSimulator (the reference pins one
    compile); with the kernel dispatch asked for (its lane wrappers'
    plain versions on CPU tensors), each sub-exchange is one lane call
    for all lanes, and the recommendation is the default dispatch's."""
    _, want, cal, cfg = eight_lanes
    built = []

    class Counted(sweep_mod.SweepSimulator):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            built.append(self)

    monkeypatch.setattr(sweep_mod, "SweepSimulator", Counted)
    counters.reset()
    got = twin.autotune(twin.SLO(60.0, 0.5), cal, _base(Config, NodeId),
                        dataclasses.replace(cfg, use_pallas=True), device="cpu",
                        fanout=[1, 2, 3, 4], phi_threshold=[8.0, 4.0])
    assert len(built) == 1 and built[0].lanes == 8
    assert counters.plain_calls["pull"] == 4 * built[0].tick > 0
    for k in ("lanes", "swept", "calibration", "slo"):
        assert got.evidence[k] == want.evidence[k]
    assert got.lane == want.lane


def test_autotune_writes_axis(eight_lanes, replays):
    """A writes-per-round axis: every field equals the reference's except
    ``mean_fraction`` of a lane with writes, whose watermark fractions
    are no longer multiples of 1/16: the reference sums them in float32
    in XLA's order, the port exactly (in float64, rounded once), and the
    two differ by the float32 sum's rounding (ROADMAP C8), held here
    within ``WRITES_FRACTION_GAP``."""
    _, _, cal, cfg = eight_lanes
    ref_cal = ref_twin.fit_calibration(replays[0])
    grid = dict(fanout=[2, 3], writes_per_round=[0, 1])
    got = twin.autotune(twin.SLO(600.0), cal, _base(Config, NodeId), cfg, device="cpu",
                        max_rounds=64, **grid).to_dict()
    want = ref_twin.autotune(ref_twin.SLO(600.0), ref_cal, _base(RefConfig, RefNodeId),
                             ref_config(cfg), max_rounds=64, **grid).to_dict()
    lanes_got, lanes_want = got["evidence"].pop("lanes"), want["evidence"].pop("lanes")
    assert got == want
    for a, b in zip(lanes_got, lanes_want):
        if a["writes_per_round"]:
            assert abs(a.pop("mean_fraction") - b.pop("mean_fraction")) <= WRITES_FRACTION_GAP
        assert a == b


# -- wavefront, the runtime config ----------------------------------------------------


@pytest.mark.parametrize("kw", [{}, {"seed": 3, "threshold": 0.5, "budget": 8}])
def test_wavefront_prediction(kw, traces):
    want = ref_twin.wavefront_prediction(ref_twin.load_runtime_trace(traces["fleet"]), **kw)
    got = twin.wavefront_prediction(twin.load_runtime_trace(traces["fleet"]), device="cpu", **kw)
    assert got == want


@pytest.mark.parametrize("port_cls, ref_cls", [
    (Config, RefConfig), (FailureDetectorConfig, RefFdConfig), (PersistenceConfig, RefPersistence),
    (NodeId, RefNodeId),
])
def test_runtime_config_copies_the_reference_fields(port_cls, ref_cls):
    def default(f):
        if f.default is not dataclasses.MISSING:
            return f.default
        if f.default_factory is dataclasses.MISSING or f.name == "generation_id":
            return None
        v = f.default_factory()
        return dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v

    def spec(cls):
        return [(f.name, str(f.type), default(f)) for f in dataclasses.fields(cls)]

    assert spec(port_cls) == spec(ref_cls)
    assert DEFAULT_MAX_PAYLOAD_SIZE == 65_507
    a, b = NodeId("n"), NodeId("n")
    assert b.generation_id > a.generation_id
    assert a.long_name() == RefNodeId("n", a.generation_id).long_name()
