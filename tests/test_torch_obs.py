"""The port's telemetry equals the reference's: the registry's snapshot
after the same operations, the trace writer's lines under a manual
clock, the simulator's sampled series, trace rows and gauges from the
same run (the wall-clock fields and the engine label left out), the
sweep's per-lane gauges, the marked-write state and its wavefront, and
the variant override. Tolerance 0, except the metrics' float sums, which
the port takes in another order (as tests/test_torch_sweep.py)."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from aiocluster_tpu.obs import registry as ref_registry
from aiocluster_tpu.obs import sim as ref_obs_sim
from aiocluster_tpu.obs import trace as ref_trace
from aiocluster_tpu.ops.gossip import resolve_variant_env as ref_resolve
from aiocluster_tpu.sim import Simulator as RefSimulator
from aiocluster_tpu.sim import SweepSimulator as RefSweep
from aiocluster_tpu.utils.clock import ManualClock as RefManualClock
from aiocluster_torch import SimConfig, Simulator, SweepSimulator, lean_config
from aiocluster_torch.obs import MetricsRegistry, TraceWriter, read_trace, scan_trace
from aiocluster_torch.obs import registry, sim as obs_sim
from aiocluster_torch.ops import counters, gossip
from aiocluster_torch.parallel import make_mesh
from aiocluster_torch.utils.clock import ManualClock
from test_torch_checkpoint import ref_config
from test_torch_sim import NARROW, _assert_states_equal

torch.set_num_threads(1)

PLAIN = dict(use_pallas=False, use_pallas_fd=False)
CFG = SimConfig(n_nodes=128, keys_per_node=4, fanout=3, budget=64, **NARROW, **PLAIN)
FLOATS = ("mean_fraction", "min_fraction", "fd_false_positive_fraction")


def _drive(reg):
    """The same operations on either package's registry."""
    c = reg.counter("ops_total", "ops", labels=("kind",))
    c.labels("a").inc()
    c.labels("b").inc(2.5)
    reg.counter("plain_total").inc(3)
    g = reg.gauge("depth", "queue depth")
    g.set(7)
    g.inc(2)
    g.dec(0.5)
    lg = reg.gauge("per_peer", labels=("peer",))
    lg.labels("x").set(1)
    lg.labels("y").set(2)
    lg.remove("x")
    h = reg.histogram("lat_seconds", "latency", labels=("op",), buckets=(0.01, 0.1, 1.0))
    for v in (0.005, 0.02, 0.02, 0.5, 3.0):
        h.labels("get").observe(v)
    reg.histogram("empty_seconds")
    reg.histogram("neg", buckets=(-1.0, 0.0, 1.0)).observe(-2.0)
    return (h.labels("get").quantile(0.5), h.labels("get").quantile(0.99),
            h.labels("get").buckets(), reg.counter("ops_total", labels=("kind",)) is c)


def test_registry_snapshot_equals_the_reference():
    port, ref = registry.MetricsRegistry(), ref_registry.MetricsRegistry()
    assert _drive(port) == _drive(ref)
    assert port.snapshot() == ref.snapshot()
    assert [f.name for f in port.families()] == [f.name for f in ref.families()]
    for q in (0.0, 0.5, 0.99, 1.0):
        vals = [3, 1, 4, 1, 5, 9, 2, 6]
        assert registry.percentile_of_sorted(sorted(vals), q) == (
            ref_registry.percentile_of_sorted(sorted(vals), q))
    assert np.isnan(registry.percentile_of_sorted([], 0.5))
    assert registry.default_registry() is registry.default_registry()


@pytest.mark.parametrize(
    "misuse",
    [
        lambda r: r.counter("9bad"),
        lambda r: r.counter("has space"),
        lambda r: (r.counter("x"), r.gauge("x")),
        lambda r: (r.counter("y", labels=("a",)), r.counter("y", labels=("b",))),
        lambda r: (r.histogram("h", buckets=(1.0,)), r.histogram("h", buckets=(2.0,))),
        lambda r: r.histogram("e", buckets=()),
        lambda r: r.counter("z", labels=("a",)).labels("1", "2"),
        lambda r: r.counter("n").inc(-1),
        lambda r: r.histogram("q").quantile(1.5),
    ],
)
def test_registry_refusals_equal_the_reference(misuse):
    with pytest.raises(ValueError) as want:
        misuse(ref_registry.MetricsRegistry())
    with pytest.raises(ValueError) as got:
        misuse(registry.MetricsRegistry())
    assert str(got.value) == str(want.value)


def _write(writer_cls, clock, path):
    with writer_cls(path, clock=clock) as tw:
        tw.emit("sim_round", tick=4, mean_fraction=0.5, engine="torch")
        clock.advance(0.25)
        tw.emit("note", text="hello", values=[1, 2])
        tw.close()
        tw.emit("dropped_after_close")
    return path.read_text()


def test_trace_writer_lines_equal_the_reference(tmp_path):
    got = _write(TraceWriter, ManualClock(10.0, wall_base=1000.0), tmp_path / "p.jsonl")
    want = _write(ref_trace.TraceWriter, RefManualClock(10.0, wall_base=1000.0),
                  tmp_path / "r.jsonl")
    assert got == want
    assert json.loads(got.splitlines()[0])["schema"] == ref_trace.TRACE_SCHEMA
    # Appending keeps the one header; a torn tail is skipped and counted.
    with TraceWriter(tmp_path / "p.jsonl", clock=ManualClock()) as tw:
        tw.emit("more")
    with open(tmp_path / "p.jsonl", "a") as fh:
        fh.write('{"event": "torn"')
    scan, ref_scan = scan_trace(tmp_path / "p.jsonl"), ref_trace.scan_trace(tmp_path / "p.jsonl")
    assert (scan.records, scan.skipped) == (ref_scan.records, ref_scan.skipped)
    assert scan.header["event"] == "trace_header" and len(scan.records) == 4
    assert scan.first_invalid[0] == 5
    with pytest.raises(ValueError, match=":5: invalid JSONL"):
        read_trace(tmp_path / "p.jsonl")
    assert read_trace(tmp_path / "p.jsonl", skip_invalid=True) == scan.records


def _series(samples):
    return [{k: v for k, v in s.items() if k != "step_seconds"} for s in samples]


def _assert_series_equal(want, got):
    assert [sorted(s) for s in want] == [sorted(s) for s in got]
    for a, b in zip(want, got):
        for k in a:
            if k in FLOATS:
                np.testing.assert_allclose(b[k], a[k], rtol=1e-5, err_msg=k)
            else:
                assert a[k] == b[k], k


@pytest.mark.parametrize(
    "cfg, stride, chunk, mesh",
    [
        (CFG, 4, 2, None),
        (dataclasses.replace(CFG, writes_per_round=2), 3, 4, None),
        (lean_config(128, "int8", budget=64, keys_per_node=4, **PLAIN), 5, 8, None),
        (CFG, 4, 2, 4),
    ],
    ids=["headline", "writes", "lean_int8", "mesh"],
)
def test_sim_metrics_series_equal_the_reference(cfg, stride, chunk, mesh, tmp_path):
    """The same run through both simulators: the sampled series, the
    trace file's ``sim_round`` events and the gauges agree, the series
    is closed at the run's final tick, and its last sample equals
    ``metrics()``."""
    ref_reg, reg = ref_registry.MetricsRegistry(), MetricsRegistry()
    ref_tw = ref_trace.TraceWriter(tmp_path / "r.jsonl")
    tw = TraceWriter(tmp_path / "p.jsonl")
    ref = RefSimulator(ref_config(cfg), seed=5, chunk=chunk, metrics=ref_reg,
                       metrics_stride=stride, trace_writer=ref_tw)
    port = Simulator(cfg, seed=5, chunk=chunk, metrics=reg, metrics_stride=stride,
                     trace_writer=tw, device=None if mesh else "cpu",
                     mesh=make_mesh(["cpu"] * mesh) if mesh else None)
    for sim in (ref, port):
        sim.run(7)
        sim.run_until_converged(60)
    want, got = ref.flush_metrics(), port.flush_metrics()
    _assert_series_equal(_series(want), _series(got))
    assert got[-1]["tick"] == port.tick
    last = port.metrics()
    assert {k: float(v) for k, v in last.items()} == {
        k: v for k, v in got[-1].items()
        if k not in ("tick", "step_seconds", "delta_key_versions", "delta_bytes_est")}
    ref_tw.close()
    tw.close()
    r_events, p_events = read_trace(tmp_path / "r.jsonl"), read_trace(tmp_path / "p.jsonl")
    assert [e["event"] for e in r_events] == [e["event"] for e in p_events]
    assert [e["engine"] for e in p_events[1:]] == ["torch"] * len(got)
    strip = lambda es: [{k: v for k, v in e.items() if k not in ("ts", "engine")} for e in es]
    _assert_series_equal(_series(strip(r_events[1:])), _series(strip(p_events[1:])))

    def gauges(snap, engine):
        tag = "{engine=" + engine
        return {k.replace(tag, "{engine="): v for k, v in snap.items()
                if tag in k and "chunk_cache" not in k and "step_seconds" not in k}

    g_ref, g_port = gauges(ref_reg.snapshot(), "xla"), gauges(reg.snapshot(), "torch")
    assert sorted(g_ref) == sorted(g_port)
    for k in g_ref:
        np.testing.assert_allclose(g_port[k], g_ref[k], rtol=1e-5, err_msg=k)
    assert reg.snapshot()["aiocluster_sim_step_seconds{engine=torch}"]["count"] == len(got) - 1


def test_flush_without_telemetry_and_the_resume_anchor():
    """No registry, no writer: ``flush_metrics`` is []; a resumed run's
    rounds counter starts at its tick; the state-bytes gauge is the
    rung's plan; fallback rounds export as deltas."""
    sim = Simulator(CFG, seed=1, device="cpu")
    sim.run(3)
    assert sim.flush_metrics() == []
    reg = MetricsRegistry()
    counters.reset()
    counters.fallbacks["shape"] += 5  # earlier history is not this run's
    resumed = Simulator(CFG, seed=1, device="cpu", state=sim.state, metrics=reg,
                        metrics_stride=2)
    resumed.run(4)
    counters.fallbacks["topology"] += 2
    resumed.flush_metrics()
    snap = reg.snapshot()
    assert snap["aiocluster_sim_rounds_total{engine=torch}"] == 4
    assert snap["aiocluster_sim_state_bytes{engine=torch}"] == 128 * 128 * 11
    assert snap["aiocluster_sim_pallas_fallbacks{reason=topology}"] == 2
    assert snap["aiocluster_sim_pallas_fallbacks{reason=shape}"] == 0
    counters.reset()
    with pytest.raises(ValueError, match="stride must be >= 1"):
        Simulator(CFG, device="cpu", metrics=reg, metrics_stride=0)


def test_sampling_queues_no_host_transfer(monkeypatch):
    """``record`` and ``due`` between chunks move nothing to the host:
    the samples stay device tensors until ``flush_metrics``."""
    sim = Simulator(CFG, seed=1, device="cpu", metrics=MetricsRegistry(), metrics_stride=1,
                    chunk=1)
    calls = []
    for name in ("cpu", "item", "tolist", "numpy"):
        orig = getattr(torch.Tensor, name)
        monkeypatch.setattr(torch.Tensor, name, lambda self, *a, _n=name, _o=orig, **k: (
            calls.append(_n), _o(self, *a, **k))[1])
    sim.run(3)
    assert calls == []
    monkeypatch.undo()
    assert all(isinstance(v, torch.Tensor) for _, _, s in sim._obs._pending for v in s.values())
    assert [s["tick"] for s in sim.flush_metrics()] == [1, 2, 3]


def test_simulator_trace_rows_equal_the_reference():
    ref = RefSimulator(ref_config(CFG), seed=3, chunk=3, trace=True)
    port = Simulator(CFG, seed=3, chunk=3, trace=True, device="cpu")
    for sim in (ref, port):
        sim.run(5)
        sim.run_until_converged(60)
    assert len(ref.trace) == len(port.trace)
    for a, b in zip(ref.trace, port.trace):
        assert sorted(a) == sorted(b)
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5 if k in FLOATS else 0, err_msg=k)


def test_sweep_metrics_equal_the_reference():
    lanes = dict(phi_threshold=[7.0, 8.0, 9.5], writes_per_round=[0, 0, 1])
    ref_reg, reg = ref_registry.MetricsRegistry(), MetricsRegistry()
    ref = RefSweep(ref_config(CFG), [3, 4, 5], metrics=ref_reg, **lanes)
    port = SweepSimulator(CFG, [3, 4, 5], metrics=reg, device="cpu", **lanes)
    assert ref.run_until_converged(40) == port.run_until_converged(40)
    rows = port.result().rows()
    ref.result()
    want = {k.replace("engine=xla", "engine=torch"): v for k, v in ref_reg.snapshot().items()}
    assert reg.snapshot() == want
    snap = reg.snapshot()
    for row in rows:
        assert snap[f"aiocluster_sim_lane_version_spread{{engine=torch,lane={row['lane']}}}"] == (
            row["version_spread"])


@pytest.mark.parametrize(
    "cfg, owner",
    [(CFG, 5), (lean_config(128, "u4r", budget=64, keys_per_node=8, **PLAIN), 77)],
    ids=["int16", "u4r"],
)
def test_marked_write_and_wavefront_equal_the_reference(cfg, owner):
    rcfg = ref_config(cfg)
    _assert_states_equal(ref_obs_sim.marked_write_state(rcfg, owner),
                         obs_sim.marked_write_state(cfg, owner, device="cpu"), "marked write")
    want = ref_obs_sim.wavefront_series(rcfg, owner=owner, seed=2, max_rounds=40)
    got = obs_sim.wavefront_series(cfg, owner=owner, seed=2, max_rounds=40, device="cpu")
    assert got == want
    for bad in (dict(owner=128), dict(threshold=0.0)):
        with pytest.raises(ValueError) as w:
            ref_obs_sim.wavefront_series(rcfg, **bad)
        with pytest.raises(ValueError) as g:
            obs_sim.wavefront_series(cfg, device="cpu", **bad)
        assert str(g.value) == str(w.value)


@pytest.mark.parametrize("env", [None, "", "auto", "m8", "pairs", "bogus"])
@pytest.mark.parametrize("variant", ["auto", "pairs"])
def test_resolve_variant_env_equals_the_reference(env, variant, monkeypatch):
    if env is None:
        monkeypatch.delenv(gossip.VARIANT_ENV, raising=False)
    else:
        monkeypatch.setenv(gossip.VARIANT_ENV, env)
    cfg = dataclasses.replace(CFG, pallas_variant=variant)
    if env == "bogus":
        with pytest.raises(ValueError) as want:
            ref_resolve(ref_config(cfg))
        with pytest.raises(ValueError) as got:
            gossip.resolve_variant_env(cfg)
        assert str(got.value) == str(want.value)
        with pytest.raises(ValueError, match="must be auto/m8/pairs"):
            Simulator(cfg, device="cpu")
        return
    want = ref_resolve(ref_config(cfg)).pallas_variant
    assert gossip.resolve_variant_env(cfg).pallas_variant == want
    assert Simulator(cfg, device="cpu").cfg.pallas_variant == want
    assert SweepSimulator(cfg, [0], device="cpu").cfg.pallas_variant == want


@pytest.mark.parametrize(
    "ref_fn, port_fn",
    [
        (RefSimulator.__init__, Simulator.__init__),
        (RefSimulator.resume, Simulator.resume),
        (RefSweep.__init__, SweepSimulator.__init__),
        (RefSweep.resume, SweepSimulator.resume),
    ],
    ids=["Simulator", "Simulator.resume", "SweepSimulator", "SweepSimulator.resume"],
)
def test_entry_points_take_every_keyword_of_the_reference(ref_fn, port_fn):
    """The port's entry points accept each keyword the reference's do
    (they add ``device=``)."""
    import inspect

    want = set(inspect.signature(ref_fn).parameters)
    assert want <= set(inspect.signature(port_fn).parameters)
