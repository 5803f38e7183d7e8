"""The port's ``torch.profiler`` ranges (``obs.profiling.span``) on the CPU
at n = 128: one ``Simulator`` study with stride-1 telemetry and one
2-lane ``SweepSimulator`` study each open every range where its work
happens (the state's construction, each metrics sample, each blocking
host read), never inside a draws or round range, and the profiler
changes no result; with nothing recording, ``span`` is one shared no-op
context."""

import contextlib
import dataclasses
import json

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from aiocluster_torch import MetricsRegistry, Simulator, SweepSimulator, headline_config
from aiocluster_torch.obs.profiling import span
from aiocluster_torch.sim.state import STATE_FIELDS

torch.set_num_threads(1)

CFG = dataclasses.replace(headline_config(), n_nodes=128, budget=40)
NEW = ("init_state", "metrics_sample", "sync")
OWNED = ("draws", "sim_step", "sweep_step")


def _simulator():
    sim = Simulator(CFG, seed=7, chunk=8, device="cpu", metrics=MetricsRegistry(),
                    metrics_stride=1)
    first = sim.run_until_converged(max_rounds=200)
    return [first], sim.flush_metrics(), sim.state


def _sweep():
    sim = SweepSimulator(CFG, [7, 8], chunk=8, device="cpu")
    return sim.run_until_converged(max_rounds=200), None, sim.states


STUDIES = {"simulator": _simulator, "sweep": _sweep}


def _ranges(prof, path) -> dict[str, list[tuple[float, float]]]:
    """Each ``aiocluster_torch.*`` range of the profile's Chrome trace
    (as the benchmark reads it), by its short name."""
    prof.export_chrome_trace(str(path))
    out: dict[str, list[tuple[float, float]]] = {}
    for e in json.loads(path.read_text())["traceEvents"]:
        if e.get("cat") == "user_annotation" and e["name"].startswith("aiocluster_torch."):
            out.setdefault(e["name"].split(".", 1)[1], []).append((e["ts"], e["ts"] + e["dur"]))
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Each study run once under the CPU profiler and once without it."""
    out = {}
    for kind, study in STUDIES.items():
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            traced = study()
        ranges = _ranges(prof, tmp_path_factory.mktemp("spans") / f"{kind}.json")
        out[kind] = (traced, study(), ranges)
    return out


def test_span_is_a_shared_noop_while_nothing_records():
    assert not torch.autograd._profiler_enabled()
    assert span("a") is span("b")
    assert isinstance(span("a"), contextlib.nullcontext)
    with profile(activities=[ProfilerActivity.CPU]):
        assert not isinstance(span("a"), contextlib.nullcontext)


@pytest.mark.parametrize("kind", sorted(STUDIES))
def test_a_study_opens_every_range(runs, kind):
    (first, series, _), _, ranges = runs[kind]
    assert set(NEW) <= set(ranges), sorted(ranges)
    chunks = len(ranges["draws"])
    assert chunks >= 2 and len(ranges["init_state"]) == 1
    assert len(ranges["sync"]) >= chunks
    if kind == "simulator":
        # The opening metrics() of run_until_converged, then one a stride.
        assert len(ranges["metrics_sample"]) == len(series) + 1 == chunks + 1
        assert len(ranges["sim_step"]) == first[0] + (-first[0]) % 8
    else:
        # The opening metrics(), one sample a lane.
        assert len(ranges["metrics_sample"]) == len(first)


@pytest.mark.parametrize("kind", sorted(STUDIES))
def test_no_new_range_lies_inside_a_draws_or_round_range(runs, kind):
    ranges = runs[kind][2]
    owned = [r for name in OWNED for r in ranges.get(name, [])]
    for name in NEW:
        for a, b in ranges[name]:
            assert all(b <= lo or a >= hi for lo, hi in owned), (name, a, b)


@pytest.mark.parametrize("kind", sorted(STUDIES))
def test_the_profiler_changes_no_result(runs, kind):
    (first, series, state), (first0, series0, state0), _ = runs[kind]
    assert first == first0 and None not in first
    for f in STATE_FIELDS:
        assert torch.equal(getattr(state, f), getattr(state0, f)), f
    if series is not None:
        assert [s["tick"] for s in series] == [s["tick"] for s in series0]
