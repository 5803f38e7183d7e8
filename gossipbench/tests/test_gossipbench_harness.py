"""The harness on the CPU at small sizes: every cell's run comes out
correct; with the timed path broken underneath, and with the control in
the program's place, it comes out not correct; a run that finds no card
fails; a configuration, a traffic mix and a metric added as new files
are found by name; the metric readers on a canned trace."""

import json
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from gossipbench import control, faults, harness
from gossipbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"n_nodes": 128, "budget": 40}
FAST = {"cap": 60, "trace_rounds": 24}
CELLS = ("northstar.converge", "headline.converge", "headline.phi_sweep", "headline.sampled")


def small_cell(workload: str, **traffic) -> harness.Cell:
    return harness.load_cell(workload, overrides=SMALL, traffic_overrides={**FAST, **traffic})


def run(workload: str, trace: bool = False, seconds: float = 0.3, tmp_path=None) -> dict:
    path = None if tmp_path is None else tmp_path / "slice.trace.json"
    return harness.run_cell(small_cell(workload), 2**33 + 17, seconds, trace, "cpu",
                            trace_path=path)


@pytest.mark.parametrize("workload", CELLS)
def test_cell_runs_correct(workload):
    out = run(workload)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 1
    assert list(out)[-1] == "checks"
    assert all(c["value"] == 0 for c in out["checks"].values())
    assert {"setup_s"} <= set(out["metrics"])


@pytest.mark.parametrize("workload", CELLS)
def test_traced_run_reads_its_metrics(workload, tmp_path):
    out = run(workload, trace=True, tmp_path=tmp_path)
    assert out["correct"]
    draws = "draws_host_ms.sweep" if "sweep" in workload else "draws_host_ms"
    assert out["metrics"][draws]["value"] > 0
    assert out["device"]["window_s"] > 0 and "breakdown" in out


# Each cell with each fault it can have.
PLANTED = [(w, f) for w in CELLS for f in sorted(faults.FAULTS)
           if faults.applies(f, harness.load_cell(w))]


@pytest.mark.parametrize(("workload", "fault"), PLANTED)
def test_broken_timed_path_is_not_correct(workload, fault):
    cell = small_cell(workload)
    with faults.planted(fault, cell):
        out = harness.run_cell(cell, 2**33 + 17, 0.3, False, "cpu")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_control_is_not_correct(workload):
    out = control.control_run(small_cell(workload), 5_000_000_011, "cpu")
    assert out["correct"] is False and out["failed"] == 0, out


def test_a_run_without_a_card_fails(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    args = type("A", (), dict(workload="headline.converge", seed=1, seconds=1.0, trace=0))
    assert harness.main(args, 0.0) != 0
    assert capsys.readouterr().out == ""


def test_run_py_without_the_port_exits_nonzero(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(ROOT / "gossipbench", tmp_path / "gossipbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    proc = subprocess.run(
        [sys.executable, "gossipbench/run.py", "--workload", "headline.converge", "--seed", "1",
         "--seconds", "1", "--trace", "0"],
        cwd=tmp_path, capture_output=True, text=True, timeout=120,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert proc.returncode != 0 and proc.stdout.strip() == ""


def test_new_config_traffic_and_metric_as_files(tmp_path):
    """A later change adds a configuration, a traffic mix and a per-layer
    metric as new files and new manifest entries: the harness loads them
    by name and reads the metric, with no edit to a file that exists."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "gossipbench"
    shutil.copytree(ROOT / "gossipbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    cfg = json.loads((bench / "configs" / "headline10k.json").read_text())
    cfg["name"] = "tiny256"
    cfg["sim_config"] = {**cfg["sim_config"], **SMALL}
    (bench / "configs" / "tiny256.json").write_text(json.dumps(cfg))
    traffic = json.loads((bench / "traffic" / "converge.json").read_text())
    traffic.update(FAST, chunk=4)
    (bench / "traffic" / "converge4.json").write_text(json.dumps(traffic))
    (bench / "metrics" / "sim_step_host_ms.py").write_text(
        "def read(trace):\n"
        "    r = trace.ranges('aiocluster_torch.sim_step')\n"
        "    return trace.host_ms('aiocluster_torch.sim_step') / len(r) if r else None\n")
    man["configs"].append({"name": "tiny256", "source": "test", "file": "gossipbench/configs/tiny256.json",
                           "reduced": ["n_nodes", "budget"], "why": "test"})
    man["workloads"].append({"name": "tiny.converge4", "config": "tiny256", "traffic": "converge4",
                             "chips": 1, "why": "test"})
    man["per_layer"].append({"name": "sim_step_host_ms", "unit": "ms", "better": "lower",
                             "source": "program_span", "layer": "Round", "moves": "round_ms",
                             "workloads": ["tiny.converge4"]})
    man["end_to_end"][0]["workloads"].append("tiny.converge4")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    cell = harness.load_cell("tiny.converge4", root=tmp_path, bench=bench)
    assert cell.traffic["chunk"] == 4 and cell.fields["n_nodes"] == SMALL["n_nodes"]
    assert [m["name"] for m in cell.per_layer] == ["sim_step_host_ms"]
    out = harness.run_cell(cell, 3, 0.2, False, "cpu")
    assert out["correct"] and "round_ms" in out["metrics"]
    out = harness.run_cell(cell, 3, 0.2, True, "cpu", trace_path=tmp_path / "t.json")
    assert out["correct"] and out["metrics"]["sim_step_host_ms"]["value"] > 0
    after = {p: p.read_bytes() for p in before}
    assert after == before


SIX = ("w", "hb_known", "last_change", "imean", "icount", "live_view")
STAND_IN = (
    '"""A stand-in reference: the plain round of ``sim``, whose check also\n'
    'compares the owners\' version and heartbeat counters."""\n'
    "from .sim import COMPARED as SIM_COMPARED\n"
    "from .sim import Config, Run, State, converged, metrics_sample, state_of  # noqa: F401\n"
    "\n"
    'COMPARED = SIM_COMPARED + ("max_version", "heartbeat")\n')


def fixed_round_tree(tmp_path) -> tuple[Path, dict]:
    """A copy of the benchmark with, as new files and new manifest entries
    only, a reference module, a configuration naming it and a traffic mix
    of 12-round studies at chunk 4; returns the copy and the bytes of
    every file of the benchmark's folder before."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    bench = tmp_path / "gossipbench"
    shutil.copytree(ROOT / "gossipbench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    before = {p: p.read_bytes() for p in bench.rglob("*") if p.is_file()}
    (bench / "reference" / "sim_counters.py").write_text(STAND_IN)
    cfg = json.loads((bench / "configs" / "headline10k.json").read_text())
    cfg.update(name="tiny_counters", reference="sim_counters",
               sim_config={**cfg["sim_config"], **SMALL})
    (bench / "configs" / "tiny_counters.json").write_text(json.dumps(cfg))
    (bench / "traffic" / "fixed12.json").write_text(json.dumps({
        "about": "12-round studies", "kind": "simulator", "chunk": 4, "rounds": 12,
        "warmup_rounds": 4, "trace_rounds": 24, "check_sample": 1}))
    man = json.loads((tmp_path / "BENCHMARK.json").read_text())
    man["configs"].append({"name": "tiny_counters", "source": "test",
                           "file": "gossipbench/configs/tiny_counters.json",
                           "reduced": ["n_nodes", "budget"], "why": "test"})
    man["workloads"].append({"name": "tiny.fixed12", "config": "tiny_counters",
                             "traffic": "fixed12", "chips": 1, "why": "test"})
    for m in man["end_to_end"] + man["per_layer"]:
        if m["name"] in ("round_ms", "draws_host_ms"):
            m["workloads"].append("tiny.fixed12")
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(man))
    return tmp_path, before


def fixed_round_cell(tmp_path) -> harness.Cell:
    root, _ = fixed_round_tree(tmp_path)
    return harness.load_cell("tiny.fixed12", root=root, bench=root / "gossipbench")


def test_new_reference_and_fixed_round_traffic_as_files(tmp_path):
    """A later change adds a configuration that names its own reference
    module and a traffic mix of studies of a fixed number of rounds, as
    new files and new manifest entries: the harness checks those studies
    against that module, with no edit to a file that exists."""
    root, before = fixed_round_tree(tmp_path)
    cell = harness.load_cell("tiny.fixed12", root=root, bench=root / "gossipbench")
    assert cell.reference.COMPARED == SIX + ("max_version", "heartbeat")
    out = harness.run_cell(cell, 2**33 + 19, 0.3, False, "cpu")
    assert out["correct"] and out["failed"] == 0 and out["attempted"] >= 2, out["checks"]
    assert out["checks"] == {k: {"value": 0, "limit": 0}
                             for k in ("rounds_off", "state_diff", "answer_diff")}
    assert out["metrics"]["round_ms"]["value"] > 0
    out = harness.run_cell(cell, 2**33 + 19, 0.3, True, "cpu", trace_path=tmp_path / "t.json")
    assert out["correct"] and out["metrics"]["draws_host_ms"]["value"] > 0
    assert {p: p.read_bytes() for p in before} == before


def test_fixed_round_studies_answer_their_bundle(tmp_path):
    cell = fixed_round_cell(tmp_path)
    program = harness.Program(cell, "cpu")
    st = program.study(0, program.seeds(7, 0))
    ref = cell.reference
    run = ref.Run(ref.Config.from_fields(cell.fields), st.seeds[0], "cpu")
    run.run_to(12)
    assert not st.failed and st.first == [] and st.ticks == 12
    assert st.answer == ref.metrics_sample(run.state)


def test_control_is_not_correct_in_a_fixed_round_cell(tmp_path):
    out = control.control_run(fixed_round_cell(tmp_path), 5_000_000_011, "cpu")
    assert out["correct"] is False and out["failed"] == 0, out


def test_faults_of_a_fixed_round_cell(tmp_path):
    """No sweep lanes and no convergence flag in a fixed-round simulator
    study: its faults break the state, the rows and the final bundle."""
    cell = fixed_round_cell(tmp_path)
    assert [f for f in sorted(faults.FAULTS) if faults.applies(f, cell)] == [
        "bundle_altered", "half_the_rows", "state_unchanged"]


@pytest.mark.parametrize("fault", ["bundle_altered", "half_the_rows", "state_unchanged"])
def test_broken_timed_path_is_not_correct_in_a_fixed_round_cell(fault, tmp_path):
    cell = fixed_round_cell(tmp_path)
    with faults.planted(fault, cell):
        out = harness.run_cell(cell, 2**33 + 19, 0.3, False, "cpu")
    assert out["correct"] is False, out["checks"]


@pytest.mark.parametrize("workload", CELLS)
def test_cells_keep_the_sim_reference_and_their_checks(workload):
    cell = harness.load_cell(workload)
    assert Path(cell.reference.__file__) == ROOT / "gossipbench" / "reference" / "sim.py"
    assert cell.reference.COMPARED == SIX
    want = ["rounds_off", "state_diff"] + (["series_diff"] if workload == "headline.sampled" else [])
    assert list(harness.limits(cell).items()) == [(k, 0) for k in want]


@pytest.mark.parametrize("workload", ["northstar.converge", "headline.phi_sweep"])
def test_fixed_rounds_refused_in_a_sweep_or_stepwise_cell(workload):
    with pytest.raises(ValueError, match="fixed number of rounds"):
        harness.load_cell(workload, traffic_overrides={"rounds": 12})


def canned_trace() -> Trace:
    """Two rounds: draws on the host (1 ms each), a step range launching a
    2 ms kernel, a sampler's 1 ms kernel launched outside both."""
    ev = [{"ph": "X", "cat": "user_annotation", "name": "gossipbench.slice", "ts": 0, "dur": 10_000}]
    for r in range(2):
        t = r * 5000
        ev += [
            {"ph": "X", "cat": "user_annotation", "name": "aiocluster_torch.draws", "ts": t, "dur": 1000},
            {"ph": "X", "cat": "user_annotation", "name": "aiocluster_torch.sim_step",
             "ts": t + 1000, "dur": 500},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + 1100, "dur": 5,
             "args": {"correlation": 10 + r}},
            {"ph": "X", "cat": "kernel", "name": "pairs_kernel", "ts": t + 1200, "dur": 2000,
             "args": {"correlation": 10 + r}},
            {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": t + 3300, "dur": 5,
             "args": {"correlation": 20 + r}},
            {"ph": "X", "cat": "kernel", "name": "sampler", "ts": t + 3400, "dur": 1000,
             "args": {"correlation": 20 + r}},
        ]
    fields = {"n_nodes": 1000, "version_dtype": "int16", "track_heartbeats": False,
              "track_failure_detector": False, "fanout": 3}
    return Trace(ev, {"rounds": 2, "lane_rounds": 2, "studies": 1, "lanes": 1,
                      "init_ms": [3.0, 5.0], "fields": fields})


def test_readers_on_a_canned_trace():
    t = canned_trace()
    read = {p.stem: harness.load_module(p).read(t) for p in (ROOT / "gossipbench" / "metrics").glob("*.py")}
    assert read["draws_host_ms"] == pytest.approx(1.0)
    # 12 B a pair at 1,000 nodes: 12e6 B / 3.35 TB/s over 2 ms a round.
    assert read["round_roofline"] == pytest.approx(100 * 12e6 / 3.35e12 * 1e3 / 2.0)
    assert read["device_idle_share"] == pytest.approx(100 * (1 - 6000 / 10_000))
    assert read["off_step_device_ms"] == pytest.approx(1.0)
    assert read["study_init_ms"] == pytest.approx(4.0)
    assert read["round_roofline.sweep"] is None
    assert t.device_ops()[0] == ["pairs_kernel", pytest.approx(0.004)]
    assert t.idle_gaps()[0][0].startswith("aiocluster_torch.draws") or t.idle_gaps()


def test_readers_find_nothing_on_a_trace_without_the_card():
    ev = [{"ph": "X", "cat": "user_annotation", "name": "gossipbench.slice", "ts": 0, "dur": 100}]
    t = Trace(ev, {"rounds": 0, "lane_rounds": 0, "studies": 0, "lanes": 1, "init_ms": [],
                   "fields": {"n_nodes": 8}})
    for p in (ROOT / "gossipbench" / "metrics").glob("*.py"):
        assert harness.load_module(p).read(t) is None, p.stem
