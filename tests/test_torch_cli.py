"""``python -m aiocluster_torch sim`` and ``twin``
(aiocluster_torch/__main__.py): run in-process with ``--cpu`` at 256
nodes, the ``sim`` record equals the reference CLI's for the same flags
(the full and lean profiles, a mesh of 2 blocks, churn with the
lifecycle), and so does ``sim --host-native``'s (its refusals, its
horizon clamp, and a failed build, which carries g++'s message); the
``twin`` records, messages and exit codes equal the reference's on a
seeded trace of 128 nodes (calibration, the written record byte for
byte, autotune, an infeasible SLO, a one-lane grid, the drift check);
bad flags exit 2 with the reference's messages; without a card and
without ``--cpu`` both commands raise. The telemetry flags serve
``/metrics`` during a run (read here from a thread while the run goes
on) and write the trace; the Prometheus text equals the reference's
rendering of the same registry; ``device_trace`` writes a trace naming
the simulator's ranges."""

import contextlib
import io
import json
import threading
import time
import urllib.request

import pytest
import torch

from aiocluster_tpu.__main__ import main as ref_main
from aiocluster_tpu.obs.expo import render_prometheus as ref_render
from aiocluster_tpu.obs.registry import MetricsRegistry as RefRegistry
from aiocluster_torch.__main__ import main
from aiocluster_torch.obs import MetricsRegistry, device_trace, render_prometheus
from aiocluster_torch.sim import hostsim
from aiocluster_torch.utils import cbuild
from tools.twin_trace import stretch_trace, write_twin_trace

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _no_xla_cache(monkeypatch):
    # The reference CLI would otherwise write a compilation cache.
    monkeypatch.setenv("AIOCLUSTER_XLA_CACHE", "off")


def _run(fn, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        try:
            rc = fn(argv)
        except SystemExit as exc:
            rc = exc.code
    return rc, out.getvalue(), err.getvalue()


@pytest.mark.parametrize("flags", [
    ["--nodes", "256", "--keys", "4"],
    ["--nodes", "256", "--keys", "4", "--lean", "--mtu", "1400"],
    ["--nodes", "256", "--keys", "4", "--shards", "2", "--fanout", "2"],
    ["--nodes", "256", "--churn", "0.01", "--max-rounds", "30", "--seed", "3"],
], ids=["full", "lean_mtu", "shards", "churn"])
def test_sim_record_equals_the_reference_cli(flags):
    want = _run(ref_main, ["sim", "--cpu", *flags])
    got = _run(main, ["sim", "--cpu", *flags])
    assert got[0] == want[0]
    assert json.loads(got[1].splitlines()[-1]) == json.loads(want[1].splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--nodes", "256", "--shards", "-1"],
    ["--nodes", "256", "--shards", "3"],
    ["--nodes", "256", "--lean", "--keys", "40000"],
    ["--nodes", "256", "--mtu", "30"],
], ids=["negative_shards", "uneven_shards", "lean_keys", "mtu"])
def test_bad_flags_exit_2_with_the_reference_messages(flags):
    want = _run(ref_main, ["sim", "--cpu", *flags])
    got = _run(main, ["sim", "--cpu", *flags])
    assert got[0] == want[0] == 2

    def message(err):  # a parser error names the program, which differs
        return err.splitlines()[-1].split(": error: ")[-1]

    assert message(got[2]) == message(want[2])


def test_without_a_card_and_without_cpu_the_run_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sim", "--nodes", "256"])
    trace = write_twin_trace(tmp_path / "t.jsonl", n_nodes=128, rounds=8)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["twin", "--trace", str(trace)])


def _last_record(out):
    return json.loads(out.splitlines()[-1])


@pytest.mark.parametrize("flags", [
    ["--nodes", "256", "--keys", "4", "--lean"],
    ["--nodes", "256", "--keys", "4"],
    ["--nodes", "256", "--keys", "4", "--lean", "--mtu", "1400", "--seed", "3"],
    ["--nodes", "256", "--keys", "4", "--max-rounds", "3"],
    ["--nodes", "256", "--keys", "4", "--max-rounds", "40000", "--metrics-stride", "4",
     "--trace-file", "TRACE"],
], ids=["lean", "full", "lean_mtu_seed", "unconverged", "clamp_telemetry"])
def test_host_native_record_equals_the_reference_cli(flags, tmp_path):
    flags = [str(tmp_path / "t.jsonl") if f == "TRACE" else f for f in flags]
    want = _run(ref_main, ["sim", "--host-native", *flags])
    if "--trace-file" in flags:
        (tmp_path / "t.jsonl").unlink()
    got = _run(main, ["sim", "--host-native", *flags])
    assert got[0] == want[0]
    assert _last_record(got[1]) == _last_record(want[1])
    assert _last_record(got[1])["engine"] == "host-native"
    assert got[2].splitlines() == want[2].splitlines()


@pytest.mark.parametrize("flags", [
    ["--nodes", "256", "--shards", "2"],
    ["--nodes", "200", "--lean"],
    ["--nodes", "256", "--churn", "0.01"],
    ["--nodes", "256", "--keys", "200", "--lean"],
], ids=["shards", "off_128", "churn", "keys"])
def test_host_native_refusals_equal_the_reference_cli(flags):
    want = _run(ref_main, ["sim", "--host-native", *flags])
    got = _run(main, ["sim", "--host-native", *flags])
    assert got[0] == want[0] == 2
    assert got[2] == want[2]


def test_host_native_build_failure_exits_2_with_the_compiler_message(monkeypatch, tmp_path):
    monkeypatch.setattr(cbuild, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(hostsim, "_LIB", None)
    monkeypatch.setattr(hostsim, "FLAGS", ("-O3", "-fno-such-flag-exists"))
    rc, out, err = _run(main, ["sim", "--host-native", "--nodes", "256", "--lean"])
    assert rc == 2 and not out
    assert err.startswith("native hostsim build failed") and "no-such-flag-exists" in err


@pytest.fixture(scope="module")
def twin_traces(tmp_path_factory):
    d = tmp_path_factory.mktemp("twin_cli")
    trace = write_twin_trace(d / "fleet.jsonl", n_nodes=128, rounds=40, seed=3)
    return trace, stretch_trace(trace, d / "slow.jsonl", 2.0), d


@pytest.mark.parametrize("flags", [
    [],
    ["--tolerance", "0.01", "--seed", "2"],
    ["--deadline", "60", "--fanout", "1,2,3,4", "--phi", "8,4", "--fd-budget", "0.5"],
    ["--deadline", "0.0001", "--fanout", "2,3"],
    ["--deadline", "60", "--fanout", "3"],
], ids=["calibrate", "tolerance_seed", "autotune", "infeasible", "one_lane"])
def test_twin_record_equals_the_reference_cli(flags, twin_traces):
    trace, _, d = twin_traces
    want = _run(ref_main, ["twin", "--cpu", "--trace", str(trace),
                           "--calibration-out", str(d / "ref_cal.json"), *flags])
    got = _run(main, ["twin", "--cpu", "--trace", str(trace),
                      "--calibration-out", str(d / "port_cal.json"), *flags])
    assert got[0] == want[0]
    assert _last_record(got[1]) == _last_record(want[1])
    assert (d / "port_cal.json").read_bytes() == (d / "ref_cal.json").read_bytes()


@pytest.mark.parametrize("which, flags", [
    ("fleet", []),
    ("slow", []),
    ("fleet", ["--drift-window", "10"]),
    ("slow", ["--drift-window", "40", "--tolerance", "0.9"]),
], ids=["unchanged", "stretched", "mid_window", "from_round_0"])
def test_twin_drift_check_equals_the_reference_cli(which, flags, twin_traces):
    trace, slow, d = twin_traces
    cal = d / "stored.json"
    if not cal.exists():
        _run(ref_main, ["twin", "--cpu", "--trace", str(trace), "--calibration-out", str(cal)])
    path = trace if which == "fleet" else slow
    argv = ["twin", "--cpu", "--trace", str(path), "--check-drift", str(cal), *flags]
    want, got = _run(ref_main, argv), _run(main, argv)
    assert got[0] == want[0] == (1 if which == "slow" and not flags else 0)
    assert _last_record(got[1]) == _last_record(want[1])


@pytest.mark.parametrize("flags", [
    ["--fanout", "1,2"],
    ["--phi", "8,4", "--fd-budget", "0.1"],
    ["--deadline", "10"],
], ids=["candidates_without_deadline", "budget_without_deadline", "deadline_without_candidates"])
def test_twin_flag_misuse_exits_2_with_the_reference_messages(flags, twin_traces):
    trace = str(twin_traces[0])
    want = _run(ref_main, ["twin", "--cpu", "--trace", trace, *flags])
    got = _run(main, ["twin", "--cpu", "--trace", trace, *flags])
    assert got[0] == want[0] == 2
    assert got[2] == want[2] and not got[1]


def test_metrics_port_serves_during_the_run_and_trace_file(tmp_path, capfd):
    """``--metrics-port 0`` prints its port; a scrape while the run goes
    on returns the Prometheus text; the record counts the samples."""
    trace = tmp_path / "t.jsonl"
    argv = ["sim", "--cpu", "--nodes", "256", "--keys", "4", "--metrics-port", "0",
            "--metrics-stride", "4", "--trace-file", str(trace)]
    scraped = []

    def scrape():
        deadline = time.monotonic() + 30
        while time.monotonic() < deadline and not scraped:
            line = next((x for x in capfd.readouterr().err.splitlines()
                         if "/metrics on" in x), None)
            if line is not None:
                url = "http://" + line.split(" on ")[1] + "/metrics"
                with urllib.request.urlopen(url, timeout=5) as resp:
                    scraped.append((resp.status, resp.read().decode()))
            time.sleep(0.005)

    t = threading.Thread(target=scrape)
    t.start()
    rc = main(argv)
    t.join()
    out = capfd.readouterr().out
    record = json.loads(out.splitlines()[-1])
    assert rc == 0 and record["telemetry_samples"] >= 1
    assert scraped and scraped[0][0] == 200
    assert trace.read_text().strip()


def test_prometheus_text_equals_the_reference_rendering():
    def fill(reg):
        reg.counter("c_total", "a counter", ("k",)).labels("a").inc(3)
        reg.gauge("g", "a gauge").set(2.5)
        h = reg.histogram("h_seconds", "a histogram", buckets=(0.1, 1.0))
        for v in (0.05, 0.5, 2.0):
            h.observe(v)
        return reg

    assert render_prometheus(fill(MetricsRegistry())) == ref_render(fill(RefRegistry()))


def test_device_trace_names_the_simulators_ranges(tmp_path):
    from aiocluster_torch import SimConfig, Simulator

    with device_trace(str(tmp_path)):
        sim = Simulator(SimConfig(n_nodes=128, keys_per_node=4), device="cpu")
        sim.run(2)
        sim.metrics()
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    assert "aiocluster_torch.sim_step" in text and "aiocluster_torch.draws" in text
    for name in ("init_state", "metrics_sample", "sync"):
        assert f'"aiocluster_torch.{name}"' in text, name


def test_device_trace_counts_launches_without_kernel_events(tmp_path):
    """``device_trace``'s loss check on a canned trace: a runtime kernel
    launch whose correlation id no kernel event carries is lost; a copy's
    runtime call is not a kernel launch."""
    import json

    from aiocluster_torch.obs import profiling

    events = [
        {"cat": "cuda_runtime", "name": "cudaLaunchKernel", "args": {"correlation": 1}},
        {"cat": "cuda_runtime", "name": "cudaLaunchKernelExC", "args": {"correlation": 2}},
        {"cat": "cuda_runtime", "name": "cudaMemcpyAsync", "args": {"correlation": 3}},
        {"cat": "kernel", "name": "pairs_kernel", "args": {"correlation": 1}},
        {"cat": "gpu_memcpy", "name": "Memcpy DtoD", "args": {"correlation": 3}},
    ]
    path = tmp_path / "trace.json"
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling._lost_kernel_events(str(path)) == (1, 2)
    events.append({"cat": "kernel", "name": "draws_kernel", "args": {"correlation": 2}})
    path.write_text(json.dumps({"traceEvents": events}))
    assert profiling._lost_kernel_events(str(path)) == (0, 2)
