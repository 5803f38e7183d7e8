"""``python -m aiocluster_torch sim`` (aiocluster_torch/__main__.py): run
in-process with ``--cpu`` at 256 nodes, its JSON record equals the
reference CLI's for the same flags (the full and lean profiles, a mesh
of 2 blocks, churn with the lifecycle); bad flags exit 2 with the
reference's messages; ``--host-native`` and ``twin`` exit 2 naming their
roadmap items; without a card and without ``--cpu`` the run raises. The
telemetry flags serve ``/metrics`` during a run (read here from a thread
while the run goes on) and write the trace; the Prometheus text equals
the reference's rendering of the same registry; ``device_trace`` writes
a trace naming the simulator's ranges."""

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
from aiocluster_torch.obs import MetricsRegistry, SectionTimer, device_trace, render_prometheus

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


def test_unported_routes_exit_2_naming_their_items(monkeypatch):
    rc, _, err = _run(main, ["sim", "--cpu", "--host-native"])
    assert rc == 2 and "A19" in err
    rc, _, err = _run(main, ["twin", "--trace", "t.jsonl"])
    assert rc == 2 and "A17b" in err
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        main(["sim", "--nodes", "256"])


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

    sim = Simulator(SimConfig(n_nodes=128, keys_per_node=4), device="cpu")
    timer = SectionTimer()
    with device_trace(str(tmp_path)), timer.section("rounds"):
        sim.run(2)
    traces = list(tmp_path.glob("trace_*.json"))
    assert len(traces) == 1
    text = traces[0].read_text()
    assert "aiocluster_torch.sim_step" in text and "aiocluster_torch.draws" in text
    assert timer.summary()["rounds"]["calls"] == 1
