"""The readers of the program's own ranges (``aiocluster_torch.sync``,
``.metrics_sample``, ``.init_state``): their exact values on a canned
trace, the sampler's and the construction's device time within
``off_step_device_ms``, and a traced slice of every cell on the CPU (and,
marked ``cuda``, on the card) that holds every range its metrics read."""

from pathlib import Path

import pytest

from gossipbench import harness
from gossipbench.trace import Trace

ROOT = Path(__file__).resolve().parents[2]
SMALL = {"n_nodes": 128, "budget": 40}
CELLS = ("northstar.converge", "headline.converge", "headline.phi_sweep", "headline.sampled")
# Each new metric and the program's range it reads.
READS = {
    "sync_wait_ms": "aiocluster_torch.sync",
    "sync_wait_ms.sweep": "aiocluster_torch.sync",
    "sample_device_ms": "aiocluster_torch.metrics_sample",
    "init_device_ms": "aiocluster_torch.init_state",
}
DEVICE_ONLY = {"sample_device_ms", "init_device_ms"}


def reader(name: str):
    return harness.load_module(ROOT / "gossipbench" / "metrics" / f"{name}.py").read


def _x(cat, name, ts, dur, corr=None):
    ev = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def canned_trace() -> Trace:
    """One study of two rounds. The construction launches a 0.4 ms fill
    (then a 0.2 ms read); the opening sample a 1 ms kernel (then a 0.9 ms
    read); each round's draws, a step launching a 2 ms kernel, a sample
    launching 0.5 ms and a 1.5 ms flag read; one 0.1 ms kernel launched
    outside every range."""
    ann = "user_annotation"
    ev = [
        _x(ann, "gossipbench.slice", 0, 10_000),
        _x(ann, "aiocluster_torch.init_state", 0, 300),
        _x("cuda_runtime", "cudaLaunchKernel", 50, 5, 1),
        _x("kernel", "fill", 100, 400, 1),
        _x(ann, "aiocluster_torch.sync", 400, 200),
        _x(ann, "aiocluster_torch.metrics_sample", 700, 300),
        _x("cuda_runtime", "cudaLaunchKernel", 750, 5, 2),
        _x("kernel", "sampler", 1000, 1000, 2),
        _x(ann, "aiocluster_torch.sync", 1100, 900),
    ]
    for r in range(2):
        t = 2000 + 4000 * r
        ev += [
            _x(ann, "aiocluster_torch.draws", t, 1000),
            _x(ann, "aiocluster_torch.sim_step", t + 1000, 500),
            _x("cuda_runtime", "cudaLaunchKernel", t + 1100, 5, 10 + r),
            _x("kernel", "pairs_kernel", t + 1200, 2000, 10 + r),
            _x(ann, "aiocluster_torch.metrics_sample", t + 1600, 200),
            _x("cuda_runtime", "cudaLaunchKernel", t + 1650, 5, 20 + r),
            _x("kernel", "sampler", t + 3200, 500, 20 + r),
            _x(ann, "aiocluster_torch.sync", t + 1900, 1500),
        ]
    ev += [_x("cuda_runtime", "cudaLaunchKernel", 9500, 5, 30), _x("kernel", "stack", 9700, 100, 30)]
    return Trace(ev, {"rounds": 2, "lane_rounds": 2, "studies": 1, "lanes": 1, "init_ms": [1.0],
                      "fields": {"n_nodes": 1000}})


def test_new_readers_on_a_canned_trace():
    t = canned_trace()
    assert reader("sync_wait_ms")(t) == pytest.approx((0.2 + 0.9 + 2 * 1.5) / 2)
    assert reader("sync_wait_ms.sweep")(t) == pytest.approx((0.2 + 0.9 + 2 * 1.5) / 2)
    assert reader("sample_device_ms")(t) == pytest.approx((1.0 + 2 * 0.5) / 2)
    assert reader("init_device_ms")(t) == pytest.approx(0.4)
    assert reader("off_step_device_ms")(t) == pytest.approx((0.4 + 1.0 + 2 * 0.5 + 0.1) / 2)


def test_sample_and_init_lie_within_off_step():
    t = canned_trace()
    rounds, studies = t.info["rounds"], t.info["studies"]
    inside = reader("sample_device_ms")(t) + reader("init_device_ms")(t) * studies / rounds
    assert inside <= reader("off_step_device_ms")(t)


def _traced_slice(workload: str, device, fields=None, traffic=None):
    """A cell's traced slice (set-up, then the slice under the profiler;
    no check) and its per-layer metrics as the harness reads them."""
    cell = harness.load_cell(workload, overrides=fields, traffic_overrides=traffic)
    program = harness.Program(cell, device)
    program.warm_up(2**33 + 5)
    path = ROOT / "build" / "gossipbench" / f"spans.{workload}.{program.device.type}.json"
    studies, path = harness.run_slice(program, 2**33 + 5, path)
    trace = Trace.load(path, harness.trace_info(program, studies))
    return cell, trace, harness.read_per_layer(cell, trace)


@pytest.mark.parametrize("workload", CELLS)
def test_cpu_slice_holds_every_range_its_metrics_read(workload):
    cell, trace, read = _traced_slice(workload, "cpu", SMALL, {"cap": 60, "trace_rounds": 16})
    listed = [m["name"] for m in cell.per_layer if m["name"] in READS]
    assert listed
    for name in listed:
        assert trace.ranges(READS[name]), name
        if name in DEVICE_ONLY:
            # No card, no device time to read.
            assert name not in read
        else:
            assert read[name]["value"] > 0, name


@pytest.mark.cuda
@pytest.mark.parametrize("workload", ["headline.converge", "headline.phi_sweep"])
def test_card_slice_reads_every_new_metric(cuda_device, workload):
    cell, trace, read = _traced_slice(workload, cuda_device, traffic={"trace_rounds": 24})
    listed = [m["name"] for m in cell.per_layer if m["name"] in READS]
    assert listed and all(name in read and read[name]["value"] > 0 for name in listed), read
    off_step = reader("off_step_device_ms")(trace)
    sample = reader("sample_device_ms")(trace)
    if sample is not None:
        init = reader("init_device_ms")(trace)
        assert sample + init * trace.info["studies"] / trace.info["rounds"] <= off_step
