"""Profiling (the port of the reference's ``obs/profiling.py``): the
program's ``torch.profiler`` ranges, and a device trace of everything
run inside a block.

Every range of the port opens through ``span``, on the profiler's clock
(the device trace's own), and costs nothing beyond a flag test while no
profiler records. The ranges, none inside another of them:

- ``aiocluster_torch.init_state``: a study's state built on the card
  (``init_state``, ``init_lanes``; a mesh's blocks one range each);
- ``aiocluster_torch.draws``: a chunk's draws (``prng.chunk_draws``, and
  a sweep's lane salts);
- ``aiocluster_torch.sim_step`` / ``aiocluster_torch.sweep_step``: one
  round (``gossip.run_rounds`` / ``gossip.run_sweep_rounds``);
- ``aiocluster_torch.metrics_sample``: one metrics sample
  (``gossip.metrics_sample_blocks``, a sharded sweep's lane bundle);
- ``aiocluster_torch.sync``: each blocking device-to-host read of a
  study (the chunk's converged flag, ``metrics()``, the construction's
  and ``tick``'s reads, ``SimMetrics.flush``'s transfer): the host
  waiting on the card.

``device_trace`` records with ``torch.profiler`` (CPU and CUDA
activities) and writes a Chrome trace into ``logdir``; the ranges and
every kernel launch appear in it.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
import warnings

import torch

_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``torch.profiler`` range ``name`` around the block while a
    profiler records, else one shared no-op context. Off, that costs
    under 1 us a range on an x86 host, where a bare ``record_function``
    that nothing records costs 11-13 us."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF


@contextlib.contextmanager
def device_trace(logdir: str):
    """Capture a ``torch.profiler`` trace of the block (CPU and, where a
    card is visible, CUDA activity) and write it to
    ``logdir/trace_<pid>_<ns>.json`` (Chrome trace format). Yields the
    profiler, whose ``key_averages()`` sums the block's ops and kernels.

    Where kernel launches in the trace have no kernel event, warns
    (``RuntimeWarning``): the session lost device events, as a short
    window late in a long process can (its kernels' device timestamps
    drift before their own launches, out of the capture window; PERF.md,
    Open questions)."""
    cuda = torch.cuda.is_available()
    activities = [torch.profiler.ProfilerActivity.CPU]
    if cuda:
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if cuda:
            torch.cuda.synchronize()
        prof.stop()
        path = os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        prof.export_chrome_trace(path)
        if cuda:
            lost, launches = _lost_kernel_events(path)
            if lost:
                warnings.warn(f"device_trace: {lost} of {launches} kernel launches have no "
                              f"kernel event in {path}", RuntimeWarning, stacklevel=3)


def _lost_kernel_events(path: str) -> tuple[int, int]:
    """The CUDA runtime's kernel launches in a Chrome trace whose
    correlation id no kernel event carries, and all of them."""
    with open(path) as f:
        events = json.load(f).get("traceEvents", [])
    ran = {e["args"].get("correlation") for e in events
           if e.get("cat") == "kernel" and "args" in e}
    launched = [e["args"].get("correlation") for e in events
                if e.get("cat") == "cuda_runtime" and "args" in e
                and e.get("name", "").startswith("cudaLaunchKernel")]
    return sum(c not in ran for c in launched), len(launched)
