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
import os
import time

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
    profiler, whose ``key_averages()`` sums the block's ops and kernels."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    try:
        yield prof
    finally:
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        prof.stop()
        prof.export_chrome_trace(
            os.path.join(logdir, f"trace_{os.getpid()}_{time.time_ns()}.json")
        )
