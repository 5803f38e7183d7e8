"""Profiling (the port of the reference's ``obs/profiling.py``): a device
trace of everything run inside a block, and a wall-clock section timer
for host-side phases.

``device_trace`` records with ``torch.profiler`` (CPU and CUDA
activities) and writes a Chrome trace into ``logdir``; the simulator's
``torch.profiler`` ranges (``aiocluster_torch.draws``,
``aiocluster_torch.sim_step``, ``aiocluster_torch.sweep_step``) and
every kernel launch appear in it.
"""

from __future__ import annotations

import os
import time
from contextlib import contextmanager
from dataclasses import dataclass, field

import torch


@contextmanager
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


@dataclass
class SectionTimer:
    """Accumulates wall-clock per named section; ``summary()`` gives
    {name: total_seconds}. The host-side companion to device_trace."""

    totals: dict[str, float] = field(default_factory=dict)
    counts: dict[str, int] = field(default_factory=dict)

    @contextmanager
    def section(self, name: str):
        start = time.perf_counter()
        try:
            yield
        finally:
            elapsed = time.perf_counter() - start
            self.totals[name] = self.totals.get(name, 0.0) + elapsed
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> dict[str, dict[str, float]]:
        return {
            name: {
                "seconds": round(total, 6),
                "calls": self.counts[name],
                "mean_seconds": round(total / self.counts[name], 6),
            }
            for name, total in self.totals.items()
        }
