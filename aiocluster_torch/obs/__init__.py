"""The simulator's telemetry (the port of the reference's ``obs``
package, its simulator-facing part):

- ``registry``: dependency-free counters, gauges and histograms with
  labels, and their JSON-friendly ``snapshot``;
- ``trace``: the JSONL trace writer, with a strict and a tolerant reader;
- ``sim``: ``SimMetrics``, the stride sampler that buffers device
  tensors and converts them once at ``flush`` (``Simulator(metrics=,
  trace_writer=)``), ``SweepMetrics`` (``SweepSimulator(metrics=)``),
  and the marked-write wavefront study;
- ``expo``: the Prometheus text rendering of a registry and the
  ``/metrics`` endpoint (``python -m aiocluster_torch sim
  --metrics-port``);
- ``profiling``: ``span`` (the program's ``torch.profiler`` ranges, free
  while no profiler records) and ``device_trace`` (a ``torch.profiler``
  Chrome trace).
"""

from .expo import MetricsHTTPServer, render_prometheus
from .profiling import device_trace
from .registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    default_registry,
    percentile_of_sorted,
)
from .sim import SimMetrics, SweepMetrics, marked_write_state, wavefront_series
from .trace import TRACE_SCHEMA, TraceScan, TraceWriter, read_trace, scan_trace

__all__ = (
    "Counter",
    "Gauge",
    "Histogram",
    "MetricsHTTPServer",
    "MetricsRegistry",
    "SimMetrics",
    "SweepMetrics",
    "TRACE_SCHEMA",
    "TraceScan",
    "TraceWriter",
    "default_registry",
    "device_trace",
    "marked_write_state",
    "percentile_of_sorted",
    "read_trace",
    "render_prometheus",
    "scan_trace",
    "wavefront_series",
)
