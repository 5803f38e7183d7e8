"""The simulator's telemetry (the port of the reference's ``obs``
package, its simulator-facing part):

- ``registry``: dependency-free counters, gauges and histograms with
  labels, and their JSON-friendly ``snapshot``;
- ``trace``: the JSONL trace writer, with a strict and a tolerant reader;
- ``sim``: ``SimMetrics``, the stride sampler that buffers device
  tensors and converts them once at ``flush`` (``Simulator(metrics=,
  trace_writer=)``), ``SweepMetrics`` (``SweepSimulator(metrics=)``),
  and the marked-write wavefront study.
"""

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
    "MetricsRegistry",
    "SimMetrics",
    "SweepMetrics",
    "TRACE_SCHEMA",
    "TraceScan",
    "TraceWriter",
    "default_registry",
    "marked_write_state",
    "percentile_of_sorted",
    "read_trace",
    "scan_trace",
    "wavefront_series",
)
