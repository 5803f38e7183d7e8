"""Dependency-free metrics registry: counters, gauges, histograms (the
port's own copy of the reference's ``obs/registry.py``, standard library
only, so a snapshot of either package's registry reads the same).

Model (a deliberately small slice of the Prometheus client data model):
a registry owns named metric families; a family plus one concrete label
set is a *child* holding the actual value. Families are created lazily
and idempotently — ``registry.counter("x", ...)`` returns the existing
family on the second call — so instrumented modules never coordinate
creation order.

Thread safety: one registry-wide ``threading.Lock`` guards child
creation and every value update. Updates are a few dict/float ops, so the
lock is uncontended in practice (it exists for worker threads and for a
reader taking a snapshot mid-run).
"""

from __future__ import annotations

import threading
from bisect import bisect_right
from collections.abc import Iterable, Sequence

LabelValues = tuple[str, ...]

# Histogram default: latency-shaped (seconds), two decades around a
# gossip interval, mirroring Prometheus' client defaults closely enough
# that dashboards carry over.
DEFAULT_BUCKETS = (
    0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0,
)


def percentile_of_sorted(sorted_values, q: float) -> float:
    """Nearest-rank percentile of an already-sorted sequence of raw
    samples: ``idx = round(q * (n - 1))`` — THE percentile convention
    every measured figure shares (the sim staleness picks among them).
    NaN on empty input, so a missing series reads as missing rather
    than 0."""
    n = len(sorted_values)
    if not n:
        return float("nan")
    idx = min(n - 1, int(q * (n - 1) + 0.5))
    return sorted_values[idx]


def _bucket_quantile(
    buckets: list[tuple[float, int]], count: int, q: float
) -> float | None:
    """Bucket-interpolated quantile over ONE atomic ``stats()`` read —
    the shared math behind ``_HistogramValue.quantile`` and
    ``snapshot()``'s p50/p99 (both quantiles of a snapshot entry come
    from the same read as its count/sum, so a concurrent ``observe()``
    can never make them disagree). Prometheus ``histogram_quantile``
    conventions: a positive first bound interpolates from 0, a
    non-positive first bound is returned as-is (0 is not a valid lower
    anchor below it), and a rank landing in the +Inf bucket clamps to
    the highest finite bound."""
    if count == 0:
        return None
    rank = q * count
    prev_bound = 0.0
    prev_cum = 0
    for i, (bound, cum) in enumerate(buckets):
        if rank <= cum:
            if bound == float("inf"):
                return prev_bound  # open-ended bucket: clamp
            if i == 0 and bound <= 0:
                return bound
            if cum == prev_cum:  # defensive: rank == cum == prev_cum
                return bound
            frac = (rank - prev_cum) / (cum - prev_cum)
            return prev_bound + frac * (bound - prev_bound)
        prev_bound, prev_cum = bound, cum
    return prev_bound  # unreachable: +Inf always covers the rank


def _validate_name(name: str) -> str:
    if not name or not all(c.isalnum() or c in "_:" for c in name):
        raise ValueError(f"invalid metric name: {name!r}")
    if name[0].isdigit():
        raise ValueError(f"metric name cannot start with a digit: {name!r}")
    return name


class _Family:
    """One named metric family: children keyed by label values."""

    kind = "untyped"

    def __init__(
        self,
        name: str,
        help_text: str,
        label_names: Sequence[str],
        lock: threading.Lock,
    ) -> None:
        self.name = _validate_name(name)
        self.help = help_text
        self.label_names = tuple(label_names)
        self._lock = lock
        self._children: dict[LabelValues, object] = {}

    def labels(self, *values: str):
        """The child for one concrete label set (created on first use)."""
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"value(s) {self.label_names}, got {len(values)}"
            )
        key = tuple(str(v) for v in values)
        child = self._children.get(key)
        if child is None:
            with self._lock:
                child = self._children.setdefault(key, self._make_child())
        return child

    def remove(self, *values: str) -> None:
        """Drop one concrete label series. Per-peer families (e.g.
        ``aiocluster_breaker_state{peer}``) call this when the peer is
        garbage-collected from membership — without eviction the series
        set grows monotonically with cumulative address churn."""
        key = tuple(str(v) for v in values)
        with self._lock:
            self._children.pop(key, None)

    def _make_child(self) -> object:
        raise NotImplementedError

    def samples(self) -> list[tuple[LabelValues, object]]:
        with self._lock:
            return list(self._children.items())


class _CounterValue:
    __slots__ = ("_value", "_lock")

    def __init__(self, lock: threading.Lock) -> None:
        self._value = 0.0
        self._lock = lock

    def inc(self, amount: float = 1.0) -> None:
        if amount < 0:
            raise ValueError("counters only go up")
        with self._lock:
            self._value += amount

    @property
    def value(self) -> float:
        return self._value


class Counter(_Family):
    """Monotonically increasing count (events, bytes, packets)."""

    kind = "counter"

    def _make_child(self) -> _CounterValue:
        return _CounterValue(self._lock)

    def inc(self, amount: float = 1.0) -> None:
        """Label-less convenience: ``family.inc()`` on a 0-label family."""
        self.labels().inc(amount)


class _GaugeValue:
    __slots__ = ("_value", "_lock")

    def __init__(self, lock: threading.Lock) -> None:
        self._value = 0.0
        self._lock = lock

    def set(self, value: float) -> None:
        with self._lock:
            self._value = float(value)

    def inc(self, amount: float = 1.0) -> None:
        with self._lock:
            self._value += amount

    def dec(self, amount: float = 1.0) -> None:
        self.inc(-amount)

    @property
    def value(self) -> float:
        return self._value


class Gauge(_Family):
    """Point-in-time value (queue depth, alive count, fraction)."""

    kind = "gauge"

    def _make_child(self) -> _GaugeValue:
        return _GaugeValue(self._lock)

    def set(self, value: float) -> None:
        self.labels().set(value)

    def inc(self, amount: float = 1.0) -> None:
        self.labels().inc(amount)

    def dec(self, amount: float = 1.0) -> None:
        self.labels().dec(amount)


class _HistogramValue:
    __slots__ = ("_bounds", "_counts", "_sum", "_count", "_lock")

    def __init__(self, bounds: tuple[float, ...], lock: threading.Lock) -> None:
        self._bounds = bounds
        self._counts = [0] * (len(bounds) + 1)  # +inf tail bucket
        self._sum = 0.0
        self._count = 0
        self._lock = lock

    def observe(self, value: float) -> None:
        idx = bisect_right(self._bounds, value)
        with self._lock:
            self._counts[idx] += 1
            self._sum += value
            self._count += 1

    @property
    def sum(self) -> float:
        return self._sum

    @property
    def count(self) -> int:
        return self._count

    def stats(self) -> tuple[list[tuple[float, int]], float, int]:
        """One ATOMIC read of (cumulative buckets, sum, count): a scraper
        thread must never see a +Inf bucket that disagrees with _count
        because an observe() landed between two reads."""
        with self._lock:
            counts = list(self._counts)
            total_sum = self._sum
            total_count = self._count
        out: list[tuple[float, int]] = []
        running = 0
        for bound, c in zip(self._bounds, counts):
            running += c
            out.append((bound, running))
        out.append((float("inf"), running + counts[-1]))
        return out, total_sum, total_count

    def buckets(self) -> list[tuple[float, int]]:
        """Cumulative (upper_bound, count) pairs, +inf last — the
        Prometheus exposition shape."""
        return self.stats()[0]

    def quantile(self, q: float) -> float | None:
        """Bucket-interpolated quantile in [0, 1] — the
        ``histogram_quantile`` convention (see ``_bucket_quantile``),
        computed server-side so round-latency/RTT/phi percentiles are a
        registry read, not a bench-only recomputation over raw samples.
        None when the histogram is empty."""
        if not 0.0 <= q <= 1.0:
            raise ValueError("quantile q must be in [0, 1]")
        buckets, _, count = self.stats()
        return _bucket_quantile(buckets, count, q)


class Histogram(_Family):
    """Distribution with cumulative buckets (latencies, phi values)."""

    kind = "histogram"

    def __init__(
        self,
        name: str,
        help_text: str,
        label_names: Sequence[str],
        lock: threading.Lock,
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> None:
        super().__init__(name, help_text, label_names, lock)
        bounds = tuple(sorted(float(b) for b in buckets))
        if not bounds:
            raise ValueError("histogram needs at least one bucket bound")
        self.bounds = bounds

    def _make_child(self) -> _HistogramValue:
        return _HistogramValue(self.bounds, self._lock)

    def observe(self, value: float) -> None:
        self.labels().observe(value)

    def quantile(self, q: float) -> float | None:
        """Label-less convenience: bucket-interpolated quantile of the
        0-label child (see ``_HistogramValue.quantile``)."""
        return self.labels().quantile(q)


class MetricsRegistry:
    """Owns metric families; the unit of exposition and snapshotting."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._families: dict[str, _Family] = {}

    def _get_or_create(self, cls, name, help_text, label_names, **kwargs):
        # Check-validate-create under ONE lock hold: a race on first
        # registration must not let a conflicting definition slip past
        # the kind/label/bucket validation below.
        with self._lock:
            family = self._families.get(name)
            if family is not None:
                if not isinstance(family, cls):
                    raise ValueError(
                        f"metric {name!r} already registered as {family.kind}"
                    )
                if family.label_names != tuple(label_names):
                    raise ValueError(
                        f"metric {name!r} already registered with labels "
                        f"{family.label_names}"
                    )
                if "buckets" in kwargs:
                    bounds = tuple(sorted(float(b) for b in kwargs["buckets"]))
                    if bounds != family.bounds:
                        raise ValueError(
                            f"histogram {name!r} already registered with "
                            f"buckets {family.bounds}"
                        )
                return family
            created = cls(
                name, help_text, tuple(label_names), self._lock, **kwargs
            )
            self._families[name] = created
            return created

    def counter(
        self, name: str, help_text: str = "", labels: Sequence[str] = ()
    ) -> Counter:
        return self._get_or_create(Counter, name, help_text, labels)

    def gauge(
        self, name: str, help_text: str = "", labels: Sequence[str] = ()
    ) -> Gauge:
        return self._get_or_create(Gauge, name, help_text, labels)

    def histogram(
        self,
        name: str,
        help_text: str = "",
        labels: Sequence[str] = (),
        buckets: Iterable[float] = DEFAULT_BUCKETS,
    ) -> Histogram:
        return self._get_or_create(
            Histogram, name, help_text, labels, buckets=buckets
        )

    def families(self) -> list[_Family]:
        with self._lock:
            return [self._families[k] for k in sorted(self._families)]

    def snapshot(self) -> dict[str, object]:
        """Flat JSON-friendly view: one entry per (family, label set).
        Histograms compress to {count, sum, mean, p50, p99}
        (bucket-interpolated quantiles — so latency/RTT/phi percentiles
        ride every snapshot instead of being recomputed per consumer);
        this is the shape a benchmark record embeds."""
        out: dict[str, object] = {}
        for family in self.families():
            for values, child in family.samples():
                key = family.name
                if values:
                    key += "{" + ",".join(
                        f"{n}={v}"
                        for n, v in zip(family.label_names, values)
                    ) + "}"
                if isinstance(child, _HistogramValue):
                    # ONE atomic stats() read feeds count, sum AND both
                    # quantiles — an observe() landing mid-snapshot can
                    # never make the entry disagree with itself.
                    buckets, total_sum, count = child.stats()
                    p50 = _bucket_quantile(buckets, count, 0.50)
                    p99 = _bucket_quantile(buckets, count, 0.99)
                    out[key] = {
                        "count": count,
                        "sum": round(total_sum, 9),
                        "mean": round(total_sum / count, 9) if count else None,
                        "p50": None if p50 is None else round(p50, 9),
                        "p99": None if p99 is None else round(p99, 9),
                    }
                else:
                    out[key] = child.value  # type: ignore[attr-defined]
        return out


_default = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry instrumented code falls back to when the
    caller doesn't inject one — the ``/metrics`` endpoint serves this
    unless told otherwise."""
    return _default
