"""Reading a ``torch.profiler`` chrome trace of a traced slice: the host
ranges (``record_function``), the device's kernel, copy and set
intervals, and which host range launched each device operation (the
runtime launch's correlation id), with the device's busy time as the
union of its intervals (the arithmetic of ``chip_smoke.trace_breakdown``,
copied).
"""

from __future__ import annotations

import bisect
import collections
import json
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
SLICE = "gossipbench.slice"


class Trace:
    """The events of one trace inside the harness's ``gossipbench.slice``
    range, with the slice's counts (``info``: rounds, lane-rounds,
    studies, the configuration's fields, ...). Times in microseconds as
    the trace gives them."""

    def __init__(self, events: list[dict], info: dict) -> None:
        self.info = info
        events = [e for e in events if e.get("ph") == "X"]
        win = next(e for e in events if e.get("cat") == "user_annotation" and e["name"] == SLICE)
        self.t0, self.t1 = win["ts"], win["ts"] + win["dur"]
        inside = [e for e in events if self.t0 <= e["ts"] <= self.t1]
        self.annotations = [e for e in inside if e.get("cat") == "user_annotation"
                            and e["name"] != SLICE]
        self.cpu_ops = [e for e in inside if e.get("cat") == "cpu_op"]
        self.launches = [e for e in inside if e.get("cat") in LAUNCH_CATS]
        self.device = sorted((e for e in inside if e.get("cat") in DEVICE_CATS),
                             key=lambda e: e["ts"])
        self._ann_index = _index(self.annotations)
        self._op_index = _index(self.cpu_ops)

    @classmethod
    def load(cls, path: Path, info: dict) -> "Trace":
        return cls(json.loads(Path(path).read_text())["traceEvents"], info)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6

    def ranges(self, name: str) -> list[tuple[float, float]]:
        """The (start, end) of each host range ``name`` in the slice."""
        return [(e["ts"], e["ts"] + e["dur"]) for e in self.annotations if e["name"] == name]

    def host_ms(self, name: str) -> float:
        """Host time inside the ranges ``name``, in ms."""
        return sum(b - a for a, b in self.ranges(name)) / 1e3

    def launched_in(self, names) -> set:
        """Correlation ids of the launches made inside a range of any of
        ``names`` (ranges that do not overlap one another)."""
        spans = sorted(r for name in names for r in self.ranges(name))
        starts = [a for a, _ in spans]
        out = set()
        for e in self.launches:
            k = bisect.bisect_right(starts, e["ts"]) - 1
            if k >= 0 and e["ts"] <= spans[k][1]:
                out.add(e.get("args", {}).get("correlation"))
        return out

    def device_ms(self, corrs=None, exclude=None) -> float:
        """Device time, in ms, of the operations launched with the
        correlation ids ``corrs`` (all when None), less those in
        ``exclude``."""
        tot = 0.0
        for e in self.device:
            corr = e.get("args", {}).get("correlation")
            if corrs is not None and corr not in corrs:
                continue
            if exclude is not None and corr in exclude:
                continue
            tot += min(e["ts"] + e["dur"], self.t1) - e["ts"]
        return tot / 1e3

    def busy_intervals(self) -> list[tuple[float, float]]:
        """The union of the device's intervals inside the slice."""
        out: list[list[float]] = []
        for e in self.device:
            a, b = e["ts"], min(e["ts"] + e["dur"], self.t1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return [(a, b) for a, b in out]

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e6

    def device_ops(self, top: int = 10) -> list[list]:
        """The device operations that took most time, by name, in s."""
        by = collections.Counter()
        for e in self.device:
            by[e["name"]] += e["dur"] / 1e6
        return [[name, sec] for name, sec in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list[list]:
        """Idle device time inside the slice, summed by what the host was
        doing at the gap's start (the innermost annotation and the
        innermost operator open then), in s."""
        busy = self.busy_intervals()
        gaps, end = [], self.t0
        for a, b in busy:
            if a > end:
                gaps.append((end, a))
            end = max(end, b)
        if self.t1 > end:
            gaps.append((end, self.t1))
        by = collections.Counter()
        for a, b in gaps:
            by[self._host_at(a)] += (b - a) / 1e6
        return [[name, sec] for name, sec in by.most_common(top)]

    def _host_at(self, t: float) -> str:
        ann = _innermost(self._ann_index, t, look=4096) or "harness"
        return f"{ann}:{_innermost(self._op_index, t) or 'python'}"


def _index(events: list[dict]) -> tuple[list[float], list[dict]]:
    ordered = sorted(events, key=lambda e: e["ts"])
    return [e["ts"] for e in ordered], ordered


def _innermost(index, t: float, look: int = 64) -> str | None:
    """The name of the latest-starting event open at ``t``, among the
    ``look`` latest that start before it."""
    starts, ordered = index
    k = bisect.bisect_right(starts, t) - 1
    for e in ordered[max(0, k - look + 1):k + 1][::-1]:
        if t <= e["ts"] + e["dur"]:
            return e["name"]
    return None
