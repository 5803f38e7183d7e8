"""JSONL trace writer: one JSON object per line, one line per event (the
port's own copy of the reference's ``obs/trace.py``: the same records,
so a trace from either package reads with either's ``read_trace``).

The schema is deliberately open — every record carries ``event`` (the
record type) and ``ts`` (wall seconds via the clock seam), and the
emitter adds whatever scalar fields describe the event (the simulator
emits one ``sim_round`` event a metrics sample). JSONL keeps the file
greppable, streamable, and loadable with one ``read_trace`` call.

The FIRST record of every fresh trace is a self-describing header
(``event == "trace_header"`` carrying ``schema``): offline consumers
refuse an incompatible schema loudly instead of mis-reading silently.
Appending to an existing file never injects a second header mid-stream.

Writes are line-buffered under a lock (safe from worker threads) and
flushed per line so a crash mid-run loses at most the line being
written. ``scan_trace``/``read_trace(skip_invalid=True)`` recover every
complete record from exactly such a torn file.
"""

from __future__ import annotations

import io
import json
import threading
from dataclasses import dataclass, field
from pathlib import Path

from ..utils.clock import Clock, resolve_clock

# Version of the trace record vocabulary. Bump ONLY on a change that
# would make an old consumer mis-read new records (renamed fields,
# changed units); added event kinds and added fields are
# forward-compatible and do not bump it.
TRACE_SCHEMA = "aiocluster-trace/1"


class TraceWriter:
    """Append-only JSONL event sink. Usable as a context manager."""

    def __init__(self, path: str | Path, *, clock: Clock | None = None) -> None:
        self.path = Path(path)
        self._fh: io.TextIOBase | None = self.path.open("a", encoding="utf-8")
        self._lock = threading.Lock()
        # ``ts`` comes from the clock seam: real wall time by default,
        # an injected clock's (a test's ManualClock) otherwise.
        self._clock = resolve_clock(clock)
        self.events_written = 0
        # A fresh (empty) file self-describes before any event lands;
        # appending to a non-empty trace keeps its original header.
        if self._fh.tell() == 0:
            self.emit("trace_header", kind="trace_header", schema=TRACE_SCHEMA)

    def emit(self, event: str, **fields: object) -> None:
        """Write one record; silently drops events after close() (late
        callbacks during shutdown must not raise)."""
        record = {"event": event, "ts": round(self._clock.wall(), 6), **fields}
        line = json.dumps(record, separators=(",", ":"), default=str)
        with self._lock:
            if self._fh is None:
                return
            self._fh.write(line + "\n")
            self._fh.flush()
            self.events_written += 1

    def close(self) -> None:
        with self._lock:
            if self._fh is not None:
                self._fh.close()
                self._fh = None

    def __enter__(self) -> "TraceWriter":
        return self

    def __exit__(self, *exc: object) -> None:
        self.close()


@dataclass
class TraceScan:
    """Result of a tolerant trace read: the complete records plus an
    account of what was skipped (line number, reason) — a crashed
    process leaves at most a torn final line, but the scan tolerates
    (and counts) any malformed line so the caller can decide whether
    the damage is a tail or the whole file."""

    records: list[dict] = field(default_factory=list)
    skipped: list[tuple[int, str]] = field(default_factory=list)

    @property
    def first_invalid(self) -> tuple[int, str] | None:
        """(lineno, reason) of the FIRST malformed line, or None."""
        return self.skipped[0] if self.skipped else None

    @property
    def header(self) -> dict | None:
        """The trace_header record, if the trace carries one."""
        if self.records and self.records[0].get("event") == "trace_header":
            return self.records[0]
        return None


def _iter_trace(path: str | Path):
    """Stream (lineno, record, reason) triples: ``record`` is the
    parsed dict for a valid line (reason None), None for a malformed
    one (reason set). Blank lines are skipped entirely."""
    with open(path, encoding="utf-8") as fh:
        for lineno, line in enumerate(fh, start=1):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as exc:
                yield lineno, None, f"invalid JSONL: {exc}"
                continue
            if not isinstance(rec, dict) or "event" not in rec:
                yield (
                    lineno,
                    None,
                    "trace records must be objects with an 'event' field",
                )
                continue
            yield lineno, rec, None


def scan_trace(path: str | Path) -> TraceScan:
    """Tolerant trace read: never raises on malformed lines. Complete
    records (valid JSON objects with an ``event`` field) are collected;
    everything else — above all the torn final line of a crashed
    writer — is counted with its line number and reason."""
    scan = TraceScan()
    for lineno, rec, reason in _iter_trace(path):
        if rec is None:
            scan.skipped.append((lineno, reason))
        else:
            scan.records.append(rec)
    return scan


def read_trace(path: str | Path, *, skip_invalid: bool = False) -> list[dict]:
    """Load a JSONL trace back into a list of dicts.

    Strict by default: raises ValueError naming the FIRST malformed
    line, failing fast at that line without reading the rest ("first"
    matters, because the first tear is where the evidence of what went
    wrong lives; later lines are usually collateral).

    ``skip_invalid=True`` recovers instead of raising: malformed lines
    are skipped and every complete record is returned — the mode for
    traces from crashed processes (a torn final line would otherwise
    make the whole file unreadable, and the trace that died with its
    process is often the one most needed). Use
    :func:`scan_trace` when the skip accounting itself is needed.
    """
    records: list[dict] = []
    for lineno, rec, reason in _iter_trace(path):
        if rec is None:
            if not skip_invalid:
                raise ValueError(f"{path}:{lineno}: {reason}")
            continue
        records.append(rec)
    return records
