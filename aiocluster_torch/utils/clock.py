"""The clock seam (the port's own copy of the reference's
``utils/clock.py``, without the virtual-time context clock, which serves
an asyncio runtime the port does not have).

A :class:`Clock` gives three views of one instant. Code that stamps
time (the trace writer's ``ts``) takes an optional clock; ``None``
resolves to :data:`SYSTEM_CLOCK`, and tests inject a
:class:`ManualClock` instead of sleeping.
"""

from __future__ import annotations

import time
from datetime import datetime, timezone
from typing import Protocol, runtime_checkable

UTC = timezone.utc


@runtime_checkable
class Clock(Protocol):
    """Three views of one instant: a monotonic float for durations and
    deadlines, a wall float (epoch seconds) for trace records, and an
    aware UTC datetime. Implementations keep the three consistent
    (``now() == fromtimestamp(wall())``) so mixed consumers agree on
    ordering."""

    def monotonic(self) -> float:
        """Seconds on the monotonic axis (durations, deadlines)."""
        ...

    def wall(self) -> float:
        """Seconds since the epoch (trace ``ts`` fields)."""
        ...

    def now(self) -> datetime:
        """The wall instant as an aware UTC datetime."""
        ...


class SystemClock:
    """The real clocks, undecorated."""

    __slots__ = ()

    def monotonic(self) -> float:
        return time.monotonic()

    def wall(self) -> float:
        return time.time()

    def now(self) -> datetime:
        return datetime.now(UTC)


SYSTEM_CLOCK = SystemClock()


class ManualClock:
    """A hand-cranked test clock. Starts at ``start`` and only moves when
    told to; ``wall()`` tracks ``monotonic()`` offset by ``wall_base``
    so datetime-facing consumers stay consistent with float-facing
    ones."""

    __slots__ = ("_t", "wall_base")

    def __init__(self, start: float = 0.0, *, wall_base: float = 0.0) -> None:
        self._t = float(start)
        self.wall_base = float(wall_base)

    def monotonic(self) -> float:
        return self._t

    def wall(self) -> float:
        return self.wall_base + self._t

    def now(self) -> datetime:
        return datetime.fromtimestamp(self.wall(), UTC)

    def advance(self, dt: float) -> float:
        """Move time forward by ``dt`` seconds; returns the new time."""
        if dt < 0:
            raise ValueError(f"clocks do not run backwards: advance({dt})")
        self._t += dt
        return self._t

    def set_time(self, t: float) -> None:
        """Jump to absolute monotonic time ``t`` (forward only)."""
        if t < self._t:
            raise ValueError(
                f"clocks do not run backwards: set_time({t}) < {self._t}"
            )
        self._t = float(t)


def resolve_clock(clock: Clock | None) -> Clock:
    """The constructor-side half of the seam: an injected clock wins;
    ``None`` means the system clock."""
    return clock if clock is not None else SYSTEM_CLOCK
