"""``study_ms_p95``: the 95th percentile (nearest rank) over every study of
the window of one study's wall time, from its simulator's construction to
``run_until_converged`` returning, in ms (host clock; the answer is read
back, so the device has finished)."""

import math


def value(window):
    times = sorted(s.wall_s * 1e3 for s in window.studies)
    if not times:
        return None
    return times[max(0, math.ceil(0.95 * len(times)) - 1)]
