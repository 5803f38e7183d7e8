"""``lane_rounds_per_s``: every lane-round of the window (lanes times the
rounds of each sweep) over the window's wall time (host clock, the window
ending in a device sync)."""


def value(window):
    lane_rounds = sum(s.ticks * s.lanes for s in window.studies)
    return lane_rounds / window.window_s if window.window_s > 0 else None
