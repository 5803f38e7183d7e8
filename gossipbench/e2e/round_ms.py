"""``round_ms``: the window's wall time over every round simulated in it,
each study's construction included, in ms (host clock, the window ending
in a device sync)."""


def value(window):
    rounds = sum(s.ticks for s in window.studies)
    return window.window_s * 1e3 / rounds if rounds else None
