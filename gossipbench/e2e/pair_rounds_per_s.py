"""``pair_rounds_per_s``: (node, owner) pairs that the window's rounds
carry, a second: the nodes squared times every lane-round of the window
over the window's wall time (host clock, the window ending in a device
sync). One scale for cells of any size; a device-bound cell's rate, held
to a bound near its own spread."""


def value(window):
    lane_rounds = sum(s.ticks * s.lanes for s in window.studies)
    if not lane_rounds or window.window_s <= 0:
        return None
    return window.nodes**2 * lane_rounds / window.window_s
