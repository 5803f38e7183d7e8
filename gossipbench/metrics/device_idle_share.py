"""``device_idle_share`` (Device), %: the share of the traced slice in
which no kernel, copy or set ran on the card (1 minus the union of the
device's intervals over the slice's length)."""


def read(trace):
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s() / trace.window_s)
