"""``round_roofline.sweep`` (Kernels), %: ``round_roofline`` for a sweep's
lanes: the lanes times one round's fused-model bytes at 3.35 TB/s, over
the device time of what is launched inside each
``aiocluster_torch.sweep_step`` range (one a sweep round)."""

from gossipbench.reference.bytes import fused_round_ms

STEP = "aiocluster_torch.sweep_step"


def read(trace):
    rounds = len(trace.ranges(STEP))
    device_ms = trace.device_ms(trace.launched_in([STEP]))
    if not rounds or device_ms <= 0:
        return None
    least = rounds * trace.info["lanes"] * fused_round_ms(trace.info["fields"])
    return 100.0 * least / device_ms
