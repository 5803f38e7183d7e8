"""``round_roofline`` (Kernels), %: the least time of the traced rounds'
work, the fully fused model's bytes at the H100's published 3.35 TB/s
(``reference/bytes.py``), over the device time of every operation
launched inside the program's ``aiocluster_torch.sim_step`` ranges (one a
round). The same work whatever kernel form runs it."""

from gossipbench.reference.bytes import fused_round_ms

STEP = "aiocluster_torch.sim_step"


def read(trace):
    rounds = len(trace.ranges(STEP))
    device_ms = trace.device_ms(trace.launched_in([STEP]))
    if not rounds or device_ms <= 0:
        return None
    return 100.0 * rounds * fused_round_ms(trace.info["fields"]) / device_ms
