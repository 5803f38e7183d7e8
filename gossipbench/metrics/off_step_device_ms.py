"""``off_step_device_ms`` (Metrics), ms a round: device time of the work
launched neither inside an ``aiocluster_torch.sim_step`` range nor inside
an ``aiocluster_torch.draws`` range (by the launches' correlation ids):
the telemetry sampler's passes, the flag reads, each study's state."""

OWNED = ("aiocluster_torch.sim_step", "aiocluster_torch.draws")


def read(trace):
    if not trace.device or not trace.info["rounds"]:
        return None
    return trace.device_ms(exclude=trace.launched_in(OWNED)) / trace.info["rounds"]
