"""``init_device_ms`` (State): device ms a study of what is launched
inside the program's ``aiocluster_torch.init_state`` ranges (the state
each study builds on the card), by the launches' correlation ids, over
the studies of the traced slice."""

INIT = "aiocluster_torch.init_state"


def read(trace):
    if not trace.device or not trace.ranges(INIT) or not trace.info["studies"]:
        return None
    return trace.device_ms(trace.launched_in([INIT])) / trace.info["studies"]
