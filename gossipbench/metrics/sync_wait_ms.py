"""``sync_wait_ms`` (Driver): host ms a round inside the program's
``aiocluster_torch.sync`` ranges (each blocking device-to-host read of a
study: the construction's reads, the chunk's converged flag,
``metrics()``, ``tick``, the flush's transfer), over the rounds of the
traced slice: the time the host waits on the card."""

SYNC = "aiocluster_torch.sync"


def read(trace):
    if not trace.ranges(SYNC) or not trace.info["rounds"]:
        return None
    return trace.host_ms(SYNC) / trace.info["rounds"]
