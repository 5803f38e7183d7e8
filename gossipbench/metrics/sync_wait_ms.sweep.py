"""``sync_wait_ms.sweep`` (Driver): host ms a sweep round inside the
program's ``aiocluster_torch.sync`` ranges (each blocking device-to-host
read of a sweep: the construction's reads, the lanes' flags once a
chunk, ``metrics()``, the first converged rounds), over the sweep rounds
of the traced slice: the time the host waits on the card."""

SYNC = "aiocluster_torch.sync"


def read(trace):
    if not trace.ranges(SYNC) or not trace.info["rounds"]:
        return None
    return trace.host_ms(SYNC) / trace.info["rounds"]
