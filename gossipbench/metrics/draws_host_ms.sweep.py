"""``draws_host_ms.sweep`` (Draws): host ms a sweep round inside the
program's ``aiocluster_torch.draws`` ranges (every lane's draws and
salts, once a chunk), over the sweep rounds of the traced slice."""

DRAWS = "aiocluster_torch.draws"


def read(trace):
    if not trace.ranges(DRAWS) or not trace.info["rounds"]:
        return None
    return trace.host_ms(DRAWS) / trace.info["rounds"]
