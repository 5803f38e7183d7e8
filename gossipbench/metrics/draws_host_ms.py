"""``draws_host_ms`` (Draws): host ms a round inside the program's
``aiocluster_torch.draws`` ranges (``prng.chunk_draws``, once a chunk),
over the rounds of the traced slice."""

DRAWS = "aiocluster_torch.draws"


def read(trace):
    if not trace.ranges(DRAWS) or not trace.info["rounds"]:
        return None
    return trace.host_ms(DRAWS) / trace.info["rounds"]
