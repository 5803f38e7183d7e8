"""``study_init_ms`` (State), ms: the mean over the traced slice's studies
of the harness's span around each simulator's construction (the state
made on the card from the seed), host clock ending in a device sync."""


def read(trace):
    init = trace.info["init_ms"]
    return sum(init) / len(init) if init else None
