"""``sample_device_ms`` (Metrics): device ms a round of what is launched
inside the program's ``aiocluster_torch.metrics_sample`` ranges (each
``run_until_converged``'s opening ``metrics()``, the stride samples, the
flush's closing sample), by the launches' correlation ids, over the
rounds of the traced slice."""

SAMPLE = "aiocluster_torch.metrics_sample"


def read(trace):
    if not trace.device or not trace.ranges(SAMPLE) or not trace.info["rounds"]:
        return None
    return trace.device_ms(trace.launched_in([SAMPLE])) / trace.info["rounds"]
