"""device_idle: the share of the traced window in which no operation
ran on the device (the union of the profiler's device events), in %."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    if not trace.device or trace.window_s <= 0:
        return None
    return 100.0 * (1 - trace.busy_s / trace.window_s)
