"""seam_ms: per call, the program's ``batch_verify`` span less the
``host_prep`` and ``kernel_execute`` spans inside it (the batch seam and
the tile loop's dispatch: the copies, the launch, the mask), averaged
over the window's calls, in ms."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    calls = [c for c in trace.calls if c.total("batch_verify")]
    if not calls:
        return None
    return sum(c.total("batch_verify") - c.total("host_prep") -
               c.total("kernel_execute") for c in calls) / len(calls) / 1e6
