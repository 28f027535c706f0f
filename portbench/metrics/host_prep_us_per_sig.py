"""host_prep_us_per_sig: the program's ``host_prep`` spans summed over
the window, over the signatures they prepared (their ``batch``
attributes), in microseconds a signature."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    spans = trace.spans("host_prep")
    sigs = sum(s[3].get("batch", 0) for s in spans)
    if not sigs:
        return None
    return sum(s[2] - s[1] for s in spans) / sigs / 1e3
