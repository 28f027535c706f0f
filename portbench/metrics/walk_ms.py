"""walk_ms: per call, the harness's span around the entry less the
program's ``batch_verify`` span inside it (the commit walk: the slot
loop, the sign bytes, the per-signature ``add`` and the tally), averaged
over the window's calls, in ms."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    calls = [c for c in trace.calls if c.total("batch_verify")]
    if not calls:
        return None
    return sum(c.t1 - c.t0 - c.total("batch_verify")
               for c in calls) / len(calls) / 1e6
