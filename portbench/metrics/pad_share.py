"""pad_share: the share of the lanes launched that carried no
signature: 1 - signatures / lanes over the program's ``host_prep``
spans (``batch`` and ``bucket`` attributes) in the window, in %."""


def read(run):
    trace = run.trace
    if trace is None:
        return None
    spans = trace.spans("host_prep")
    lanes = sum(s[3].get("bucket", 0) for s in spans)
    if not lanes:
        return None
    return 100.0 * (1 - sum(s[3].get("batch", 0) for s in spans) / lanes)
