"""commit_rate: the calls the traced window completed over the window's
seconds, from its open to the end of its last call (host clock), in
commits a second.  A per-layer metric: the host's speed on the card's
machine wanders from run to run by more than an end-to-end bound of 25%
can hold (PERF.md), so the rate is read, unbounded, in the traced run."""


def read(run):
    if run.trace is None or not run.starts or run.window_s <= 0:
        return None
    return len(run.starts) / run.window_s
