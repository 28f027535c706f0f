"""commit_p95_ms: the 95th percentile of one call's host-clock latency
over every call of the window, in ms."""
from portbench import yardstick


def read(run):
    if not run.starts:
        return None
    return yardstick.p95([(b - a) / 1e6
                          for a, b in zip(run.starts, run.ends)])
