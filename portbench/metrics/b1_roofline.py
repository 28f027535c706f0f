"""b1_roofline: the least time the card needs for the signatures the
window verified (``yardstick.least_seconds``, a fixed count of work a
signature) over B1's device time from the profiler, in %.  Signatures
are the ``batch`` attributes of the program's ``host_prep`` spans;
padding lanes are not work."""
from portbench import trace as tr
from portbench import yardstick


def read(run):
    trace = run.trace
    if trace is None:
        return None
    kernel_ns = trace.kernel_ns(tr.B1_KERNEL)
    sigs = sum(s[3].get("batch", 0) for s in trace.spans("host_prep"))
    if not kernel_ns or not sigs:
        return None
    return 100.0 * yardstick.least_seconds(sigs) / (kernel_ns / 1e9)
