"""Traffic drivers, one file a kind of traffic, named as the ``driver``
key of a traffic mix (``traffic/<mix>.json``) names it.

A driver turns a configuration, a mix and a seed into the program's
calls, runs them and judges them.  ``run.run_cell`` asks each driver
for the same five functions:

``inputs(config, traffic, seed, pool)``
    starts making the run's inputs (``pool``, a multiprocessing pool or
    None, may do the heavy part) and returns a function that waits for
    them and returns them.
``build(inputs, traffic, device)``
    the program's objects for those inputs.
``warm(prog, traffic)``
    warm calls of the cell's own shapes; returns a dict with ``calls``
    (how many ran, so the window goes on from there) and ``note`` (one
    line for the log), and whatever else ``measure`` wants of it.
``measure(prog, seconds, seen)``
    the window: the calls back to back for ``seconds``, ``seen`` being
    what ``warm`` returned; returns ``(starts_ns, ends_ns, outcomes,
    open_ns, close_ns)`` on the monotonic clock, one entry a call.
``judge(inputs, outcomes, first, pool)``
    after the window, each call's outcome against the plain reference's:
    ``[(call index, program's verdict, reference's verdict), ...]`` for
    every call that disagrees.

A later kind of traffic adds a driver file and mixes that name it, and
edits no file that is here.
"""
