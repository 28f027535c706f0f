"""Metric readers, one file a metric, named as the metric.

Each defines ``read(run)`` over a ``portbench.trace.Run`` and returns
the metric's value, or None where the run holds nothing to read: the
harness then leaves the metric out of the result's line.  An end-to-end
metric reads the window's calls; a per-layer metric reads the run's
``trace``, which only a traced run has.
"""
