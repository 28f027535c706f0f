"""Liveness-plane sampling: the event-loop lag histogram.

Every reactor, the RPC server and the consensus state machine share one
event loop, so it is the scarce resource on a validator.  A sampler
sleeps for a fixed interval and observes how much later than scheduled
it actually woke (``cometbft_node_event_loop_lag_seconds``): a loop
stalled by a blocking call or a GC pause shows up within one interval.
A copy of cometbft_tpu/libs/health.py on the port's libs/metrics: the
same family, help text and buckets.

The sampler costs one timer wakeup per interval (default 250 ms — 4
observations/s).
"""
from __future__ import annotations

import asyncio

from .metrics import Histogram, Registry

# lag buckets: a healthy loop wakes within single-digit milliseconds;
# the tail that matters (blocking verify dispatch, GC, snapshot I/O)
# lives in the 10ms-2.5s range
_LAG_BUCKETS = (0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1, 0.25,
                0.5, 1.0, 2.5)


class Metrics:
    """Node-liveness metric family (subsystem ``node``)."""

    def __init__(self, registry: Registry):
        self.event_loop_lag_seconds: Histogram = registry.histogram(
            "node", "event_loop_lag_seconds",
            "Observed oversleep of a fixed-interval sampler on the "
            "node event loop: wakeup_actual - wakeup_scheduled.",
            buckets=_LAG_BUCKETS)


class LoopLagSampler:
    """Fixed-interval oversleep sampler.

    ``await asyncio.sleep(dt)`` never returns early; any extra delay is
    time the loop spent running other callbacks past their deadline."""

    def __init__(self, metrics: Metrics,
                 interval_s: float = 0.25):
        self.metrics = metrics
        self.interval_s = max(0.001, float(interval_s))

    async def run(self) -> None:
        loop = asyncio.get_running_loop()
        interval = self.interval_s
        hist = self.metrics.event_loop_lag_seconds
        last = loop.time()
        while True:
            await asyncio.sleep(interval)
            now = loop.time()
            hist.observe(max(0.0, now - last - interval))
            last = now
