"""Proxy (ABCI connection) metrics (reference: proxy/metrics.gen.go
method_timing_seconds).  A copy of cometbft_tpu/abci/metrics.py on the
port's libs/metrics: the same family, labels and buckets."""
from __future__ import annotations

import asyncio
import time
from typing import Optional

from ..libs import metrics as libmetrics


class Metrics:
    def __init__(self, registry: Optional[libmetrics.Registry] = None):
        m = registry if registry is not None else libmetrics.Registry()
        # metrics v2: the reference's second label slot carries the
        # named app connection the call rode (consensus / mempool /
        # query / snapshot) instead of the constant "sync" — per-call
        # ABCI latency splits by both method and connection
        self.method_timing_seconds = m.histogram(
            "proxy", "method_timing_seconds",
            "Per-call ABCI latency in seconds, by method and named "
            "app connection.",
            labels=("method", "conn"),
            buckets=(0.0001, 0.0004, 0.002, 0.009, 0.02, 0.1, 0.65,
                     2.0, 6.0, 25.0))


class _TimedConn:
    """Transparent async-method timing wrapper over an ABCI client
    connection (reference: proxy/client.go recordTiming)."""

    def __init__(self, inner, hist, conn_name: str = "sync"):
        self._inner = inner
        self._hist = hist
        self._conn_name = conn_name

    def __getattr__(self, name):
        attr = getattr(self._inner, name)
        if name.startswith("_") or not callable(attr) or \
                not asyncio.iscoroutinefunction(attr):
            return attr
        hist = self._hist
        conn_name = self._conn_name

        async def timed(*a, **kw):
            t0 = time.perf_counter()
            try:
                return await attr(*a, **kw)
            finally:
                hist.with_labels(name, conn_name).observe(
                    time.perf_counter() - t0)
        # cache so the hot path (every CheckTx) never re-enters
        # __getattr__ for this method again
        object.__setattr__(self, name, timed)
        return timed


def instrument_app_conns(app_conns, metrics: Metrics):
    """Wrap the four named connections with method timing."""
    for conn in ("consensus", "mempool", "query", "snapshot"):
        inner = getattr(app_conns, conn, None)
        if inner is not None and not isinstance(inner, _TimedConn):
            setattr(app_conns, conn,
                    _TimedConn(inner, metrics.method_timing_seconds,
                               conn))
    return app_conns
