"""Statesync metrics (reference: statesync/metrics.gen.go), the family of
cometbft_tpu/statesync/metrics.py on the port's libs/metrics."""
from __future__ import annotations

from typing import Optional

from ..libs import metrics as libmetrics


class Metrics:
    def __init__(self, registry: Optional[libmetrics.Registry] = None):
        m = registry if registry is not None else libmetrics.Registry()
        self.syncing = m.gauge(
            "statesync", "syncing",
            "Whether or not a node is state syncing. 1 if yes, 0 if "
            "no.")
