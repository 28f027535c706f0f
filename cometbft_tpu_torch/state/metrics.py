"""State/execution metrics (reference: state/metrics.gen.go), the
families of cometbft_tpu/state/metrics.py on the port's libs/metrics."""
from __future__ import annotations

from typing import Optional

from ..libs import metrics as libmetrics


class Metrics:
    def __init__(self, registry: Optional[libmetrics.Registry] = None):
        m = registry if registry is not None else libmetrics.Registry()
        self.consensus_param_updates = m.counter(
            "state", "consensus_param_updates",
            "Number of consensus parameter updates returned by the "
            "application since process start.")
        self.validator_set_updates = m.counter(
            "state", "validator_set_updates",
            "Number of validator set updates returned by the "
            "application since process start.")
