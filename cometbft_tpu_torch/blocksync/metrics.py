"""Block-sync metrics (reference: internal/blocksync/metrics.gen.go).

The port's copy of cometbft_tpu/blocksync/metrics.py, on the port's
libs/metrics.py: the same names, help texts and kinds.
"""
from __future__ import annotations

from typing import Optional

from ..libs import metrics as libmetrics


class Metrics:
    def __init__(self, registry: Optional[libmetrics.Registry] = None):
        m = registry if registry is not None else libmetrics.Registry()
        self.syncing = m.gauge(
            "blocksync", "syncing",
            "Whether or not a node is block syncing. 1 if yes, 0 if "
            "no.")
        self.num_txs = m.gauge(
            "blocksync", "num_txs",
            "Number of transactions in the latest block.")
        self.total_txs = m.counter(
            "blocksync", "total_txs",
            "Total number of transactions fast-synced.")
        self.block_size_bytes = m.gauge(
            "blocksync", "block_size_bytes",
            "Size of the latest block.")
        self.latest_block_height = m.gauge(
            "blocksync", "latest_block_height",
            "The latest block height.")
