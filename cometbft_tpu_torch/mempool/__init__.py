"""Mempool: pending transactions with priority lanes, and their gossip."""
from .mempool import (
    CListMempool, Mempool, MempoolError, NopMempool, TxCache,
)

__all__ = ["CListMempool", "Mempool", "MempoolError", "NopMempool",
           "TxCache"]
