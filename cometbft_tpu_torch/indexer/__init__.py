"""Tx and block event indexing for RPC search queries."""
from .kv import BlockIndexer, TxIndexer
from .service import IndexerService

__all__ = ["BlockIndexer", "TxIndexer", "IndexerService"]
