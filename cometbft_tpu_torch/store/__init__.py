"""Block storage (reference: store/)."""
from .store import BlockStore, BlockStoreError

__all__ = ["BlockStore", "BlockStoreError"]
