"""Versioned, merkle-committed key-value state tree: its per-version
root is the kvstore's app hash."""
from .tree import StateTree

__all__ = ["StateTree"]
