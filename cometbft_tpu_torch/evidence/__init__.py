"""Evidence: the pool, the verification and the gossip of validator
misbehaviour."""
from .pool import EvidenceError, EvidencePool
from .reactor import EvidenceReactor

__all__ = ["EvidencePool", "EvidenceError", "EvidenceReactor"]
