"""Versioned, merkle-committed key-value state tree: its per-version
root is the kvstore's app hash, so ``header.app_hash -> tree root ->
key/value`` verifies against a header the light client verified, for
present keys (existence) and absent ones (non-inclusion)."""
from .tree import StateTree
from .proof import build_proof_envelope, verify_proof_envelope

__all__ = ["StateTree", "build_proof_envelope", "verify_proof_envelope"]
