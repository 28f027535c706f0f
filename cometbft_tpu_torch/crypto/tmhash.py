"""SHA-256 and the 20-byte truncated variant used for addresses.

Reference: crypto/tmhash/hash.go — Sum (32 bytes), SumTruncated (20 bytes).
"""
import hashlib

SIZE = 32
TRUNCATED_SIZE = 20


def sum(b: bytes) -> bytes:  # noqa: A001 - mirrors reference name
    return hashlib.sha256(b).digest()


def sum_truncated(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()[:TRUNCATED_SIZE]
