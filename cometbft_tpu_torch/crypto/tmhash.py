"""The 20-byte truncated SHA-256 used for addresses.

Reference: crypto/tmhash/hash.go — SumTruncated.
"""
import hashlib

TRUNCATED_SIZE = 20


def sum_truncated(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()[:TRUNCATED_SIZE]
