"""Key and signature interfaces.

Reference: crypto/crypto.go:23-55 — PubKey (Address/Bytes/VerifySignature/Type),
PrivKey (Bytes/Sign/PubKey/Type), BatchVerifier (Add / Verify -> (bool, []bool)),
and cometbft_tpu/crypto/keys.py:72 for ``BatchVerifier.verify_async``
and :85-104 for ``bisect_bad``.
"""
from __future__ import annotations

import abc
from typing import Sequence

from . import tmhash
from .pipeline import run_off_loop

# 20-byte address (truncated SHA-256 of the raw pubkey bytes);
# reference: crypto/crypto.go AddressHash.
ADDRESS_SIZE = tmhash.TRUNCATED_SIZE


def address_hash(b: bytes) -> bytes:
    """20-byte address: truncated SHA-256 of the raw pubkey bytes
    (reference: crypto/crypto.go AddressHash)."""
    return tmhash.sum_truncated(b)


class PubKey(abc.ABC):
    @abc.abstractmethod
    def address(self) -> bytes: ...

    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def verify_signature(self, msg: bytes, sig: bytes) -> bool: ...

    @abc.abstractmethod
    def type(self) -> str: ...

    def __eq__(self, other) -> bool:
        return isinstance(other, PubKey) and self.type() == other.type() \
            and self.bytes() == other.bytes()

    def __hash__(self) -> int:
        return hash((self.type(), self.bytes()))

    def __repr__(self) -> str:
        return f"PubKey{{{self.type()}:{self.bytes().hex().upper()[:16]}}}"


class PrivKey(abc.ABC):
    @abc.abstractmethod
    def bytes(self) -> bytes: ...

    @abc.abstractmethod
    def sign(self, msg: bytes) -> bytes: ...

    @abc.abstractmethod
    def pub_key(self) -> PubKey: ...

    @abc.abstractmethod
    def type(self) -> str: ...


class BatchVerifier(abc.ABC):
    """Accumulate (pubkey, msg, sig) triples, then verify all at once.

    Reference: crypto/crypto.go:47-55. Verify returns (all_valid, per_sig_valid).
    """

    @abc.abstractmethod
    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None: ...

    @abc.abstractmethod
    def verify(self) -> tuple[bool, Sequence[bool]]: ...

    def verify_async(self):
        """Awaitable verdict: ``verify()`` runs on the shared
        verification worker (crypto/pipeline.py), so the awaiting event
        loop never runs the batch itself.  Await it from a running
        loop."""
        return run_off_loop(self.verify)


def bisect_bad(idxs: list, mask: list, subset_holds, verify_one) -> None:
    """Batch-reject bisection (the BLS RLC verifier's): ``idxs`` is a
    subset whose batch equation already failed — split, re-check each
    half with ``subset_holds(half_idxs)`` (which MUST draw fresh
    randomizers per call, so a subset that only passed by randomizer
    collision upstream cannot keep passing down the bisection), and
    descend only into failing halves; k bad signatures cost O(k log n)
    subset checks.  A failing singleton goes straight to
    ``verify_one(i)``.  ``mask[i]`` is cleared for each bad item."""
    if len(idxs) == 1:
        i = idxs[0]
        mask[i] = verify_one(i)
        return
    mid = len(idxs) // 2
    for half in (idxs[:mid], idxs[mid:]):
        if len(half) == 1 or not subset_holds(half):
            bisect_bad(half, mask, subset_holds, verify_one)
