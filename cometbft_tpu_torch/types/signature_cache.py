"""Signature cache: skip re-verification of identical (sig, addr, msg).

Reference: types/signature_cache.go — map sig → (valAddr, signBytes),
shared across light-client adjacent/non-adjacent checks.  LRU-bounded
as in cometbft_tpu/types/signature_cache.py, whose hit/miss/eviction
counters (:25-40) it keeps twice: on the cache, and summed over every
cache on the process-global registry (``light_signature_cache_*``).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

from ..libs import metrics as libmetrics

DEFAULT_CAPACITY = 10_000

_HITS = libmetrics.DEFAULT.counter(
    "light", "signature_cache_hits",
    "Signature-cache hits across commit verifications.")
_MISSES = libmetrics.DEFAULT.counter(
    "light", "signature_cache_misses", "Signature-cache misses.")
_EVICTIONS = libmetrics.DEFAULT.counter(
    "light", "signature_cache_evictions",
    "Entries evicted by the signature-cache LRU cap.")


def set_default_capacity(n: int) -> None:
    """The capacity of caches made without one from now on (the node
    sets it from ``base.signature_cache_size``); n <= 0 is ignored."""
    global DEFAULT_CAPACITY
    if n > 0:
        DEFAULT_CAPACITY = n


class SignatureCacheValue(NamedTuple):
    validator_address: bytes
    vote_sign_bytes: bytes


class SignatureCache:
    def __init__(self, capacity: int = 0):
        self.capacity = capacity if capacity > 0 else DEFAULT_CAPACITY
        self._m: OrderedDict[bytes, SignatureCacheValue] = OrderedDict()
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    def get(self, sig: bytes) -> Optional[SignatureCacheValue]:
        v = self._m.get(sig)
        if v is not None:
            self._m.move_to_end(sig)
            self.hits += 1
            _HITS.add()
        else:
            self.misses += 1
            _MISSES.add()
        return v

    def add(self, sig: bytes, value: SignatureCacheValue) -> None:
        if sig in self._m:
            self._m.move_to_end(sig)
        self._m[sig] = value
        if len(self._m) > self.capacity:
            self._m.popitem(last=False)
            self.evictions += 1
            _EVICTIONS.add()

    def __len__(self) -> int:
        return len(self._m)
