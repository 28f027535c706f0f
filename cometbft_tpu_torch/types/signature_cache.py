"""Signature cache: skip re-verification of identical (sig, addr, msg).

Reference: types/signature_cache.go — map sig → (valAddr, signBytes),
shared across light-client adjacent/non-adjacent checks.  LRU-bounded
as in cometbft_tpu/types/signature_cache.py (the metrics counters are
not ported yet; the hit/miss/eviction counts live on the cache).
"""
from __future__ import annotations

from collections import OrderedDict
from typing import NamedTuple, Optional

DEFAULT_CAPACITY = 10_000


class SignatureCacheValue(NamedTuple):
    validator_address: bytes
    vote_sign_bytes: bytes


class SignatureCache:
    def __init__(self, capacity: int = DEFAULT_CAPACITY):
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
        else:
            self.misses += 1
        return v

    def add(self, sig: bytes, value: SignatureCacheValue) -> None:
        if sig in self._m:
            self._m.move_to_end(sig)
        self._m[sig] = value
        if len(self._m) > self.capacity:
            self._m.popitem(last=False)
            self.evictions += 1

    def __len__(self) -> int:
        return len(self._m)
