"""Height-keyed RPC response cache.

The port's copy of cometbft_tpu/lightserve/cache.py.  Responses derived
from a committed block at height h below the chain tip are immutable:
the block, its commit, the light block and any multiproof over its txs
can never change (the tip can: its canonical commit may still be
replaced by a later-seen one, so the tip is never cached).  The cache is
a byte-bounded LRU over the JSON-ready response dicts the RPC handlers
build, keyed by (method, height, params), with hit, miss and eviction
counters and an entry-size histogram on the port's metrics registry
(libs/metrics.py), so operators can size ``rpc.cache_max_bytes`` from a
scrape.

Single-threaded by construction: the RPC server and every handler run
on one event loop, so no lock is needed.
"""
from __future__ import annotations

import json
from collections import OrderedDict
from typing import Optional

DEFAULT_MAX_BYTES = 32 * 1024 * 1024


class Metrics:
    """lightserve cache metric family on a metrics registry."""

    def __init__(self, registry):
        self.hits = registry.counter(
            "lightserve", "cache_hits_total",
            "RPC response cache hits (immutable height-keyed "
            "responses served from memory).")
        self.misses = registry.counter(
            "lightserve", "cache_misses_total",
            "RPC response cache misses (response built from the "
            "stores; cacheable ones are inserted).")
        self.evictions = registry.counter(
            "lightserve", "cache_evictions_total",
            "RPC response cache entries evicted to stay under "
            "rpc.cache_max_bytes.")
        self.entries = registry.gauge(
            "lightserve", "cache_entries",
            "RPC response cache resident entry count.")
        self.bytes = registry.gauge(
            "lightserve", "cache_bytes",
            "RPC response cache resident size in (approximate "
            "serialized) bytes.")
        self.entry_bytes = registry.histogram(
            "lightserve", "cache_entry_bytes",
            "Serialized size distribution of cached RPC responses.",
            buckets=(256, 1024, 4096, 16384, 65536, 262144, 1048576))


class ResponseCache:
    """Byte-bounded LRU of immutable RPC responses.

    ``get``/``put`` keys are (method, height, extra) where ``extra``
    is the hashable remainder of the request (e.g. the canonical
    indices of a multiproof).  ``put`` refuses heights at or above
    ``latest`` — only settled history is immutable — and refuses
    single entries larger than 1/8 of the budget so one giant block
    cannot flush the whole working set.
    """

    def __init__(self, max_bytes: int = DEFAULT_MAX_BYTES,
                 metrics: Optional[Metrics] = None):
        self.max_bytes = max_bytes
        self.metrics = metrics
        self._entries: OrderedDict[tuple, tuple[int, object]] = \
            OrderedDict()
        self._bytes = 0
        # plain counters mirror the metrics so in-process harnesses
        # (chip_smoke.py, tests) read stats without a scrape
        self.hits = 0
        self.misses = 0
        self.evictions = 0

    # ------------------------------------------------------------------
    def get(self, method: str, height: int, extra=()) -> Optional[object]:
        key = (method, height, extra)
        entry = self._entries.get(key)
        if entry is None:
            self.misses += 1
            if self.metrics is not None:
                self.metrics.misses.add()
            return None
        self._entries.move_to_end(key)
        self.hits += 1
        if self.metrics is not None:
            self.metrics.hits.add()
        return entry[1]

    def put(self, method: str, height: int, extra, value,
            latest_height: int) -> bool:
        """Insert iff the response is immutable (height < latest) and
        fits the budget.  Returns whether it was cached."""
        if self.max_bytes <= 0 or height >= latest_height or height < 1:
            return False
        key = (method, height, extra)
        if key in self._entries:
            return True
        try:
            size = len(json.dumps(value))
        except (TypeError, ValueError):
            return False            # non-JSON response: not ours
        if size > self.max_bytes // 8:
            return False
        self._entries[key] = (size, value)
        self._bytes += size
        if self.metrics is not None:
            self.metrics.entry_bytes.observe(size)
        while self._bytes > self.max_bytes and self._entries:
            _, (osize, _) = self._entries.popitem(last=False)
            self._bytes -= osize
            self.evictions += 1
            if self.metrics is not None:
                self.metrics.evictions.add()
        if self.metrics is not None:
            self.metrics.entries.set(len(self._entries))
            self.metrics.bytes.set(self._bytes)
        return True

    def heights(self, method: Optional[str] = None) -> set[int]:
        """Distinct heights with resident entries (optionally for one
        method).  The statetree's pruning pins these: a height the
        cache can still serve must keep its committed version so a
        follow-up prove=true query stays answerable."""
        return {h for m, h, _ in self._entries
                if method is None or m == method}

    # ------------------------------------------------------------------
    def __len__(self) -> int:
        return len(self._entries)

    @property
    def size_bytes(self) -> int:
        return self._bytes

    def stats(self) -> dict:
        total = self.hits + self.misses
        return {
            "entries": len(self._entries),
            "bytes": self._bytes,
            "hits": self.hits,
            "misses": self.misses,
            "evictions": self.evictions,
            "hit_rate": (self.hits / total) if total else 0.0,
        }

    def clear(self) -> None:
        self._entries.clear()
        self._bytes = 0
        if self.metrics is not None:
            self.metrics.entries.set(0)
            self.metrics.bytes.set(0)
