"""Flight recorder: spans in fixed-size per-category ring buffers.

Reference: cometbft_tpu/libs/tracing.py (:56-391), trimmed to what the
port records: monotonic-clock spans on a ``deque(maxlen=size)`` per
category, read back as one timeline.  ``span()`` of a disabled recorder
or category returns a shared inert context manager.  Instant events are
spans of zero duration.  Not kept: the consensus height stamp (the
spans carry their height as an attribute), clock anchors and crash
dumps (the port has no node yet).

Events are tuples ``(ts_ns, dur_ns, name, attrs)``; ``time.monotonic_ns``
is the only clock.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from typing import Optional

CONSENSUS = "consensus"
CRYPTO = "crypto"
P2P = "p2p"
MEMPOOL = "mempool"
ABCI = "abci"
SUPERVISOR = "supervisor"
NEMESIS = "nemesis"

CATEGORIES = (CONSENSUS, CRYPTO, P2P, MEMPOOL, ABCI, SUPERVISOR, NEMESIS)

now_ns = time.monotonic_ns


class Recorder:
    """Per-category ring buffers."""

    def __init__(self, buffer_size: int = 4096, enabled: bool = True,
                 categories: Optional[str] = None):
        self.buffer_size = max(1, int(buffer_size))
        self.enabled = enabled
        # None = every category; else the enabled set
        self.categories: Optional[frozenset] = (
            frozenset(c.strip() for c in categories.split(",")
                      if c.strip())
            if isinstance(categories, str) and categories.strip()
            else (frozenset(categories) if categories else None))
        self._rings: dict[str, deque] = {}
        self._lock = threading.Lock()

    def enabled_for(self, category: str) -> bool:
        return self.enabled and (self.categories is None or
                                 category in self.categories)

    def _ring(self, category: str) -> deque:
        ring = self._rings.get(category)
        if ring is None:
            # the lock guards ring creation only; deque.append is atomic
            with self._lock:
                ring = self._rings.setdefault(
                    category, deque(maxlen=self.buffer_size))
        return ring

    def record(self, category: str, name: str, start_ns: int, end_ns: int,
               attrs: Optional[dict]) -> None:
        self._ring(category).append(
            (start_ns, end_ns - start_ns, name, attrs))

    def snapshot(self, category: Optional[str] = None,
                 limit: int = 0) -> list[dict]:
        """Merged timeline ordered by monotonic timestamp; ``category``
        keeps one ring, ``limit`` the newest N events."""
        out = []
        for cat, ring in list(self._rings.items()):
            if category is not None and cat != category:
                continue
            for ts, dur, name, attrs in list(ring):
                ev = {"ts_ns": ts, "dur_ns": dur, "category": cat,
                      "name": name}
                if attrs:
                    ev["attrs"] = attrs
                out.append(ev)
        out.sort(key=lambda e: (e["ts_ns"], e["dur_ns"]))
        if limit > 0:
            out = out[-limit:]
        return out

    def clear(self) -> None:
        with self._lock:
            self._rings.clear()


_R = Recorder()


class _NopSpan:
    """Shared inert context manager for the disabled path."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NOP = _NopSpan()


class _Span:
    __slots__ = ("_r", "cat", "name", "attrs", "t0")

    def __init__(self, r: Recorder, cat: str, name: str,
                 attrs: Optional[dict]):
        self._r = r
        self.cat = cat
        self.name = name
        self.attrs = attrs
        self.t0 = 0

    def __enter__(self):
        self.t0 = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs = dict(self.attrs or {}, error=exc_type.__name__)
        self._r.record(self.cat, self.name, self.t0, now_ns(), self.attrs)
        return False


def span(category: str, name: str, **attrs):
    """Context manager recording a monotonic span on exit; a no-op when
    tracing or the category is disabled."""
    r = _R
    if not r.enabled_for(category):
        return _NOP
    return _Span(r, category, name, attrs or None)


def record_span(category: str, name: str, start_ns: int,
                end_ns: Optional[int] = None, **attrs) -> None:
    """Record a span whose start the caller captured."""
    r = _R
    if not r.enabled_for(category):
        return
    r.record(category, name, start_ns,
             end_ns if end_ns is not None else now_ns(), attrs or None)


def instant(category: str, name: str, **attrs) -> None:
    """Record a zero-duration point event."""
    r = _R
    if not r.enabled_for(category):
        return
    t = now_ns()
    r.record(category, name, t, t, attrs or None)


def enabled(category: str = "") -> bool:
    return _R.enabled_for(category) if category else _R.enabled


def snapshot(category: Optional[str] = None, limit: int = 0) -> list[dict]:
    return _R.snapshot(category=category, limit=limit)


def clear() -> None:
    _R.clear()


def configure(enabled: bool = True, buffer_size: int = 4096,
              categories: Optional[str] = None) -> Recorder:
    """Replace the process-global recorder (its rings are dropped)."""
    global _R
    _R = Recorder(buffer_size=buffer_size, enabled=enabled,
                  categories=categories)
    return _R
