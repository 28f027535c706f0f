"""Flight recorder: spans in fixed-size per-category ring buffers.

Reference: cometbft_tpu/libs/tracing.py (:56-391), trimmed to what the
port records and the ``/trace`` RPC reads: monotonic-clock spans on a
``deque(maxlen=size)`` per category, read back as one timeline, each
event stamped with a height (the caller's, else the one ``set_height``
last stamped), and the recorder's node id and (monotonic, wall) clock
anchors.  ``span()`` of a disabled recorder or category returns a shared
inert context manager.  Instant events are spans of zero duration.  Not
kept: crash dumps (the port has no node yet).

Events are tuples ``(ts_ns, dur_ns, name, height, attrs)``;
``time.monotonic_ns`` is the only clock used for intervals.
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

    #: bound on the anchor list; old middle anchors are evicted but the
    #: very first is kept so drift fits retain the longest baseline
    ANCHORS_MAX = 64
    ANCHOR_INTERVAL_NS = 30 * 10**9

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
        # the trace route reports it; node/node.py stamps it
        self.node_id = ""
        # (monotonic_ns, wall_ns) pairs for cross-node alignment; wall
        # time is sampled only to pair with a monotonic reading
        self.anchors: list[tuple[int, int]] = []
        self._next_anchor_ns = 0
        self.refresh_anchor(force=True)
        # the height in progress; events recorded without one inherit it
        self.current_height = 0
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
               height: int, attrs: Optional[dict]) -> None:
        self._ring(category).append(
            (start_ns, end_ns - start_ns, name,
             height or self.current_height, attrs))
        if end_ns >= self._next_anchor_ns:
            self.refresh_anchor()

    def refresh_anchor(self, force: bool = False) -> None:
        """Sample a fresh (monotonic_ns, wall_ns) pair, at most once an
        anchor interval unless forced; driven from the record path."""
        mono = now_ns()
        if not force and mono < self._next_anchor_ns:
            return
        self._next_anchor_ns = mono + self.ANCHOR_INTERVAL_NS
        self.anchors.append((mono, time.time_ns()))
        if len(self.anchors) > self.ANCHORS_MAX:
            # keep the first (longest drift baseline) and the newest
            del self.anchors[1]

    def snapshot(self, height: Optional[int] = None,
                 category: Optional[str] = None,
                 limit: int = 0) -> list[dict]:
        """Merged timeline ordered by monotonic timestamp; ``height``
        keeps the events stamped with it, ``category`` one ring,
        ``limit`` the newest N events."""
        out = []
        for cat, ring in list(self._rings.items()):
            if category is not None and cat != category:
                continue
            for ts, dur, name, h, attrs in list(ring):
                if height is not None and h != height:
                    continue
                ev = {"ts_ns": ts, "dur_ns": dur, "category": cat,
                      "name": name, "height": h}
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
    __slots__ = ("_r", "cat", "name", "height", "attrs", "t0")

    def __init__(self, r: Recorder, cat: str, name: str, height: int,
                 attrs: Optional[dict]):
        self._r = r
        self.cat = cat
        self.name = name
        self.height = height
        self.attrs = attrs
        self.t0 = 0

    def __enter__(self):
        self.t0 = now_ns()
        return self

    def __exit__(self, exc_type, exc, tb):
        if exc_type is not None:
            self.attrs = dict(self.attrs or {}, error=exc_type.__name__)
        self._r.record(self.cat, self.name, self.t0, now_ns(), self.height,
                       self.attrs)
        return False


def span(category: str, name: str, height: int = 0, **attrs):
    """Context manager recording a monotonic span on exit; a no-op when
    tracing or the category is disabled."""
    r = _R
    if not r.enabled_for(category):
        return _NOP
    return _Span(r, category, name, height, attrs or None)


def record_span(category: str, name: str, start_ns: int,
                end_ns: Optional[int] = None, height: int = 0,
                **attrs) -> None:
    """Record a span whose start the caller captured."""
    r = _R
    if not r.enabled_for(category):
        return
    r.record(category, name, start_ns,
             end_ns if end_ns is not None else now_ns(), height,
             attrs or None)


def instant(category: str, name: str, height: int = 0, **attrs) -> None:
    """Record a zero-duration point event."""
    r = _R
    if not r.enabled_for(category):
        return
    t = now_ns()
    r.record(category, name, t, t, height, attrs or None)


def set_height(height: int) -> None:
    """Stamp the height in progress so height-less events inherit it."""
    _R.current_height = height


def enabled(category: str = "") -> bool:
    return _R.enabled_for(category) if category else _R.enabled


def snapshot(height: Optional[int] = None, category: Optional[str] = None,
             limit: int = 0) -> list[dict]:
    return _R.snapshot(height=height, category=category, limit=limit)


def clear() -> None:
    _R.clear()


def configure(enabled: bool = True, buffer_size: int = 4096,
              categories: Optional[str] = None) -> Recorder:
    """Replace the process-global recorder (its rings are dropped)."""
    global _R
    _R = Recorder(buffer_size=buffer_size, enabled=enabled,
                  categories=categories)
    return _R


def recorder() -> Recorder:
    return _R
