"""Fuzzed connection wrapper: byzantine-ish link-layer fault injection.

Reference: p2p/internal/fuzz/fuzz.go:131 — a conn wrapper that randomly
drops, delays, or corrupts frames, used to harden the p2p stack against
misbehaving links — through cometbft_tpu/p2p/fuzz.py, of which this is
a copy: the same seeded draws in the same order, so one seed gives the
same schedule in both packages.  Wraps the SecretConnection frame
interface (read_msg/write_msg) so it slots under MConnection through
``Switch.conn_wrapper``.
"""
from __future__ import annotations

import asyncio
import random
from dataclasses import dataclass


@dataclass
class FuzzConfig:
    """Probabilities are per-frame and independent."""
    prob_drop_write: float = 0.0      # silently discard an outgoing frame
    prob_delay: float = 0.0           # sleep before delivering
    max_delay_s: float = 0.05
    prob_corrupt_read: float = 0.0    # flip a byte in an incoming frame
    prob_reorder: float = 0.0         # deliver a frame after its successor
    prob_duplicate: float = 0.0       # deliver an outgoing frame twice
    seed: int = 0


class FuzzedConnection:
    """Wraps any object with async read_msg()/write_msg(b)/close()."""

    def __init__(self, conn, config: FuzzConfig):
        self._conn = conn
        self.config = config
        self._rng = random.Random(config.seed or None)
        self.dropped = 0
        self.delayed = 0
        self.corrupted = 0
        self.reordered = 0
        self.duplicated = 0
        self._held: bytes | None = None   # one-frame reorder window

    async def write_msg(self, data: bytes) -> None:
        # the reorder/duplicate draws are gated on their probability
        # being set, so existing seeded schedules (drop/delay/corrupt
        # only) consume the exact same RNG sequence as before
        cfg = self.config
        if self._rng.random() < cfg.prob_drop_write:
            self.dropped += 1
            return
        if self._rng.random() < cfg.prob_delay:
            self.delayed += 1
            await asyncio.sleep(self._rng.random() * cfg.max_delay_s)
        if cfg.prob_reorder and self._held is None and \
                self._rng.random() < cfg.prob_reorder:
            # hold this frame back; it ships right after the NEXT
            # frame (frame boundaries preserved, order swapped)
            self._held = data
            self.reordered += 1
            return
        await self._conn.write_msg(data)
        if cfg.prob_duplicate and \
                self._rng.random() < cfg.prob_duplicate:
            self.duplicated += 1
            await self._conn.write_msg(data)
        if self._held is not None:
            held, self._held = self._held, None
            await self._conn.write_msg(held)

    async def read_msg(self) -> bytes:
        data = await self._conn.read_msg()
        cfg = self.config
        if data and self._rng.random() < cfg.prob_corrupt_read:
            self.corrupted += 1
            i = self._rng.randrange(len(data))
            data = data[:i] + bytes([data[i] ^ 0xFF]) + data[i + 1:]
        if self._rng.random() < cfg.prob_delay:
            self.delayed += 1
            await asyncio.sleep(self._rng.random() * cfg.max_delay_s)
        return data

    def close(self) -> None:
        if self._held is not None:
            # a frame held for reorder with no successor is a drop,
            # not a reorder — keep the counters truthful
            self._held = None
            self.reordered -= 1
            self.dropped += 1
        self._conn.close()

    def __getattr__(self, name):
        return getattr(self._conn, name)
