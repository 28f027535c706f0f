"""Canonical time representation.

The reference signs google.protobuf.Timestamp values derived from Go
time.Time (UTC, no monotonic component — types/canonical.go CanonicalTime).
Go's zero time is year 1, which encodes as seconds = -62135596800 — a
consensus-visible constant pinned by the reference's sign-bytes test
vectors.
"""
from __future__ import annotations

import time as _time
from typing import NamedTuple

# Go time.Time{} (0001-01-01T00:00:00Z) as Unix seconds.
_GO_ZERO_SECONDS = -62135596800


class Timestamp(NamedTuple):
    seconds: int
    nanos: int

    @classmethod
    def zero(cls) -> "Timestamp":
        return cls(_GO_ZERO_SECONDS, 0)

    def is_zero(self) -> bool:
        return self.seconds == _GO_ZERO_SECONDS and self.nanos == 0

    @classmethod
    def now(cls) -> "Timestamp":
        return cls.from_unix_ns(_time.time_ns())

    @classmethod
    def from_unix_ns(cls, ns: int) -> "Timestamp":
        return cls(ns // 1_000_000_000, ns % 1_000_000_000)

    def unix_ns(self) -> int:
        return self.seconds * 1_000_000_000 + self.nanos

    def add_ns(self, ns: int) -> "Timestamp":
        return Timestamp.from_unix_ns(self.unix_ns() + ns)

    def sub(self, other: "Timestamp") -> int:
        """Difference in nanoseconds."""
        return self.unix_ns() - other.unix_ns()

    def to_proto(self) -> dict:
        d: dict = {}
        if self.seconds:
            d["seconds"] = self.seconds
        if self.nanos:
            d["nanos"] = self.nanos
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "Timestamp":
        return cls(d.get("seconds", 0), d.get("nanos", 0))
