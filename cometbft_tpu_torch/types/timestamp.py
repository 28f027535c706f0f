"""Canonical time representation.

The reference signs google.protobuf.Timestamp values derived from Go
time.Time (UTC, no monotonic component — types/canonical.go CanonicalTime).
Go's zero time is year 1, which encodes as seconds = -62135596800 — a
consensus-visible constant pinned by the reference's sign-bytes test
vectors.
"""
from __future__ import annotations

import time as _time
from datetime import datetime, timezone
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

    def rfc3339(self) -> str:
        dt = datetime.fromtimestamp(self.seconds, tz=timezone.utc)
        # not strftime: glibc renders year 1 (Go's zero time) as "1"
        base = (f"{dt.year:04d}-{dt.month:02d}-{dt.day:02d}"
                f"T{dt.hour:02d}:{dt.minute:02d}:{dt.second:02d}")
        if self.nanos:
            frac = f"{self.nanos:09d}".rstrip("0")
            return f"{base}.{frac}Z"
        return base + "Z"

    @classmethod
    def from_rfc3339(cls, s: str) -> "Timestamp":
        s = s.strip()
        if s.endswith("Z"):
            s = s[:-1] + "+00:00"
        frac_ns = 0
        if "." in s:
            head, rest = s.split(".", 1)
            i = 0
            while i < len(rest) and rest[i].isdigit():
                i += 1
            frac = rest[:i]
            frac_ns = int(frac.ljust(9, "0")[:9]) if frac else 0
            s = head + rest[i:]
        dt = datetime.fromisoformat(s)
        return cls(int(dt.timestamp()), frac_ns)


ZERO = Timestamp.zero()
