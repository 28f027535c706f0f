"""What a traced run reads: the harness's span around each call, the
program's own spans inside it, and the device's activity from
``torch.profiler``, all on the host's monotonic clock.

The profiler stamps events in Unix nanoseconds; ``clock_offset`` pairs
the two clocks at the window's open and close, and the events are moved
by the mean of the two offsets.  ``aligned_share`` says how many B1
launches then fall inside a call, as a check of that move.

Metric readers (``metrics/<name>.py``) take a ``Run``; a traced run's
``trace`` is a ``Trace``.
"""
from __future__ import annotations

import re
import time
from dataclasses import dataclass, field

B1_KERNEL = "ed25519_verify_kernel"
BREAKDOWN_ENTRIES = 10


@dataclass
class Call:
    """One call of the window: its host-clock span and the program's
    spans that lie inside it, as (name, start_ns, end_ns, attrs)."""
    t0: int
    t1: int
    spans: list = field(default_factory=list)

    def total(self, name: str) -> int:
        return sum(s[2] - s[1] for s in self.spans if s[0] == name)


@dataclass
class Run:
    """One run as the metric readers see it."""
    starts: list            # each call's start, monotonic ns
    ends: list              # and its end
    window_s: float         # from the window's open to its last call's end
    setup_s: float
    trace: "Trace | None"   # a traced run's reading


@dataclass
class Trace:
    calls: list             # [Call, ...]
    device: list            # [(name, start_ns, end_ns), ...], monotonic
    window: tuple           # (open_ns, close_ns)

    def spans(self, name: str):
        return [s for c in self.calls for s in c.spans if s[0] == name]

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def busy_intervals(self) -> list:
        """The union of device activity inside the window."""
        lo, hi = self.window
        out = []
        for s0, s1 in sorted((max(a, lo), min(b, hi))
                             for _, a, b in self.device):
            if s1 <= s0:
                continue
            if out and s0 <= out[-1][1]:
                out[-1][1] = max(out[-1][1], s1)
            else:
                out.append([s0, s1])
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_ns(self, name: str) -> int:
        return sum(b - a for n, a, b in self.device if name in n)

    def aligned_share(self) -> float | None:
        """The share of B1 launches that start inside a call."""
        starts = sorted(a for n, a, _ in self.device if B1_KERNEL in n)
        if not starts:
            return None
        inside, i = 0, 0
        for c in self.calls:
            while i < len(starts) and starts[i] < c.t0:
                i += 1
            while i < len(starts) and starts[i] <= c.t1:
                inside += 1
                i += 1
        return inside / len(starts)

    def device_ops(self) -> list:
        """[[name, seconds], ...]: the device operations that took most
        time, longest first."""
        by_name: dict = {}
        for n, a, b in self.device:
            key = _short(n)
            by_name[key] = by_name.get(key, 0) + (b - a)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])
        return [[n, ns / 1e9] for n, ns in top[:BREAKDOWN_ENTRIES]]

    def idle_gaps(self) -> list:
        """[[label, seconds], ...]: the device's idle time in the window
        by what the host was doing, most first.  The label is the
        innermost span open at the time: a program span by its name,
        ``walk`` inside a call but outside every program span, and
        ``harness`` outside every call."""
        events = []
        intervals = [(c.t0, c.t1, "walk") for c in self.calls] + \
            [(s[1], s[2], s[0]) for c in self.calls for s in c.spans]
        intervals.sort(key=lambda iv: (iv[0], -iv[1]))
        stack: list = []
        for t0, t1, label in intervals:
            while stack and stack[-1] <= t0:
                stack.pop()
            depth = len(stack)
            stack.append(t1)
            events.append((t0, 1, depth, label))
            events.append((t1, 0, depth, label))
        for a, b in self.busy_intervals():
            events.append((a, 3, 0, None))
            events.append((b, 2, 0, None))
        lo, hi = self.window
        events.append((hi, 4, 0, None))       # closes the last gap
        events.sort(key=lambda e: (e[0], e[1]))
        active: dict = {}
        busy = False
        prev = lo
        gaps: dict = {}
        for t, kind, depth, label in events:
            t = min(max(t, lo), hi)
            if t > prev and not busy:
                where = active[max(active)] if active else "harness"
                gaps[where] = gaps.get(where, 0) + (t - prev)
            prev = max(prev, t)
            if kind == 1:
                active[depth] = label
            elif kind == 0:
                active.pop(depth, None)
            else:
                busy = kind == 3
        top = sorted(gaps.items(), key=lambda kv: -kv[1])
        return [[n, ns / 1e9] for n, ns in top[:BREAKDOWN_ENTRIES]]


def _short(name: str) -> str:
    return re.sub(r"[^A-Za-z0-9_.-]", "_", name)[:64]


def clock_offset() -> int:
    """Unix ns minus monotonic ns, now."""
    a = time.monotonic_ns()
    w = time.time_ns()
    b = time.monotonic_ns()
    return w - (a + b) // 2


def device_events(prof, offset_ns: int) -> list:
    """[(name, start_ns, end_ns), ...] of every device event the
    profiler saw, moved onto the monotonic clock."""
    from torch.autograd import DeviceType
    out = []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() != DeviceType.CUDA:
            continue
        out.append((e.name(), e.start_ns() - offset_ns,
                    e.end_ns() - offset_ns))
    return out


def assign(calls: list, spans: list) -> None:
    """Put each program span (a tracing snapshot's event) into the call
    whose span holds it."""
    spans = sorted(spans, key=lambda e: e["ts_ns"])
    i = 0
    for c in calls:
        while i < len(spans) and spans[i]["ts_ns"] < c.t0:
            i += 1
        while i < len(spans) and spans[i]["ts_ns"] <= c.t1:
            e = spans[i]
            c.spans.append((e["name"], e["ts_ns"],
                            e["ts_ns"] + e["dur_ns"], e.get("attrs") or {}))
            i += 1
