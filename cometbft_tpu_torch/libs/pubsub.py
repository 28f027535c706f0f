"""Pub/sub with a query language, feeding RPC subscribers and the indexer.

Reference: libs/pubsub/pubsub.go (Server :93) + libs/pubsub/query (the
gogll-generated grammar), through cometbft_tpu/libs/pubsub.py, whose
grammar, matching rules and error texts this copy keeps.  Queries are conjunctions of conditions over
event tags:

    tm.event = 'NewBlock' AND tx.height > 5 AND account.name CONTAINS 'igor'

Operators: =, <, <=, >, >=, CONTAINS, EXISTS.  Values: single-quoted
strings, numbers, dates (treated as strings here).  Tags are multi-valued
(one event key can carry several values, e.g. several tx senders).
"""
from __future__ import annotations

import asyncio
import re
from datetime import datetime, timezone
from dataclasses import dataclass, field
from typing import Any, Callable, Optional

# "<date>T<time>.<frac><tz-or-nothing>" — fraction capped to
# microseconds for python 3.10's fromisoformat
_FRAC_RE = re.compile(r"^([^.]+)\.(\d+)(.*)$")


class PubSubError(Exception):
    pass


class QueryError(PubSubError):
    pass


def _tokenize(s: str) -> list[tuple[str, str]]:
    """Tokens: ("str", text) for 'quoted' literals (escapes honoured,
    may contain AND/spaces), ("op", =|<|<=|>|>=), ("word", text) for
    keys, AND, CONTAINS, EXISTS, DATE, TIME and bare values."""
    tokens: list[tuple[str, str]] = []
    i, n = 0, len(s)
    while i < n:
        c = s[i]
        if c.isspace():
            i += 1
            continue
        if c == "'":
            j, buf = i + 1, []
            while j < n and s[j] != "'":
                if s[j] == "\\" and j + 1 < n:
                    buf.append(s[j + 1])
                    j += 2
                else:
                    buf.append(s[j])
                    j += 1
            if j >= n:
                raise QueryError(f"unterminated string in {s!r}")
            tokens.append(("str", "".join(buf)))
            i = j + 1
            continue
        if c in "<>=":
            if s[i:i + 2] in ("<=", ">="):
                tokens.append(("op", s[i:i + 2]))
                i += 2
            else:
                tokens.append(("op", c))
                i += 1
            continue
        j = i
        while j < n and not s[j].isspace() and s[j] not in "<>='":
            j += 1
        tokens.append(("word", s[i:j]))
        i = j
    return tokens


def _parse_time_like(raw: str):
    """RFC3339 timestamp or yyyy-mm-dd date → aware datetime, else
    None (reference: query grammar TIME/DATE literals)."""
    txt = raw.strip()
    if txt.endswith("Z"):
        txt = txt[:-1] + "+00:00"
    # python < 3.11 fromisoformat accepts only 3- or 6-digit
    # fractional seconds; RFC3339 emitters produce 1-9 digits (a
    # nanosecond field with trailing zeros trimmed) — normalize to 6
    m = _FRAC_RE.match(txt)
    if m:
        txt = f"{m.group(1)}.{(m.group(2) + '000000')[:6]}{m.group(3)}"
    try:
        dt = datetime.fromisoformat(txt)
    except ValueError:
        return None
    if dt.tzinfo is None:
        dt = dt.replace(tzinfo=timezone.utc)
    return dt


def _parse_value(raw: str):
    if raw.startswith("'") and raw.endswith("'"):
        return raw[1:-1]
    try:
        return int(raw)
    except ValueError:
        pass
    try:
        return float(raw)
    except ValueError:
        pass
    return raw


def _as_number(v) -> Optional[float]:
    if isinstance(v, (int, float)):
        return float(v)
    try:
        return float(v)
    except (TypeError, ValueError):
        return None


@dataclass(frozen=True)
class Condition:
    key: str
    op: str
    value: Any = None

    def matches_value(self, ev_val: str) -> bool:
        op = self.op
        if op == "EXISTS":
            return True
        if op == "CONTAINS":
            return str(self.value) in ev_val
        if isinstance(self.value, datetime):
            # DATE/TIME literal: the event value must parse as a
            # timestamp too
            t = _parse_time_like(ev_val)
            if t is None:
                return False
            v = self.value
            return {"=": t == v, "<": t < v, "<=": t <= v,
                    ">": t > v, ">=": t >= v}[op]
        if op == "=":
            n, m = _as_number(self.value), _as_number(ev_val)
            if n is not None and m is not None:
                return n == m
            return str(self.value) == ev_val
        n, m = _as_number(self.value), _as_number(ev_val)
        if n is None or m is None:
            # fall back to lexicographic comparison for strings
            a, b = ev_val, str(self.value)
            return {"<": a < b, "<=": a <= b,
                    ">": a > b, ">=": a >= b}[op]
        return {"<": m < n, "<=": m <= n, ">": m > n, ">=": m >= n}[op]


class Query:
    """Conjunction of conditions; matches event tag maps."""

    def __init__(self, query_str: str):
        self.query_str = query_str.strip()
        self.conditions: list[Condition] = []
        if not self.query_str:
            return
        toks = _tokenize(self.query_str)
        i = 0
        while i < len(toks):
            kind, key = toks[i]
            if kind != "word":
                raise QueryError(
                    f"expected key, got {key!r} in {query_str!r}")
            i += 1
            if i >= len(toks):
                raise QueryError(f"missing operator in {query_str!r}")
            kind, op = toks[i]
            op_up = op.upper()
            i += 1
            if kind == "word" and op_up == "EXISTS":
                self.conditions.append(Condition(key, "EXISTS"))
            elif kind == "op" or (kind == "word" and
                                  op_up == "CONTAINS"):
                if i >= len(toks):
                    raise QueryError(f"missing value in {query_str!r}")
                vkind, vtext = toks[i]
                i += 1
                if vkind == "str":
                    value: Any = vtext
                elif vtext.upper() in ("DATE", "TIME"):
                    # DATE yyyy-mm-dd / TIME RFC3339 literal
                    if i >= len(toks):
                        raise QueryError(
                            f"missing {vtext} literal in {query_str!r}")
                    _, raw = toks[i]
                    i += 1
                    value = _parse_time_like(raw)
                    if value is None:
                        raise QueryError(
                            f"bad {vtext} literal {raw!r}")
                else:
                    value = _parse_value(vtext)
                self.conditions.append(
                    Condition(key, "CONTAINS" if op_up == "CONTAINS"
                              else op, value))
            else:
                raise QueryError(
                    f"expected operator, got {op!r} in {query_str!r}")
            if i < len(toks):
                kind, word = toks[i]
                if kind != "word" or word.upper() != "AND":
                    raise QueryError(
                        f"expected AND, got {word!r} in {query_str!r}")
                i += 1
                if i >= len(toks):
                    raise QueryError(
                        f"dangling AND in {query_str!r}")

    def matches(self, events: dict[str, list[str]]) -> bool:
        """events: composite key ("type.attr") → list of values."""
        for cond in self.conditions:
            vals = events.get(cond.key)
            if not vals:
                return False
            if not any(cond.matches_value(v) for v in vals):
                return False
        return True

    def __str__(self) -> str:
        return self.query_str

    def __eq__(self, other) -> bool:
        return isinstance(other, Query) and \
            self.query_str == other.query_str

    def __hash__(self) -> int:
        return hash(self.query_str)


EMPTY_QUERY = Query("")


@dataclass
class Message:
    data: Any
    events: dict[str, list[str]] = field(default_factory=dict)


_CANCEL_SENTINEL = object()


class Subscription:
    """A subscriber's message stream (reference: pubsub.Subscription;
    its Canceled channel wakes blocked readers — here a sentinel message
    does)."""

    def __init__(self, out_capacity: int = 100):
        # +1 slot so the cancel sentinel always fits
        self._queue: asyncio.Queue = asyncio.Queue(out_capacity + 1)
        self._capacity = out_capacity
        self._canceled: Optional[str] = None

    @property
    def canceled(self) -> Optional[str]:
        return self._canceled

    def cancel(self, reason: str) -> None:
        if self._canceled is None:
            self._canceled = reason
            # wake any reader blocked in next()
            self._queue.put_nowait(_CANCEL_SENTINEL)

    async def next(self) -> Message:
        if self._canceled:
            raise PubSubError(f"subscription canceled: {self._canceled}")
        msg = await self._queue.get()
        if msg is _CANCEL_SENTINEL:
            raise PubSubError(f"subscription canceled: {self._canceled}")
        return msg

    def try_put(self, msg: Message) -> bool:
        if self._canceled or self._queue.qsize() >= self._capacity:
            return False
        self._queue.put_nowait(msg)
        return True


class Server:
    """In-process pub/sub server (reference: pubsub.Server :93).

    Subscriptions are keyed by (subscriber, query).  Publishing is
    synchronous fan-out; a full subscriber queue cancels that
    subscription (the reference's non-buffered semantics surface
    slow-subscriber errors the same way).
    """

    def __init__(self):
        self._subs: dict[tuple[str, str], tuple[Query, Subscription]] = {}

    def subscribe(self, subscriber: str, query: Query | str,
                  out_capacity: int = 100) -> Subscription:
        if isinstance(query, str):
            query = Query(query)
        key = (subscriber, query.query_str)
        if key in self._subs:
            raise PubSubError("already subscribed")
        sub = Subscription(out_capacity)
        self._subs[key] = (query, sub)
        return sub

    def unsubscribe(self, subscriber: str, query: Query | str) -> None:
        qs = query.query_str if isinstance(query, Query) else \
            Query(query).query_str
        key = (subscriber, qs)
        if key not in self._subs:
            raise PubSubError("subscription not found")
        _, sub = self._subs.pop(key)
        sub.cancel("unsubscribed")

    def unsubscribe_all(self, subscriber: str) -> None:
        keys = [k for k in self._subs if k[0] == subscriber]
        if not keys:
            raise PubSubError("subscription not found")
        for k in keys:
            _, sub = self._subs.pop(k)
            sub.cancel("unsubscribed")

    def num_clients(self) -> int:
        return len({k[0] for k in self._subs})

    def num_client_subscriptions(self, subscriber: str) -> int:
        return sum(1 for k in self._subs if k[0] == subscriber)

    def publish(self, data: Any,
                events: Optional[dict[str, list[str]]] = None) -> None:
        events = events or {}
        msg = Message(data, events)
        dead = []
        for key, (query, sub) in self._subs.items():
            if query.matches(events):
                if not sub.try_put(msg):
                    sub.cancel("out of capacity")
                    dead.append(key)
        for key in dead:
            self._subs.pop(key, None)
