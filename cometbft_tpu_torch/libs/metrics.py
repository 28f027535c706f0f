"""Prometheus-style metrics: registry and text exposition.

Reference: cometbft_tpu/libs/metrics.py (:84-418), trimmed to what the
port registers: counters, gauges and cumulative histograms, each with
optional labels, rendered in the Prometheus text format with the same
escaping, and one process-global registry, ``DEFAULT``, that the
verification path records into (it has no node to hand it a registry).
Family names and help strings are the reference's, so the rendered text
reads the same.  Not kept: exemplars, the label-cardinality ceiling
(the port's label values come from a closed set) and ``collect``;
``render_merged`` renders the text format only.
"""
from __future__ import annotations

import threading
from typing import Sequence


def _escape_label_value(v: str) -> str:
    return v.replace("\\", "\\\\").replace('"', '\\"').replace("\n", "\\n")


def _escape_help(h: str) -> str:
    return h.replace("\\", "\\\\").replace("\n", "\\n")


def _fmt_labels(names: Sequence[str], values: Sequence[str]) -> str:
    if not names:
        return ""
    inner = ",".join(f'{n}="{_escape_label_value(v)}"'
                     for n, v in zip(names, values))
    return "{" + inner + "}"


def _fmt_value(v: float) -> str:
    if v == int(v) and abs(v) < 1e15:
        return str(int(v))
    return repr(v)


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str,
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self._children: dict[tuple, "_Metric"] = {}
        self._lock = threading.Lock()

    def with_labels(self, *values):
        """The child series for these label values (made on first use)."""
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"values, got {len(values)}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                child = self._children[key] = self._new_child()
            return child

    def _new_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _own_samples(self, labels: str):
        raise NotImplementedError

    def _samples(self):  # -> list[(suffix, labels, value)]
        if not self.label_names:
            return self._own_samples("")
        with self._lock:
            children = sorted(self._children.items())
        out = []
        for key, child in children:
            out.extend(child._own_samples(_fmt_labels(self.label_names,
                                                      key)))
        return out

    def render(self) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for suffix, labels, value in self._samples():
            lines.append(f"{self.name}{suffix}{labels} {_fmt_value(value)}")
        return "\n".join(lines)


class Counter(_Metric):
    kind = "counter"

    def __init__(self, name: str, help_: str,
                 label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        self._value = 0.0

    def _new_child(self):
        return Counter(self.name, self.help)

    def add(self, v: float = 1.0) -> None:
        if v < 0:
            raise ValueError("counters only go up")
        self._value += v

    inc = add

    @property
    def value(self) -> float:
        return self._value

    def _own_samples(self, labels):
        return [("", labels, self._value)]


class Gauge(_Metric):
    kind = "gauge"

    def __init__(self, name: str, help_: str,
                 label_names: Sequence[str] = ()):
        super().__init__(name, help_, label_names)
        self._value = 0.0

    def _new_child(self):
        return Gauge(self.name, self.help)

    def set(self, v: float) -> None:
        self._value = float(v)

    def add(self, v: float = 1.0) -> None:
        self._value += v

    def sub(self, v: float = 1.0) -> None:
        self._value -= v

    @property
    def value(self) -> float:
        return self._value

    def _own_samples(self, labels):
        return [("", labels, self._value)]


_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                    5.0, 10.0)


class Histogram(_Metric):
    """Prometheus-correct cumulative histogram: ``observe`` feeds
    ``_bucket``/``_sum``/``_count``."""

    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0

    def _new_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, v: float) -> None:
        with self._lock:
            self._sum += v
            self._count += 1
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1

    @property
    def count(self) -> int:
        return self._count

    @property
    def sum(self) -> float:
        return self._sum

    def quantile(self, q: float) -> float:
        """Estimate the q-quantile (0 < q <= 1) by linear interpolation
        over the cumulative bucket counts, as Prometheus'
        histogram_quantile() would.  0.0 with no samples; past the last
        finite bucket it returns that bound (a floor, not a value)."""
        if self._count == 0:
            return 0.0
        rank = q * self._count
        prev_bound, prev_cum = 0.0, 0
        for i, b in enumerate(self.buckets):
            cum = self._counts[i]
            if cum >= rank:
                width = cum - prev_cum
                if width <= 0:
                    return b
                return prev_bound + (b - prev_bound) * \
                    (rank - prev_cum) / width
            prev_bound, prev_cum = b, cum
        return self.buckets[-1] if self.buckets else 0.0

    def _own_samples(self, labels):
        out = []
        for i, b in enumerate(self.buckets):
            le = f'le="{_fmt_value(b)}"'
            lab = labels[:-1] + f",{le}}}" if labels else f"{{{le}}}"
            out.append(("_bucket", lab, self._counts[i]))
        inf = labels[:-1] + ',le="+Inf"}' if labels else '{le="+Inf"}'
        out.append(("_bucket", inf, self._count))
        out.append(("_sum", labels, self._sum))
        out.append(("_count", labels, self._count))
        return out


class Registry:
    def __init__(self, namespace: str = "cometbft"):
        self.namespace = namespace
        self._metrics: dict[str, _Metric] = {}
        self._lock = threading.Lock()

    def _register(self, m: _Metric) -> _Metric:
        with self._lock:
            return self._metrics.setdefault(m.name, m)

    def counter(self, subsystem: str, name: str, help_: str = "",
                labels: Sequence[str] = ()) -> Counter:
        return self._register(Counter(
            f"{self.namespace}_{subsystem}_{name}", help_, labels))

    def gauge(self, subsystem: str, name: str, help_: str = "",
              labels: Sequence[str] = ()) -> Gauge:
        return self._register(Gauge(
            f"{self.namespace}_{subsystem}_{name}", help_, labels))

    def histogram(self, subsystem: str, name: str, help_: str = "",
                  labels: Sequence[str] = (),
                  buckets: Sequence[float] = _DEFAULT_BUCKETS
                  ) -> Histogram:
        return self._register(Histogram(
            f"{self.namespace}_{subsystem}_{name}", help_, labels,
            buckets))

    def families(self) -> list[_Metric]:
        with self._lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def render(self) -> str:
        return "\n".join(m.render() for m in self.families()) + "\n"


def render_merged(*registries: Registry) -> str:
    """One exposition page over several registries (node registry first,
    then the process-global DEFAULT); a family name already emitted is
    skipped so the page never carries duplicate TYPE lines."""
    seen: set[str] = set()
    out: list[str] = []
    for reg in registries:
        if reg is None:
            continue
        for m in reg.families():
            if m.name in seen:
                continue
            seen.add(m.name)
            out.append(m.render())
    return "\n".join(out) + "\n"


# The process-global registry that the verification path records into.
DEFAULT = Registry()
