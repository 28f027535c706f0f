"""Prometheus-style metrics: registry and text exposition.

Reference: cometbft_tpu/libs/metrics.py (:84-433): counters, gauges and
cumulative histograms, each with optional labels, rendered in the
Prometheus text format with the same escaping, and one process-global
registry, ``DEFAULT``, that the verification path records into (it has
no node to hand it a registry).  Family names and help strings are the
reference's, so the rendered text reads the same.

  * Bounded label cardinality: a family holds at most ``max_children``
    label sets (``_CHILDREN_MAX``, 2,048); past it, new label values
    share one ``overflow`` series.  The p2p and consensus families are
    labelled by peer id, which peers choose, so under churn they would
    otherwise grow without bound.
  * Histogram exemplars: every bucket keeps its latest observation with
    the flight recorder's height in progress (libs/tracing.py
    ``current_height``).  ``render(exemplars=True)`` (``GET
    /metrics?exemplars=1``) emits them in the OpenMetrics ``# {...}``
    syntax; the default render is the plain text format.
  * ``describe`` / ``series_count`` / ``Registry.collect()``: family
    descriptors; ``Timer`` observes elapsed seconds.
"""
from __future__ import annotations

import threading
import time
from typing import Optional, Sequence

from . import tracing


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


def _fmt_exemplar(ex) -> str:
    """OpenMetrics exemplar: `` # {labels} value timestamp``."""
    value, ts, labels = ex
    inner = ",".join(f'{k}="{_escape_label_value(str(v))}"'
                     for k, v in labels.items())
    return f" # {{{inner}}} {_fmt_value(value)} {ts:.3f}"


# the most label sets a family holds; past it, new label values collapse
# into one series whose every label is ``overflow``
_CHILDREN_MAX = 2048
_OVERFLOW = "overflow"


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help_: str,
                 label_names: Sequence[str] = ()):
        self.name = name
        self.help = help_
        self.label_names = tuple(label_names)
        self.max_children = _CHILDREN_MAX
        self._children: dict[tuple, "_Metric"] = {}
        self._lock = threading.Lock()

    def with_labels(self, *values):
        """The child series for these label values (made on first use;
        the shared ``overflow`` series once the family is full)."""
        if len(values) != len(self.label_names):
            raise ValueError(
                f"{self.name}: expected {len(self.label_names)} label "
                f"values, got {len(values)}")
        key = tuple(str(v) for v in values)
        with self._lock:
            child = self._children.get(key)
            if child is None:
                if len(self._children) >= self.max_children:
                    key = (_OVERFLOW,) * len(self.label_names)
                    child = self._children.get(key)
                if child is None:
                    child = self._children[key] = self._new_child()
            return child

    def _new_child(self):  # pragma: no cover - abstract
        raise NotImplementedError

    def _own_samples(self, labels: str):
        raise NotImplementedError

    def _samples(self):  # -> list[(suffix, labels, value, exemplar)]
        if not self.label_names:
            return self._own_samples("")
        with self._lock:
            children = sorted(self._children.items())
        out = []
        for key, child in children:
            out.extend(child._own_samples(_fmt_labels(self.label_names,
                                                      key)))
        return out

    def series_count(self) -> int:
        return len(self._children) if self.label_names else 1

    def describe(self) -> dict:
        """Family descriptor for ``Registry.collect()``."""
        return {"name": self.name, "kind": self.kind,
                "help": self.help, "labels": list(self.label_names),
                "series": self.series_count()}

    def render(self, exemplars: bool = False) -> str:
        lines = [f"# HELP {self.name} {_escape_help(self.help)}",
                 f"# TYPE {self.name} {self.kind}"]
        for suffix, labels, value, ex in self._samples():
            tail = _fmt_exemplar(ex) if exemplars and ex else ""
            lines.append(
                f"{self.name}{suffix}{labels} {_fmt_value(value)}{tail}")
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
        return [("", labels, self._value, None)]

    def render(self, exemplars: bool = False) -> str:
        if not exemplars:
            return super().render()
        # OpenMetrics (the exemplar page): counter samples carry the
        # _total suffix and the family name drops it
        family = self.name[:-len("_total")] \
            if self.name.endswith("_total") else self.name
        lines = [f"# HELP {family} {_escape_help(self.help)}",
                 f"# TYPE {family} counter"]
        for _suffix, labels, value, _ex in self._samples():
            lines.append(f"{family}_total{labels} {_fmt_value(value)}")
        return "\n".join(lines)


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
        return [("", labels, self._value, None)]


_DEFAULT_BUCKETS = (0.005, 0.01, 0.025, 0.05, 0.1, 0.25, 0.5, 1.0, 2.5,
                    5.0, 10.0)


class Histogram(_Metric):
    """Prometheus-correct cumulative histogram: ``observe`` feeds
    ``_bucket``/``_sum``/``_count``, and each bucket keeps its latest
    observation as an exemplar stamped with the recorder's height in
    progress, which links a scrape's outlier to ``/trace?height=H``."""

    kind = "histogram"

    def __init__(self, name: str, help_: str,
                 label_names: Sequence[str] = (),
                 buckets: Sequence[float] = _DEFAULT_BUCKETS):
        super().__init__(name, help_, label_names)
        self.buckets = tuple(sorted(buckets))
        self._counts = [0] * len(self.buckets)
        self._sum = 0.0
        self._count = 0
        # bucket index -> (value, unix seconds, labels); index
        # len(buckets) is +Inf
        self._exemplars: dict[int, tuple] = {}

    def _new_child(self):
        return Histogram(self.name, self.help, buckets=self.buckets)

    def observe(self, v: float, exemplar: Optional[dict] = None) -> None:
        if exemplar is None:
            h = tracing.recorder().current_height
            if h:
                exemplar = {"trace_height": h}
        with self._lock:
            self._sum += v
            self._count += 1
            idx = len(self.buckets)     # +Inf unless a bucket holds v
            for i, b in enumerate(self.buckets):
                if v <= b:
                    self._counts[i] += 1
                    idx = min(idx, i)
            if exemplar:
                # OpenMetrics exemplar timestamps are wall-clock metadata
                self._exemplars[idx] = (v, time.time(), exemplar)

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
            out.append(("_bucket", lab, self._counts[i],
                        self._exemplars.get(i)))
        inf = labels[:-1] + ',le="+Inf"}' if labels else '{le="+Inf"}'
        out.append(("_bucket", inf, self._count,
                    self._exemplars.get(len(self.buckets))))
        out.append(("_sum", labels, self._sum, None))
        out.append(("_count", labels, self._count, None))
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

    def collect(self) -> list[dict]:
        """Sorted family descriptors (name, kind, help, labels, series)."""
        return [m.describe() for m in self.families()]

    def render(self, exemplars: bool = False) -> str:
        return "\n".join(m.render(exemplars=exemplars)
                         for m in self.families()) + "\n"


def render_merged(*registries: Registry, exemplars: bool = False) -> str:
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
            out.append(m.render(exemplars=exemplars))
    return "\n".join(out) + "\n"


# The process-global registry that the verification path records into.
DEFAULT = Registry()


class Timer:
    """Context manager observing elapsed seconds into a Histogram."""

    def __init__(self, hist: Histogram):
        self.hist = hist

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.hist.observe(time.perf_counter() - self._t0)
        return False
