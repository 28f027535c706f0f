"""The exposition contract of a ``/metrics`` page, for the port's tests
and chip_smoke.py's phase 23.

A copy of tests/test_metrics_contract.py's Prometheus text parser and
contract (format 0.0.4: HELP and TYPE lines for every family, histogram
buckets monotonic, ``le="+Inf"`` equal to ``_count``, label escaping),
widened to the OpenMetrics page that ``/metrics?exemplars=1`` serves:
counter samples carry the ``_total`` suffix, a bucket sample may carry
one exemplar (`` # {labels} value timestamp``), and the page ends with
``# EOF``.  Imports nothing of jax or of the JAX package: the card runs
it too.
"""


def _unescape(s: str, quotes: bool) -> str:
    out = []
    i = 0
    while i < len(s):
        c = s[i]
        if c == "\\" and i + 1 < len(s):
            nxt = s[i + 1]
            if nxt == "\\":
                out.append("\\")
                i += 2
                continue
            if nxt == "n":
                out.append("\n")
                i += 2
                continue
            if quotes and nxt == '"':
                out.append('"')
                i += 2
                continue
        out.append(c)
        i += 1
    return "".join(out)


def _parse_labels(s: str, line: str) -> tuple[dict, str]:
    """Parse '{k="v",...}rest' -> (labels, rest); raises AssertionError
    on malformed input (that IS the contract being tested)."""
    assert s[0] == "{", line
    labels = {}
    i = 1
    while True:
        if s[i] == "}":
            return labels, s[i + 1:]
        j = s.index("=", i)
        key = s[i:j]
        assert s[j + 1] == '"', f"unquoted label value: {line}"
        k = j + 2
        raw = []
        while True:
            c = s[k]
            if c == "\\":
                raw.append(s[k:k + 2])
                k += 2
                continue
            if c == '"':
                break
            assert c != "\n", f"raw newline inside label: {line}"
            raw.append(c)
            k += 1
        labels[key] = _unescape("".join(raw), quotes=True)
        i = k + 1
        if s[i] == ",":
            i += 1


def _exemplar(rest: str, line: str):
    """'value # {labels} ex_value ts' -> (labels, ex_value, ts) or
    None."""
    if " # " not in rest:
        return None
    tail = rest.split(" # ", 1)[1].strip()
    labels, after = _parse_labels(tail, line)
    parts = after.split()
    assert len(parts) == 2, f"exemplar needs a value and a timestamp: {line}"
    return labels, float(parts[0]), float(parts[1])


def parse_exposition(text: str, openmetrics: bool = False) -> dict:
    """-> {family: {"help": str, "type": str,
                    "samples": [(sample_name, labels, value)],
                    "exemplars": [(sample_name, labels, ex_labels,
                                   ex_value, ex_unix_seconds)]}}"""
    families: dict[str, dict] = {}
    lines = text.splitlines()
    if openmetrics:
        assert lines and lines[-1] == "# EOF", "OpenMetrics page without EOF"
        lines = lines[:-1]
    for line in lines:
        if not line.strip():
            continue
        if line.startswith("# HELP "):
            rest = line[len("# HELP "):]
            name, _, help_ = rest.partition(" ")
            fam = families.setdefault(
                name, {"help": "", "type": "", "samples": [],
                       "exemplars": []})
            fam["help"] = _unescape(help_, quotes=False)
            continue
        if line.startswith("# TYPE "):
            rest = line[len("# TYPE "):]
            name, _, kind = rest.partition(" ")
            assert kind in ("counter", "gauge", "histogram",
                            "summary", "untyped"), line
            assert name in families, \
                f"TYPE before HELP for {name}: {line}"
            families[name]["type"] = kind
            continue
        assert not line.startswith("#"), f"stray comment: {line}"
        # sample line: name[{labels}] value[ # exemplar]
        brace = line.find("{")
        space = line.find(" ")
        if brace != -1 and brace < space:
            sample_name = line[:brace]
            labels, rest = _parse_labels(line[brace:], line)
        else:
            sample_name = line[:space]
            labels, rest = {}, line[space:]
        rest = rest.strip()
        value_str = rest.split(" ", 1)[0]
        value = float(value_str)
        ex = _exemplar(rest, line)
        assert ex is None or openmetrics, f"exemplar on a 0.0.4 page: {line}"
        # attribute the sample to its family (histogram suffixes, and
        # the OpenMetrics counter suffix)
        fam_name = sample_name
        suffixes = {"_bucket": "histogram", "_sum": "histogram",
                    "_count": "histogram"}
        if openmetrics:
            suffixes["_total"] = "counter"
        for suffix, kind in suffixes.items():
            base = sample_name[: -len(suffix)]
            if sample_name.endswith(suffix) and base in families and \
                    families[base]["type"] == kind:
                fam_name = base
                break
        assert fam_name in families, \
            f"sample with no HELP/TYPE: {line}"
        if openmetrics and families[fam_name]["type"] == "counter":
            assert sample_name == fam_name + "_total", \
                f"OpenMetrics counter sample without _total: {line}"
        families[fam_name]["samples"].append(
            (sample_name, labels, value))
        if ex is not None:
            assert sample_name == fam_name + "_bucket", \
                f"exemplar off a bucket: {line}"
            families[fam_name]["exemplars"].append(
                (sample_name, labels, *ex))
    return families


def assert_exposition_contract(text: str, openmetrics: bool = False) -> dict:
    """The full scrape contract over an exposition page."""
    families = parse_exposition(text, openmetrics=openmetrics)
    assert families
    for name, fam in families.items():
        assert fam["type"], f"{name}: missing TYPE"
        assert fam["help"].strip(), f"{name}: empty HELP"
        for _, labels, _, ex_value, _ in fam["exemplars"]:
            le = labels["le"]
            assert le == "+Inf" or ex_value <= float(le), \
                f"{name}: exemplar {ex_value} above its bucket le={le}"
        if fam["type"] != "histogram":
            continue
        # group histogram samples per label set (minus le)
        series: dict[tuple, dict] = {}
        for sample_name, labels, value in fam["samples"]:
            key = tuple(sorted((k, v) for k, v in labels.items()
                               if k != "le"))
            s = series.setdefault(
                key, {"buckets": [], "sum": None, "count": None})
            if sample_name == name + "_bucket":
                s["buckets"].append((labels["le"], value))
            elif sample_name == name + "_sum":
                s["sum"] = value
            elif sample_name == name + "_count":
                s["count"] = value
        for key, s in series.items():
            assert s["buckets"], f"{name}{key}: no buckets"
            assert s["sum"] is not None, f"{name}{key}: no _sum"
            assert s["count"] is not None, f"{name}{key}: no _count"
            inf = [v for le, v in s["buckets"] if le == "+Inf"]
            assert len(inf) == 1, f"{name}{key}: +Inf bucket count"
            assert inf[0] == s["count"], \
                f"{name}{key}: le=+Inf {inf[0]} != _count {s['count']}"
            finite = sorted(
                ((float(le), v) for le, v in s["buckets"]
                 if le != "+Inf"))
            counts = [v for _, v in finite] + inf
            assert counts == sorted(counts), \
                f"{name}{key}: buckets not monotonic: {counts}"
    return families


def hist_count(families: dict, name: str, **want_labels) -> float:
    """The summed ``_count`` of histogram ``name`` over the series whose
    labels include ``want_labels``."""
    fam = families.get(name)
    assert fam is not None, f"missing {name}"
    assert fam["type"] == "histogram", name
    return sum(v for s_name, labels, v in fam["samples"]
               if s_name == name + "_count" and
               all(labels.get(k) == w for k, w in want_labels.items()))


def exemplar_heights(families: dict, since: float = 0.0) -> list[int]:
    """The ``trace_height`` of every exemplar stamped at or after unix
    time ``since``.  The process-global families keep the exemplars of
    every net that ran in the process before."""
    return [int(ex["trace_height"]) for fam in families.values()
            for _, _, ex, _, ts in fam["exemplars"]
            if "trace_height" in ex and ts >= since]
