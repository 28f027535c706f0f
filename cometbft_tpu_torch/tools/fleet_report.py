"""Cluster critical-path analysis of a QA fleet's flight records.

The port's own trimmed copy of ``load_inputs`` and ``analyze`` from the
repository's ``tools/fleet_report.py`` (the text report and the CLI stay
there).  Input is the fleet collector's ``fleet_<run>.json``
(``tools/qa._FleetCollector``: the ``/trace`` bodies of every node of the
run, rpc/core.py's ``trace`` route) or one saved ``/trace`` body a node.
Per node, clock offset and drift are fitted from the recorder's
``(monotonic_ns, wall_ns)`` anchors and every event is mapped onto one
wall timeline; per height the analysis gives the proposer and its
propose span, each node's proposal sighting, the prevote and precommit
power waterfalls (time to 1/3 and 2/3) and the inter-node commit skew,
plus gossip hop latencies and a straggler table.  ``tools/qa.py`` gates
the p95 time to 2/3 prevotes and the largest commit skew on it.
"""
from __future__ import annotations

import json
from typing import Optional

_MS = 1e6  # ns per ms

PREVOTE = 1
PRECOMMIT = 2


def _to_int(v) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        return 0


# ---------------------------------------------------------------------
# clock alignment

def fit_clock(anchors: list) -> tuple[float, float]:
    """Fit ``wall = mono + offset + drift*mono`` by least squares over
    ``(monotonic_ns, wall_ns)`` anchor pairs.  One pair pins the
    offset only (drift 0); the recorder keeps its first anchor
    forever, so long-lived nodes give the fit a long drift baseline.
    Returns ``(offset_ns, drift)``."""
    pairs = [(_to_int(m), _to_int(w)) for m, w in anchors]
    if not pairs:
        return 0.0, 0.0
    if len(pairs) == 1:
        return float(pairs[0][1] - pairs[0][0]), 0.0
    # regress y = wall - mono against x = mono (numerically safer
    # than wall against mono: y is small, x is huge)
    n = len(pairs)
    xbar = sum(m for m, _ in pairs) / n
    ybar = sum(w - m for m, w in pairs) / n
    sxx = sum((m - xbar) ** 2 for m, _ in pairs)
    if sxx == 0:
        return ybar, 0.0
    sxy = sum((m - xbar) * ((w - m) - ybar) for m, w in pairs)
    drift = sxy / sxx
    offset = ybar - drift * xbar
    return offset, drift


def to_wall(ts_ns: int, fit: tuple[float, float]) -> float:
    offset, drift = fit
    return ts_ns + offset + drift * ts_ns


# ---------------------------------------------------------------------
# input loading

def _norm_events(evs: list) -> list[dict]:
    out = []
    for e in evs:
        out.append({
            "ts_ns": _to_int(e.get("ts_ns")),
            "dur_ns": _to_int(e.get("dur_ns")),
            "category": e.get("category", ""),
            "name": e.get("name", ""),
            "height": _to_int(e.get("height")),
            "attrs": e.get("attrs") or {},
        })
    out.sort(key=lambda e: e["ts_ns"])
    return out


def node_record(obj: dict, fallback_name: str) -> dict:
    """Normalize one node's record — a flight dump or a saved /trace
    body — to ``{"node", "anchors", "events"}``."""
    name = obj.get("node") or fallback_name
    return {"node": name,
            "anchors": [(_to_int(m), _to_int(w))
                        for m, w in obj.get("anchors") or []],
            "events": _norm_events(obj.get("events") or [])}


def load_inputs(paths: list[str]) -> list[dict]:
    """Each path is a per-node record, or a fleet collection file
    (``{"nodes": {name: record, ...}}``) contributing one record per
    node."""
    nodes = []
    for path in paths:
        with open(path) as f:
            obj = json.load(f)
        stem = path.rsplit("/", 1)[-1]
        if stem.endswith(".json"):
            stem = stem[:-5]
        if isinstance(obj, dict) and isinstance(obj.get("nodes"),
                                                dict):
            for name, rec in sorted(obj["nodes"].items()):
                nodes.append(node_record(rec, name))
        else:
            nodes.append(node_record(obj, stem))
    return nodes


# ---------------------------------------------------------------------
# analysis

def _pct(sorted_vals: list[float], q: float) -> float:
    if not sorted_vals:
        return 0.0
    i = min(len(sorted_vals) - 1,
            max(0, int(q * (len(sorted_vals) - 1) + 0.5)))
    return sorted_vals[i]


def _waterfall(arrivals: list[tuple[float, int]],
               powers: list[float],
               total_power: float) -> dict:
    """``arrivals`` is [(wall_ts, validator_index)] on ONE node;
    returns the cumulative-power crossing times.  Each validator
    counts once (first arrival wins — regossip duplicates carry no
    new power)."""
    seen: set[int] = set()
    acc = 0.0
    t13 = t23 = None
    for ts, idx in sorted(arrivals):
        if idx in seen:
            continue
        seen.add(idx)
        acc += powers[idx] if 0 <= idx < len(powers) else 1.0
        if t13 is None and acc * 3 > total_power:
            t13 = ts
        if t23 is None and acc * 3 > 2 * total_power:
            t23 = ts
            break
    return {"t13": t13, "t23": t23}


def analyze(nodes: list[dict], height: Optional[int] = None,
            powers: Optional[list[float]] = None) -> dict:
    """Merge the fleet onto one wall timeline and decompose each
    height's critical path.  Returns the full report as a dict (the
    ``--json`` body); times inside are wall-clock ns floats."""
    fits = {n["node"]: fit_clock(n["anchors"]) for n in nodes}
    # per node, per height, the named instants we chart
    heights: set[int] = set()
    per_node: dict[str, dict[int, dict]] = {}
    max_vindex = -1
    for n in nodes:
        fit = fits[n["node"]]
        hmap: dict[int, dict] = {}
        per_node[n["node"]] = hmap
        for e in n["events"]:
            h = e["height"]
            if h <= 0 or e["category"] != "consensus":
                continue
            if height is not None and h != height:
                continue
            name, a = e["name"], e["attrs"]
            w = to_wall(e["ts_ns"], fit)
            rec = hmap.setdefault(h, {"first_seen": None,
                                      "broadcast": None,
                                      "propose_span_ns": 0,
                                      "commit": None,
                                      "votes": {PREVOTE: [],
                                                PRECOMMIT: []}})
            heights.add(h)
            if name in ("proposal_recv", "proposal_received"):
                if rec["first_seen"] is None or w < rec["first_seen"]:
                    rec["first_seen"] = w
            elif name == "proposal_broadcast":
                rec["broadcast"] = w
            elif name == "step:Propose":
                rec["propose_span_ns"] = max(rec["propose_span_ns"],
                                             e["dur_ns"])
            elif name == "commit":
                if rec["commit"] is None or w < rec["commit"]:
                    rec["commit"] = w
            elif name == "vote_recv":
                idx = _to_int(a.get("index", -1))
                max_vindex = max(max_vindex, idx)
                t = _to_int(a.get("type"))
                if t in (PREVOTE, PRECOMMIT):
                    rec["votes"][t].append((w, idx))
    if powers is None:
        powers = [1.0] * max(1, max_vindex + 1)
    total_power = sum(powers)

    out_heights: dict[int, dict] = {}
    proposal_hops: list[float] = []
    vote_hops: list[float] = []
    commit_delays: dict[str, list[float]] = {k: []
                                             for k in per_node}
    seen_delays: dict[str, list[float]] = {k: [] for k in per_node}

    for h in sorted(heights):
        rows = {name: hmap[h] for name, hmap in per_node.items()
                if h in hmap}
        proposer = None
        bcast = None
        for name, rec in rows.items():
            if rec["broadcast"] is not None and \
                    (bcast is None or rec["broadcast"] < bcast):
                proposer, bcast = name, rec["broadcast"]
        # t0: proposer's first-sent instant, else the fleet's first
        # sighting of the proposal, else the earliest commit
        t0 = bcast
        if t0 is None:
            seen = [r["first_seen"] for r in rows.values()
                    if r["first_seen"] is not None]
            t0 = min(seen) if seen else min(
                (r["commit"] for r in rows.values()
                 if r["commit"] is not None), default=None)
        if t0 is None:
            continue
        node_rows = {}
        commits = []
        for name in sorted(rows):
            rec = rows[name]
            pv = _waterfall(rec["votes"][PREVOTE], powers,
                            total_power)
            pc = _waterfall(rec["votes"][PRECOMMIT], powers,
                            total_power)
            fs = rec["first_seen"]
            cm = rec["commit"]
            node_rows[name] = {
                "proposal_seen_ms":
                    (fs - t0) / _MS if fs is not None else None,
                "prevote_t13_ms":
                    (pv["t13"] - t0) / _MS
                    if pv["t13"] is not None else None,
                "prevote_t23_ms":
                    (pv["t23"] - t0) / _MS
                    if pv["t23"] is not None else None,
                "precommit_t23_ms":
                    (pc["t23"] - t0) / _MS
                    if pc["t23"] is not None else None,
                "commit_ms":
                    (cm - t0) / _MS if cm is not None else None,
            }
            if cm is not None:
                commits.append((cm, name))
            if bcast is not None and fs is not None and \
                    name != proposer:
                proposal_hops.append((fs - bcast) / _MS)
                seen_delays[name].append((fs - bcast) / _MS)
        skew = ((max(c for c, _ in commits) -
                 min(c for c, _ in commits)) / _MS
                if len(commits) > 1 else 0.0)
        if commits:
            first_commit = min(c for c, _ in commits)
            for cm, name in commits:
                commit_delays[name].append((cm - first_commit) / _MS)
        # vote hop latency: arrival delta vs the earliest sighting of
        # the same (type, index) vote anywhere in the fleet
        firsts: dict[tuple, float] = {}
        for rec in rows.values():
            for t, arr in rec["votes"].items():
                for w, idx in arr:
                    k = (t, idx)
                    if k not in firsts or w < firsts[k]:
                        firsts[k] = w
        for rec in rows.values():
            for t, arr in rec["votes"].items():
                for w, idx in arr:
                    d = (w - firsts[(t, idx)]) / _MS
                    if d > 0:
                        vote_hops.append(d)
        out_heights[h] = {
            "proposer": proposer,
            "propose_span_ms":
                (rows[proposer]["propose_span_ns"] / _MS)
                if proposer else 0.0,
            "commit_skew_ms": skew,
            "nodes": node_rows,
        }

    proposal_hops.sort()
    vote_hops.sort()
    stragglers = {}
    for name in sorted(per_node):
        sd, cd = seen_delays[name], commit_delays[name]
        stragglers[name] = {
            "mean_proposal_delay_ms":
                sum(sd) / len(sd) if sd else 0.0,
            "mean_commit_delay_ms":
                sum(cd) / len(cd) if cd else 0.0,
            "heights_seen": len(per_node[name]),
        }
    return {
        "nodes": sorted(per_node),
        "clock_fits": {k: {"offset_ns": v[0], "drift": v[1]}
                       for k, v in fits.items()},
        "heights": out_heights,
        "hop_latency_ms": {
            "proposal": {"p50": _pct(proposal_hops, 0.5),
                         "p90": _pct(proposal_hops, 0.9),
                         "max": proposal_hops[-1]
                         if proposal_hops else 0.0,
                         "n": len(proposal_hops)},
            "vote": {"p50": _pct(vote_hops, 0.5),
                     "p90": _pct(vote_hops, 0.9),
                     "max": vote_hops[-1] if vote_hops else 0.0,
                     "n": len(vote_hops)},
        },
        "stragglers": stragglers,
    }
