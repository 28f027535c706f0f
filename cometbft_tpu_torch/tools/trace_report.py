"""Per-height latency breakdown of a flight record.

The port's copy of the repository's ``tools/trace_report.py``: the same
tables, the same attribution and the same rows on the same record.
Input is a JSON record of the port's flight recorder
(``cometbft_tpu_torch/libs/tracing.py``): the ``/trace`` RPC body, a
``/debug/pprof/trace?dump=1`` file, a supervisor give-up dump or a
nemesis record.  Output is one row a height splitting its wall-clock
into gossip / verify / execute / commit, plus the batch-verify
dispatches seen.

    python -m cometbft_tpu_torch.tools.trace_report flight.json [--height H]

Attribution
-----------
Height *windows* come from the events that carry a height; an event
recorded without one (height 0) goes to the window its monotonic
timestamp falls into.  Buckets:

  * gossip   - window start to ``proposal_complete`` (the time spent
               collecting the proposal over p2p), else the
               ``step:Propose`` span;
  * verify   - the crypto spans in ``_VERIFY_NAMES`` plus consensus
               ``validate_block``;
  * execute  - the abci call spans (the app's share);
  * commit   - ``save_block`` plus the ``step:Commit`` span;
  * pipeline - ``apply_block`` + ``barrier_wait``: pipelined work that
               overlaps the next height, and the barrier stalls, kept
               apart so that they are not read as the height's wall.

``verify_ms`` sums nested spans, as the reference's does:
``batch_verify`` encloses ``host_prep`` and ``kernel_execute``.  The
port's ``prep_pack`` and ``prep_c`` (the packing and the C prep, both
inside ``host_prep``) are left out of the sum, so that the rows stay
the reference's; a split of verify reads those leaf spans directly.

Marker instants (compact-block relay, aggregate-commit catchup, vote
and part arrivals) are counted a height in the ``markers`` column.
"""
from __future__ import annotations

import argparse
import json
import sys
from typing import Optional

_MS = 1e6  # ns per ms

# crypto span names that count as "verify" work (the reference's set)
_VERIFY_NAMES = {"batch_verify", "kernel_execute", "host_prep",
                 "kernel_compile"}

# consensus span -> bucket (tests/test_torch_observability_drift.py holds
# it to the names the port emits; "step:*" spans match by prefix)
CONSENSUS_SPAN_BUCKETS = {
    "validate_block": "verify",
    "save_block": "commit",
    "step:Commit": "commit",
    "apply_block": "pipeline",
    "barrier_wait": "pipeline",
}

# consensus instants counted a height (zero-duration markers)
CONSENSUS_MARKERS = frozenset({
    "proposal_recv", "proposal_received", "proposal_complete",
    "proposal_broadcast", "block_part_recv", "vote_recv",
    "compact_block_recv", "compact_block_rebuilt",
    "compact_block_miss", "compact_block_nack",
    "agg_commit_recv", "agg_commit_shed", "pipeline_advance",
    "commit",
})


def _to_int(v) -> int:
    try:
        return int(v)
    except (TypeError, ValueError):
        return 0


def _events(record: dict) -> list[dict]:
    evs = record.get("events", record if isinstance(record, list)
                     else [])
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


def _height_windows(events: list[dict]) -> dict[int, tuple[int, int]]:
    """height -> (first_ts, last_ts+dur) from height-stamped events."""
    win: dict[int, tuple[int, int]] = {}
    for e in events:
        h = e["height"]
        if h <= 0:
            continue
        end = e["ts_ns"] + e["dur_ns"]
        lo, hi = win.get(h, (e["ts_ns"], end))
        win[h] = (min(lo, e["ts_ns"]), max(hi, end))
    return win


def _attribute(events: list[dict],
               windows: dict[int, tuple[int, int]]) -> None:
    """Stamp height-less events with the height whose window contains
    their timestamp (in place)."""
    ordered = sorted(windows.items())
    for e in events:
        if e["height"] > 0:
            continue
        ts = e["ts_ns"]
        for h, (lo, hi) in ordered:
            if lo <= ts <= hi:
                e["height"] = h
                break


def analyze(record: dict,
            height: Optional[int] = None) -> dict[int, dict]:
    """Per-height breakdown (values in ms) keyed by height."""
    events = _events(record)
    windows = _height_windows(events)
    _attribute(events, windows)
    out: dict[int, dict] = {}
    for h, (lo, hi) in sorted(windows.items()):
        if height is not None and h != height:
            continue
        row = {"wall_ms": (hi - lo) / _MS, "gossip_ms": 0.0,
               "verify_ms": 0.0, "execute_ms": 0.0, "commit_ms": 0.0,
               "pipeline_ms": 0.0,
               "p2p_events": 0, "p2p_bytes": 0, "stalls": 0,
               "markers": {}, "batches": []}
        propose_span = 0.0
        proposal_complete_ts = None
        for e in events:
            if e["height"] != h:
                continue
            cat, name, dur = e["category"], e["name"], e["dur_ns"]
            if cat == "crypto" and name in _VERIFY_NAMES:
                row["verify_ms"] += dur / _MS
                if name in ("batch_verify", "kernel_execute"):
                    a = e["attrs"]
                    row["batches"].append({
                        "name": name,
                        "batch": a.get("batch"),
                        "backend": a.get("backend",
                                         a.get("kernel", "?")),
                        "bucket": a.get("bucket"),
                        "ms": dur / _MS})
            elif cat == "abci":
                row["execute_ms"] += dur / _MS
            elif cat == "p2p":
                row["p2p_events"] += 1
                row["p2p_bytes"] += _to_int(
                    e["attrs"].get("bytes", 0))
                if name.endswith(("_full", "_stall")):
                    row["stalls"] += 1
            elif cat == "consensus":
                bucket = CONSENSUS_SPAN_BUCKETS.get(name)
                if bucket is not None:
                    row[bucket + "_ms"] += dur / _MS
                elif name in CONSENSUS_MARKERS:
                    row["markers"][name] = \
                        row["markers"].get(name, 0) + 1
                if name == "step:Propose":
                    propose_span = dur / _MS
                elif name == "proposal_complete":
                    proposal_complete_ts = e["ts_ns"]
        row["gossip_ms"] = ((proposal_complete_ts - lo) / _MS
                            if proposal_complete_ts is not None
                            else propose_span)
        out[h] = row
    return out


def render_report(record: dict,
                  height: Optional[int] = None) -> str:
    rows = analyze(record, height=height)
    lines = []
    reason = record.get("reason")
    if reason:
        lines.append(f"flight record: {reason} "
                     f"({record.get('wall_time', '?')})")
    extra = record.get("extra") or {}
    if extra.get("conflicting_heights"):
        lines.append("conflicting-commit heights: "
                     f"{extra['conflicting_heights']}")
    if not rows:
        lines.append("no height-stamped events in this record")
        return "\n".join(lines) + "\n"
    hdr = (f"{'height':>7} {'wall_ms':>9} {'gossip_ms':>10} "
           f"{'verify_ms':>10} {'execute_ms':>11} {'commit_ms':>10} "
           f"{'pipe_ms':>8} {'p2p ev':>7} {'stalls':>7}")
    lines.append(hdr)
    lines.append("-" * len(hdr))
    for h, r in rows.items():
        lines.append(
            f"{h:>7} {r['wall_ms']:>9.2f} {r['gossip_ms']:>10.2f} "
            f"{r['verify_ms']:>10.2f} {r['execute_ms']:>11.2f} "
            f"{r['commit_ms']:>10.2f} {r['pipeline_ms']:>8.2f} "
            f"{r['p2p_events']:>7} {r['stalls']:>7}")
    for h, r in rows.items():
        if r["markers"]:
            mk = " ".join(f"{k}={v}" for k, v in
                          sorted(r["markers"].items()))
            lines.append(f"        h{h} markers: {mk}")
        for b in r["batches"]:
            lines.append(
                f"        h{h} {b['name']}: batch={b['batch']} "
                f"backend={b['backend']} bucket={b['bucket']} "
                f"{b['ms']:.2f}ms")
    return "\n".join(lines) + "\n"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="Per-height latency breakdown from a flight-"
                    "record dump")
    p.add_argument("dump", help="flight-record JSON file")
    p.add_argument("--height", type=int, default=None,
                   help="restrict to one height")
    p.add_argument("--json", action="store_true",
                   help="JSON instead of text")
    args = p.parse_args(argv)
    with open(args.dump) as f:
        record = json.load(f)
    if args.json:
        json.dump(analyze(record, height=args.height), sys.stdout,
                  indent=2)
        sys.stdout.write("\n")
    else:
        sys.stdout.write(render_report(record, height=args.height))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
