"""Load-generator payloads and latency statistics.

Reference: test/loadtime — payload/payload.go ("a=" + hex(encoded
payload), so the kvstore only ever stores one key) and the latency
statistics of report/report.go — through cometbft_tpu/tools/loadtime.py,
whose ``payload_bytes``, ``payload_from_tx`` and ``Stats`` this copy
keeps.  ``generate`` and ``report`` talk HTTP to a node's RPC and wait
for the RPC client (ROADMAP.md A.7e-5).
"""
from __future__ import annotations

import json
import math
import secrets
import time
from dataclasses import dataclass
from typing import Optional

_KEY_PREFIX = b"a="
MAX_PAYLOAD_SIZE = 4 * 1024 * 1024


def payload_bytes(experiment_id: str, size: int = 256, rate: int = 0,
                  connections: int = 0,
                  now_ns: Optional[int] = None) -> bytes:
    """One timestamped tx (reference: payload.NewBytes).  The tx is
    kvstore-compatible: a single "a" key whose value is the hex-encoded
    payload, padded with random hex up to ``size``."""
    if size > MAX_PAYLOAD_SIZE:
        raise ValueError(f"size {size} too large")
    body = {
        "id": experiment_id,
        "time_ns": time.time_ns() if now_ns is None else now_ns,
        "rate": rate,
        "connections": connections,
    }
    raw = json.dumps(body, separators=(",", ":")).encode().hex()
    tx = _KEY_PREFIX + raw.encode()
    if len(tx) < size:
        # random hex padding outside the JSON (split by '.')
        pad = size - len(tx) - 1
        tx += b"." + secrets.token_hex((pad + 1) // 2)[:pad].encode()
    return tx


def payload_from_tx(tx: bytes) -> Optional[dict]:
    """Reference: payload.FromBytes — None if not a load payload."""
    if not tx.startswith(_KEY_PREFIX):
        return None
    body = tx[len(_KEY_PREFIX):].split(b".", 1)[0]
    try:
        return json.loads(bytes.fromhex(body.decode()))
    except (ValueError, json.JSONDecodeError):
        return None


@dataclass
class Stats:
    count: int = 0
    min_s: float = 0.0
    max_s: float = 0.0
    avg_s: float = 0.0
    stddev_s: float = 0.0
    p50_s: float = 0.0
    p90_s: float = 0.0
    p99_s: float = 0.0

    @classmethod
    def from_samples(cls, xs: list[float]) -> "Stats":
        if not xs:
            return cls()
        s = sorted(xs)

        def pct(p: float) -> float:
            return s[min(len(s) - 1, int(p * len(s)))]
        avg = sum(s) / len(s)
        var = sum((x - avg) ** 2 for x in s) / len(s)
        return cls(count=len(s), min_s=s[0], max_s=s[-1], avg_s=avg,
                   stddev_s=math.sqrt(var), p50_s=pct(0.50),
                   p90_s=pct(0.90), p99_s=pct(0.99))

    def to_dict(self) -> dict:
        return {k: (round(v, 6) if isinstance(v, float) else v)
                for k, v in self.__dict__.items()}
