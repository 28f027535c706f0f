"""KV tx/block indexers.

Reference: state/txindex/kv/kv.go (TxIndexer over events with the
pubsub query language) and state/indexer/block/kv (block events).
Records: tx hash → TxResult proto; composite event key
(type.attr/value/height/index) → tx hash or block height.

A copy of cometbft_tpu/indexer/kv.py over the port's db/ and
libs/pubsub.Query: the same rows, byte for byte, for the same events,
and the same answers to the same queries.
"""
from __future__ import annotations

import struct
from typing import Optional

from ..abci import types as abci
from ..db import DB
from ..libs.pubsub import Query
from ..wire import abci_pb, encode, decode

_TX_RESULT = b"tx/"
_TX_EVENT = b"te/"
_BLOCK_EVENT = b"be/"
_BLOCK_HEIGHT_REG = b"bh/"      # height -> hex key list (for pruning)
_TX_HEIGHT_REG = b"th/"         # height+hash -> hex key list


def _hex(k: bytes) -> bytes:
    return k.hex().encode()


_BLOCK_HEIGHT_KEY = "block.height"
_TX_HEIGHT_KEY = "tx.height"
_TX_HASH_KEY = "tx.hash"


# per-height registries share one wire format: hex-encoded keys
# joined by NUL (the raw keys themselves contain NUL separators)

def _reg_encode(keys: list[bytes]) -> bytes:
    return b"\x00".join(_hex(k) for k in keys)


def _reg_delete(batch, reg: bytes) -> int:
    n = 0
    for hexkey in reg.split(b"\x00"):
        if hexkey:
            batch.delete(bytes.fromhex(hexkey.decode()))
            n += 1
    return n


def _event_key(prefix: bytes, composite: str, value: str,
               height: int, tie: bytes) -> bytes:
    return (prefix + composite.encode() + b"\x00" + value.encode() +
            b"\x00" + struct.pack(">q", height) + b"\x00" + tie)


class TxIndexer:
    """Reference: state/txindex/indexer.go:24 TxIndexer interface."""

    def __init__(self, db: DB):
        self._db = db

    def index(self, tx_result: abci.TxResult) -> None:
        from ..types.tx import tx_hash
        h = tx_hash(tx_result.tx)
        raw = encode(abci_pb.TX_RESULT, {
            **({"height": tx_result.height}
               if tx_result.height else {}),
            **({"index": tx_result.index} if tx_result.index else {}),
            **({"tx": tx_result.tx} if tx_result.tx else {}),
            "result": _exec_result_proto(tx_result.result),
        })
        batch = self._db.new_batch()
        batch.set(_TX_RESULT + h, raw)
        # implicit tx.height/tx.hash attributes + app events
        keys = []
        for composite, value in _iter_event_attrs(
                tx_result.result.events):
            keys.append(_event_key(_TX_EVENT, composite, value,
                                   tx_result.height, h))
        for k in keys:
            batch.set(k, h)
        batch.set(_event_key(_TX_EVENT, _TX_HEIGHT_KEY,
                             str(tx_result.height), tx_result.height,
                             h), h)
        # per-(height,hash) registry of app-event keys so pruning can
        # delete them even when the same tx hash is re-committed at a
        # later height (the stored record then carries the later
        # height, and these keys could not be recomputed from it);
        # event-less txs need no entry — prune's recompute path
        # correctly deletes nothing for them
        if keys:
            batch.set(_TX_HEIGHT_REG + struct.pack(
                ">q", tx_result.height) + h, _reg_encode(keys))
        batch.write()

    def prune(self, from_height: int, to_height: int) -> int:
        """Delete indexed txs with height in [from, to) (reference:
        state/txindex/kv Prune, driven by the pruning service).  The
        txs at each height are found via the implicit tx.height index
        entries, then their event keys are recomputed from the stored
        TxResult — deletion is proportional to the data pruned, not
        the index size."""
        if to_height <= from_height:
            return 0
        pruned = 0
        batch = self._db.new_batch()
        for h in range(from_height, to_height):
            hk = _event_key(_TX_EVENT, _TX_HEIGHT_KEY, str(h), h, b"")
            for k, tx_hash_ in list(self._db.iterator(
                    hk, hk + b"\xff" * 40)):
                # this height's app-event keys come from the registry
                # — the stored record may carry a LATER height (same
                # tx hash re-committed), so they can't be recomputed
                reg_key = (_TX_HEIGHT_REG + struct.pack(">q", h) +
                           tx_hash_)
                reg = self._db.get(reg_key)
                if reg is not None:
                    _reg_delete(batch, reg)
                    batch.delete(reg_key)
                raw = self._db.get(_TX_RESULT + tx_hash_)
                # only delete the stored record if it belongs to THIS
                # height — the same tx hash re-committed later
                # overwrites the record, and the retained copy must
                # survive (its event keys embed the later height)
                if raw is not None:
                    d = decode(abci_pb.TX_RESULT, raw)
                    if d.get("height", 0) == h:
                        if reg is None:
                            # pre-registry record: recompute from the
                            # stored result (correct for this case —
                            # record height matches)
                            res = _exec_result_from_proto(
                                d.get("result") or {})
                            for composite, value in _iter_event_attrs(
                                    res.events):
                                batch.delete(_event_key(
                                    _TX_EVENT, composite, value, h,
                                    tx_hash_))
                        batch.delete(_TX_RESULT + tx_hash_)
                        pruned += 1
                batch.delete(k)
        batch.write()
        return pruned

    def get(self, tx_hash_: bytes) -> Optional[abci.TxResult]:
        raw = self._db.get(_TX_RESULT + tx_hash_)
        if raw is None:
            return None
        d = decode(abci_pb.TX_RESULT, raw)
        return abci.TxResult(
            height=d.get("height", 0), index=d.get("index", 0),
            tx=d.get("tx", b""),
            result=_exec_result_from_proto(d.get("result") or {}))

    def search(self, query: Query,
               limit: Optional[int] = 100) -> list[bytes]:
        """Tx hashes whose indexed events satisfy the query (AND of
        conditions, like the reference's kv search).  Equality
        conditions narrow the scan to the exact value's key range.
        ``limit`` None keeps every match."""
        result: Optional[set[bytes]] = None
        for cond in query.conditions:
            matches = set()
            prefix = _TX_EVENT + cond.key.encode() + b"\x00"
            lo, hi = _cond_range(prefix, cond)
            for k, v in self._db.iterator(lo, hi):
                rest = k[len(prefix):]
                value = rest.split(b"\x00", 1)[0].decode(
                    errors="replace")
                if cond.matches_value(value):
                    matches.add(v)
            result = matches if result is None else result & matches
            if not result:
                return []
        return list(result or [])[:limit]


class BlockIndexer:
    """Reference: state/indexer/block/kv."""

    def __init__(self, db: DB):
        self._db = db

    def index(self, height: int, events: list) -> None:
        batch = self._db.new_batch()
        tie = struct.pack(">q", height)
        keys = [_event_key(_BLOCK_EVENT, _BLOCK_HEIGHT_KEY,
                           str(height), height, tie)]
        for composite, value in _iter_event_attrs(events):
            keys.append(_event_key(_BLOCK_EVENT, composite, value,
                                   height, tie))
        for k in keys:
            batch.set(k, tie)
        # per-height registry of emitted keys so pruning touches only
        # the pruned heights (keys can't be recomputed from height
        # alone — the events aren't stored here)
        batch.set(_BLOCK_HEIGHT_REG + tie, _reg_encode(keys))
        batch.write()

    def prune(self, from_height: int, to_height: int) -> int:
        """Delete block-event index entries with height in [from, to)
        (reference: state/indexer/block/kv Prune).  Uses the
        per-height key registry written by index(), so the pass only
        touches the pruned heights."""
        if to_height <= from_height:
            return 0
        pruned = 0
        need_scan = False
        batch = self._db.new_batch()
        for h in range(from_height, to_height):
            reg_key = _BLOCK_HEIGHT_REG + struct.pack(">q", h)
            reg = self._db.get(reg_key)
            if reg is None:
                # height indexed before the registry existed — fall
                # back to one legacy scan below rather than silently
                # leaking its entries past the watermark
                need_scan = True
                continue
            pruned += _reg_delete(batch, reg)
            batch.delete(reg_key)
        if need_scan:
            for k, _ in list(self._db.iterator(
                    _BLOCK_EVENT, _BLOCK_EVENT + b"\xff" * 64)):
                # key tail is fixed-width: ...<height:8>\0<tie:8>
                if len(k) < 17 or k[-9] != 0:
                    continue
                h = struct.unpack(">q", k[-17:-9])[0]
                if from_height <= h < to_height:
                    batch.delete(k)
                    pruned += 1
        batch.write()
        return pruned

    def search(self, query: Query,
               limit: Optional[int] = 100) -> list[int]:
        result: Optional[set[int]] = None
        for cond in query.conditions:
            matches = set()
            prefix = _BLOCK_EVENT + cond.key.encode() + b"\x00"
            lo, hi = _cond_range(prefix, cond)
            for k, v in self._db.iterator(lo, hi):
                rest = k[len(prefix):]
                value = rest.split(b"\x00", 1)[0].decode(
                    errors="replace")
                if cond.matches_value(value):
                    matches.add(struct.unpack(">q", v)[0])
            result = matches if result is None else result & matches
            if not result:
                return []
        return sorted(result or [])[:limit]


def _cond_range(prefix: bytes, cond) -> tuple[bytes, bytes]:
    """Key range for one condition scan.  String equality narrows to
    the exact value's range (O(matches) instead of O(all values for
    the key)); everything else scans the composite-key prefix.
    Numeric equality can't narrow: '7' matches event value '7.0'."""
    from ..libs.pubsub import _as_number
    if cond.op == "=" and isinstance(cond.value, str) and \
            _as_number(cond.value) is None:
        exact = prefix + cond.value.encode() + b"\x00"
        return exact, exact + b"\xff" * 64
    return prefix, prefix + b"\xff" * 64


def _iter_event_attrs(events):
    for ev in events or []:
        for attr in ev.attributes:
            if attr.index and ev.type and attr.key:
                yield f"{ev.type}.{attr.key}", attr.value


def _exec_result_proto(r: abci.ExecTxResult) -> dict:
    d: dict = {}
    if r.code:
        d["code"] = r.code
    if r.data:
        d["data"] = r.data
    if r.log:
        d["log"] = r.log
    if r.gas_wanted:
        d["gas_wanted"] = r.gas_wanted
    if r.gas_used:
        d["gas_used"] = r.gas_used
    if r.events:
        d["events"] = [{
            **({"type": e.type} if e.type else {}),
            "attributes": [
                {**({"key": a.key} if a.key else {}),
                 **({"value": a.value} if a.value else {}),
                 **({"index": True} if a.index else {})}
                for a in e.attributes]} for e in r.events]
    if r.codespace:
        d["codespace"] = r.codespace
    return d


def _exec_result_from_proto(d: dict) -> abci.ExecTxResult:
    return abci.ExecTxResult(
        code=d.get("code", 0), data=d.get("data", b""),
        log=d.get("log", ""),
        gas_wanted=d.get("gas_wanted", 0),
        gas_used=d.get("gas_used", 0),
        events=[abci.Event(
            type=e.get("type", ""),
            attributes=[abci.EventAttribute(
                key=a.get("key", ""), value=a.get("value", ""),
                index=a.get("index", False))
                for a in e.get("attributes", [])])
            for e in d.get("events", [])],
        codespace=d.get("codespace", ""))
