"""RPC clients: JSON-RPC over HTTP + WebSocket event subscriptions.

Reference: rpc/client/http (Client + wsEvents) — the client library the
light provider, statesync state provider, and e2e tests depend on.
Includes the JSON -> typed parsers that invert rpc/core's response
serializers (hex hashes, base64 bytes, stringified int64s).

A copy of cometbft_tpu/rpc/client.py: the same requests, one TCP
connection a call (``Connection: close``), and parsers that give the
same objects as the JAX ones for the same JSON, so the light blocks a
provider builds from them carry the sign bytes the server's stores hold.
"""
from __future__ import annotations

import asyncio
import base64
import json
from typing import AsyncIterator, Optional
from urllib.parse import urlsplit

from ..types.block import Header, ConsensusVersion, LightBlock, SignedHeader
from ..types.block_id import BlockID
from ..types.commit import Commit, CommitSig
from ..types.part_set import PartSetHeader
from ..types.timestamp import Timestamp
from ..types.validator import Validator
from ..types.validator_set import ValidatorSet
from ..types import genesis as genesis_types


class RPCClientError(Exception):
    pass


# --- JSON -> typed parsers (inverse of rpc/core serializers) ----------------

def block_id_from_json(d: dict) -> BlockID:
    parts = d.get("parts") or {}
    return BlockID(
        hash=bytes.fromhex(d.get("hash", "") or ""),
        part_set_header=PartSetHeader(
            total=int(parts.get("total", 0)),
            hash=bytes.fromhex(parts.get("hash", "") or "")))


def header_from_json(d: dict) -> Header:
    v = d.get("version") or {}
    return Header(
        version=ConsensusVersion(block=int(v.get("block", 0)),
                                 app=int(v.get("app", 0))),
        chain_id=d.get("chain_id", ""),
        height=int(d.get("height", 0)),
        time=Timestamp.from_rfc3339(d["time"]),
        last_block_id=block_id_from_json(d.get("last_block_id") or {}),
        last_commit_hash=bytes.fromhex(d.get("last_commit_hash", "")),
        data_hash=bytes.fromhex(d.get("data_hash", "")),
        validators_hash=bytes.fromhex(d.get("validators_hash", "")),
        next_validators_hash=bytes.fromhex(
            d.get("next_validators_hash", "")),
        consensus_hash=bytes.fromhex(d.get("consensus_hash", "")),
        app_hash=bytes.fromhex(d.get("app_hash", "")),
        last_results_hash=bytes.fromhex(d.get("last_results_hash", "")),
        evidence_hash=bytes.fromhex(d.get("evidence_hash", "")),
        proposer_address=bytes.fromhex(d.get("proposer_address", "")),
    )


def commit_from_json(d: dict):
    if "aggregate_signature" in d:
        # aggregate-commit chains (docs/aggregate_commits.md);
        # non-canonical bitmaps fail at the parse boundary exactly as
        # the proto decoder rejects them — a masked decode would hash
        # differently from what the server sent
        from ..libs.bits import BitArray
        from ..types.commit import AggregateCommit
        count = int(d.get("signer_count", 0))
        ba = BitArray.from_le_bytes(
            base64.b64decode(d.get("signers", "") or ""), count)
        return AggregateCommit(
            height=int(d.get("height", 0)),
            round=int(d.get("round", 0)),
            block_id=block_id_from_json(d.get("block_id") or {}),
            signers=ba,
            signature=base64.b64decode(
                d.get("aggregate_signature", "")))
    sigs = []
    for s in d.get("signatures", []):
        sig = s.get("signature")
        sigs.append(CommitSig(
            block_id_flag=int(s.get("block_id_flag", 0)),
            validator_address=bytes.fromhex(
                s.get("validator_address", "") or ""),
            timestamp=Timestamp.from_rfc3339(s["timestamp"])
            if s.get("timestamp") else Timestamp.zero(),
            signature=base64.b64decode(sig) if sig else b""))
    return Commit(
        height=int(d.get("height", 0)),
        round=int(d.get("round", 0)),
        block_id=block_id_from_json(d.get("block_id") or {}),
        signatures=sigs)


def validator_set_from_json(vals: list) -> ValidatorSet:
    out = []
    for v in vals:
        pub = genesis_types.pub_key_from_json(v["pub_key"])
        val = Validator(
            address=bytes.fromhex(v["address"]),
            pub_key=pub,
            voting_power=int(v["voting_power"]),
            proposer_priority=int(v.get("proposer_priority", 0)))
        out.append(val)
    # the server's set as it stands (reference: light/provider/http
    # validatorSet -> types.ValidatorSetFromExistingValidators): its order
    # and proposer priorities kept, the proposer the validator the last
    # rotation left lowest (findPreviousProposer).  The JAX parser rebuilds
    # the set through the constructor, which recomputes the priorities: a
    # state built from its light blocks then disagrees with the chain's on
    # who proposes (ROADMAP.md section C).
    vs = ValidatorSet()
    vs.validators = out
    prev = None
    for v in out:
        if prev is None or prev.compare_proposer_priority(v) is prev:
            prev = v
    vs.proposer = prev.copy() if prev is not None else None
    vs._check_all_keys_same_type()
    if out:
        vs._update_total_voting_power()
    return vs


# --- HTTP client -------------------------------------------------------------

class HTTPClient:
    """JSON-RPC 2.0 over HTTP POST (reference: rpc/client/http)."""

    def __init__(self, address: str, timeout: float = 10.0):
        """address: 'http://host:port' or 'tcp://host:port'."""
        u = urlsplit(address.replace("tcp://", "http://"))
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 26657
        self.timeout = timeout
        self._id = 0

    async def call(self, method: str, **params):
        self._id += 1
        body = json.dumps({"jsonrpc": "2.0", "id": self._id,
                           "method": method,
                           "params": _encode_params(params)}).encode()
        req = (f"POST / HTTP/1.1\r\nHost: {self.host}\r\n"
               f"Content-Type: application/json\r\n"
               f"Content-Length: {len(body)}\r\n"
               f"Connection: close\r\n\r\n").encode() + body
        reader, writer = await asyncio.wait_for(
            asyncio.open_connection(self.host, self.port), self.timeout)
        try:
            writer.write(req)
            await writer.drain()
            raw = await asyncio.wait_for(reader.read(-1), self.timeout)
        finally:
            writer.close()
        header, _, payload = raw.partition(b"\r\n\r\n")
        status = header.split(b" ", 2)[1:2]
        if not status or status[0] != b"200":
            raise RPCClientError(f"HTTP error: {header[:120]!r}")
        resp = json.loads(payload)
        if resp.get("error"):
            e = resp["error"]
            raise RPCClientError(
                f"{e.get('message')} ({e.get('code')}): {e.get('data')}")
        return resp.get("result")

    # -- typed helpers ----------------------------------------------------
    async def status(self) -> dict:
        return await self.call("status")

    async def health(self) -> dict:
        return await self.call("health")

    async def abci_query(self, path: str, data: bytes,
                         height: int = 0, prove: bool = False) -> dict:
        return await self.call("abci_query", path=path,
                               data=data.hex(), height=str(height),
                               prove=prove)

    async def broadcast_tx_sync(self, tx: bytes) -> dict:
        return await self.call("broadcast_tx_sync",
                               tx=base64.b64encode(tx).decode())

    async def broadcast_tx_async(self, tx: bytes) -> dict:
        return await self.call("broadcast_tx_async",
                               tx=base64.b64encode(tx).decode())

    async def broadcast_tx_commit(self, tx: bytes) -> dict:
        return await self.call("broadcast_tx_commit",
                               tx=base64.b64encode(tx).decode())

    async def block(self, height: int = 0) -> dict:
        return await self.call("block", height=str(height))

    async def commit(self, height: int = 0
                     ) -> tuple[SignedHeader, bool]:
        res = await self.call("commit", height=str(height))
        sh = res["signed_header"]
        return (SignedHeader(header=header_from_json(sh["header"]),
                             commit=commit_from_json(sh["commit"])),
                bool(res.get("canonical")))

    async def validators(self, height: int = 0) -> ValidatorSet:
        """Pages through /validators to assemble the full set
        (reference: light provider paging)."""
        vals: list = []
        page = 1
        while True:
            res = await self.call("validators", height=str(height),
                                  page=str(page), per_page="100")
            vals.extend(res.get("validators", []))
            if len(vals) >= int(res.get("total", len(vals))) or \
                    not res.get("validators"):
                break
            page += 1
        return validator_set_from_json(vals)

    async def light_block(self, height: int = 0):
        """One-round-trip signed header + validator set from the
        lightserve route (docs/light_proofs.md)."""
        from ..types.block import LightBlock
        res = await self.call("light_block", height=str(height))
        lb = res["light_block"]
        sh = lb["signed_header"]
        return LightBlock(
            signed_header=SignedHeader(
                header=header_from_json(sh["header"]),
                commit=commit_from_json(sh["commit"])),
            validator_set=validator_set_from_json(
                lb["validator_set"]["validators"]))

    async def genesis(self) -> dict:
        return await self.call("genesis")

    async def consensus_params(self, height: int = 0) -> dict:
        return await self.call("consensus_params", height=str(height))

    async def tx(self, hash_: bytes) -> dict:
        return await self.call("tx", hash=hash_.hex())


def _encode_params(params: dict) -> dict:
    out = {}
    for k, v in params.items():
        if isinstance(v, bytes):
            v = base64.b64encode(v).decode()
        out[k] = v
    return out


# --- WebSocket client --------------------------------------------------------

class WSClient:
    """WebSocket JSON-RPC client with subscriptions (reference:
    rpc/client/http wsEvents)."""

    def __init__(self, address: str):
        u = urlsplit(address.replace("tcp://", "http://")
                     .replace("ws://", "http://"))
        self.host = u.hostname or "127.0.0.1"
        self.port = u.port or 26657
        self._id = 0
        self._reader: Optional[asyncio.StreamReader] = None
        self._writer: Optional[asyncio.StreamWriter] = None
        self._recv_task: Optional[asyncio.Task] = None
        self._pending: dict[object, asyncio.Future] = {}
        self._subs: dict[object, asyncio.Queue] = {}

    async def connect(self) -> None:
        import os
        self._reader, self._writer = await asyncio.open_connection(
            self.host, self.port)
        key = base64.b64encode(os.urandom(16)).decode()
        self._writer.write(
            (f"GET /websocket HTTP/1.1\r\nHost: {self.host}\r\n"
             f"Upgrade: websocket\r\nConnection: Upgrade\r\n"
             f"Sec-WebSocket-Key: {key}\r\n"
             f"Sec-WebSocket-Version: 13\r\n\r\n").encode())
        await self._writer.drain()
        status = await self._reader.readline()
        if b"101" not in status:
            raise RPCClientError(f"ws handshake failed: {status!r}")
        while True:
            line = await self._reader.readline()
            if line in (b"\r\n", b"\n", b""):
                break
        self._recv_task = asyncio.create_task(self._recv_loop())

    async def close(self) -> None:
        if self._recv_task:
            self._recv_task.cancel()
        if self._writer:
            try:
                self._writer.close()
            except Exception:
                pass

    async def _recv_loop(self) -> None:
        from .ws import OP_CLOSE, OP_PING, OP_PONG, OP_TEXT, frame, \
            read_message

        async def on_control(op, payload):
            if op == OP_PING:
                await self._send_raw(frame(OP_PONG, payload, mask=True))

        try:
            while True:
                op, data = await read_message(self._reader, on_control)
                if op == OP_CLOSE:
                    return
                if op != OP_TEXT:
                    continue
                msg = json.loads(data)
                rpc_id = msg.get("id")
                if rpc_id in self._subs and "result" in msg and \
                        isinstance(msg["result"], dict) and \
                        "query" in msg["result"]:
                    self._subs[rpc_id].put_nowait(msg["result"])
                    continue
                fut = self._pending.pop(rpc_id, None)
                if fut is not None and not fut.done():
                    if msg.get("error"):
                        fut.set_exception(RPCClientError(
                            str(msg["error"])))
                    else:
                        fut.set_result(msg.get("result"))
        except (asyncio.CancelledError, asyncio.IncompleteReadError,
                ConnectionError):
            pass
        finally:
            # connection gone: fail every caller still awaiting a reply
            # and wake subscription readers with a sentinel error
            err = RPCClientError("websocket connection closed")
            for fut in self._pending.values():
                if not fut.done():
                    fut.set_exception(err)
            self._pending.clear()
            for queue in self._subs.values():
                queue.put_nowait(_WS_CLOSED)
            self._subs.clear()

    async def _send_raw(self, data: bytes) -> None:
        self._writer.write(data)
        await self._writer.drain()

    async def call(self, method: str, **params):
        from .ws import OP_TEXT, frame
        self._id += 1
        rpc_id = self._id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rpc_id] = fut
        body = json.dumps({"jsonrpc": "2.0", "id": rpc_id,
                           "method": method, "params": params}).encode()
        await self._send_raw(frame(OP_TEXT, body, mask=True))
        return await fut

    async def subscribe(self, query: str) -> "WsSubscription":
        """Subscribe; returned object yields event payloads."""
        self._id += 1
        rpc_id = self._id
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        self._pending[rpc_id] = fut
        queue: asyncio.Queue = asyncio.Queue()
        self._subs[rpc_id] = queue
        from .ws import OP_TEXT, frame
        body = json.dumps({"jsonrpc": "2.0", "id": rpc_id,
                           "method": "subscribe",
                           "params": {"query": query}}).encode()
        await self._send_raw(frame(OP_TEXT, body, mask=True))
        await fut
        return WsSubscription(self, rpc_id, query, queue)

    async def unsubscribe(self, query: str) -> None:
        await self.call("unsubscribe", query=query)


_WS_CLOSED = object()


class WsSubscription:
    def __init__(self, client: WSClient, rpc_id, query: str,
                 queue: asyncio.Queue):
        self.client = client
        self.rpc_id = rpc_id
        self.query = query
        self._queue = queue

    async def next(self, timeout: Optional[float] = None) -> dict:
        if timeout is None:
            item = await self._queue.get()
        else:
            item = await asyncio.wait_for(self._queue.get(), timeout)
        if item is _WS_CLOSED:
            raise RPCClientError("websocket connection closed")
        return item

    def __aiter__(self) -> AsyncIterator[dict]:
        return self

    async def __anext__(self) -> dict:
        item = await self._queue.get()
        if item is _WS_CLOSED:
            raise StopAsyncIteration
        return item
