"""WebSocket JSON-RPC: RFC-6455 framing + event subscriptions.

Reference: rpc/jsonrpc/server/ws_handler.go (wsConnection: read/write
routines, JSON-RPC over text frames) and rpc/core/events.go
(subscribe/unsubscribe/unsubscribe_all against the EventBus; events are
delivered as JSON-RPC notifications whose id is the subscribe id).

A copy of cometbft_tpu/rpc/ws.py over the port's libs/pubsub: the same
handshake, the same frames byte for byte (a client frame's mask key
aside, which is random), the same subscription payloads.
"""
from __future__ import annotations

import asyncio
import base64
import hashlib
import json
import struct

from ..libs import pubsub
from ..libs.log import new_logger

_GUID = "258EAFA5-E914-47DA-95CA-C5AB0DC85B11"

# opcodes
OP_CONT, OP_TEXT, OP_BIN, OP_CLOSE, OP_PING, OP_PONG = \
    0x0, 0x1, 0x2, 0x8, 0x9, 0xA

MAX_FRAME = 16 * 1024 * 1024


class WSError(Exception):
    pass


def accept_key(client_key: str) -> str:
    return base64.b64encode(
        hashlib.sha1((client_key + _GUID).encode()).digest()).decode()


def handshake_response(headers: dict) -> bytes:
    key = headers.get("sec-websocket-key", "")
    if not key:
        raise WSError("missing Sec-WebSocket-Key")
    return (
        b"HTTP/1.1 101 Switching Protocols\r\n"
        b"Upgrade: websocket\r\n"
        b"Connection: Upgrade\r\n"
        b"Sec-WebSocket-Accept: " + accept_key(key).encode() +
        b"\r\n\r\n")


async def read_message(reader: asyncio.StreamReader,
                       on_control=None) -> tuple[int, bytes]:
    """Read one complete (possibly fragmented) message -> (opcode, data).

    RFC 6455 permits control frames BETWEEN the fragments of a message;
    when `on_control(op, payload)` (async) is given, PING/PONG frames are
    delivered to it without discarding accumulated fragments.  OP_CLOSE
    always returns immediately — the connection is ending."""
    opcode = None
    data = b""
    while True:
        hdr = await reader.readexactly(2)
        fin = bool(hdr[0] & 0x80)
        op = hdr[0] & 0x0F
        masked = bool(hdr[1] & 0x80)
        ln = hdr[1] & 0x7F
        if ln == 126:
            ln = struct.unpack(">H", await reader.readexactly(2))[0]
        elif ln == 127:
            ln = struct.unpack(">Q", await reader.readexactly(8))[0]
        if ln > MAX_FRAME:
            raise WSError("frame too large")
        mask = await reader.readexactly(4) if masked else b""
        payload = await reader.readexactly(ln)
        if masked:
            payload = bytes(b ^ mask[i % 4]
                            for i, b in enumerate(payload))
        if op == OP_CLOSE:
            return op, payload
        if op in (OP_PING, OP_PONG):
            if on_control is not None:
                await on_control(op, payload)
                continue
            return op, payload
        if opcode is None:
            opcode = op
        data += payload
        if fin:
            return opcode, data


def frame(opcode: int, payload: bytes, mask: bool = False) -> bytes:
    """One frame; mask=True for client->server frames (RFC 6455 §5.3)."""
    import os
    hdr = bytes([0x80 | opcode])
    ln = len(payload)
    mask_bit = 0x80 if mask else 0
    if ln < 126:
        hdr += bytes([mask_bit | ln])
    elif ln < 65536:
        hdr += bytes([mask_bit | 126]) + struct.pack(">H", ln)
    else:
        hdr += bytes([mask_bit | 127]) + struct.pack(">Q", ln)
    if mask:
        key = os.urandom(4)
        payload = bytes(b ^ key[i % 4] for i, b in enumerate(payload))
        return hdr + key + payload
    return hdr + payload


class WsSession:
    """One WebSocket JSON-RPC session: normal RPC methods plus
    subscribe/unsubscribe with EventBus-driven pushes."""

    def __init__(self, server, reader: asyncio.StreamReader,
                 writer: asyncio.StreamWriter, remote: str):
        self.server = server            # RPCServer
        self.reader = reader
        self.writer = writer
        self.remote = remote
        self.logger = new_logger("rpc-ws")
        self._send_lock = asyncio.Lock()
        self._pumps: dict[str, asyncio.Task] = {}

    @property
    def _event_bus(self):
        return self.server.node.event_bus

    async def run(self, headers: dict) -> None:
        self.writer.write(handshake_response(headers))
        await self.writer.drain()
        async def on_control(op, payload):
            if op == OP_PING:
                await self._send_raw(frame(OP_PONG, payload))

        try:
            while True:
                op, data = await read_message(self.reader, on_control)
                if op == OP_CLOSE:
                    await self._send_raw(frame(OP_CLOSE, data[:2]))
                    return
                if op not in (OP_TEXT, OP_BIN):
                    continue
                try:
                    req = json.loads(data)
                except json.JSONDecodeError:
                    await self._send_json({"jsonrpc": "2.0", "id": None,
                                           "error": {"code": -32700,
                                                     "message":
                                                     "Parse error"}})
                    continue
                reqs = req if isinstance(req, list) else [req]
                for r in reqs:
                    await self._handle(r)
        except (asyncio.IncompleteReadError, ConnectionError, WSError):
            pass
        finally:
            self._teardown()

    def _teardown(self) -> None:
        for t in self._pumps.values():
            t.cancel()
        self._pumps.clear()
        try:
            self._event_bus.unsubscribe_all(self.remote)
        except Exception:
            pass

    # ------------------------------------------------------------------
    async def _handle(self, req: dict) -> None:
        rpc_id = req.get("id")
        name = req.get("method", "")
        params = req.get("params") or {}
        if name == "subscribe":
            await self._subscribe(rpc_id, params)
            return
        if name == "unsubscribe":
            await self._unsubscribe(rpc_id, params)
            return
        if name == "unsubscribe_all":
            self._teardown()
            await self._result(rpc_id, {})
            return
        resp = await self.server._call(name, params, rpc_id)
        await self._send_json(resp)

    async def _subscribe(self, rpc_id, params: dict) -> None:
        query_str = params.get("query", "")
        try:
            sub = self._event_bus.subscribe(self.remote, query_str)
        except pubsub.PubSubError as e:
            await self._error(rpc_id, -32603, str(e))
            return
        task = asyncio.create_task(self._pump(rpc_id, query_str, sub))
        self._pumps[query_str] = task
        await self._result(rpc_id, {})

    async def _unsubscribe(self, rpc_id, params: dict) -> None:
        query_str = params.get("query", "")
        task = self._pumps.pop(query_str, None)
        if task is not None:
            task.cancel()
        try:
            self._event_bus.unsubscribe(self.remote, query_str)
        except pubsub.PubSubError as e:
            await self._error(rpc_id, -32603, str(e))
            return
        await self._result(rpc_id, {})

    async def _pump(self, rpc_id, query_str: str,
                    sub: pubsub.Subscription) -> None:
        """Deliver subscription messages as JSON-RPC results carrying the
        subscribe id (reference: ws_handler writes RPCResponse with the
        subscription's original id)."""
        from .core import event_data_json
        try:
            while True:
                msg = await sub.next()
                payload = {
                    "jsonrpc": "2.0",
                    "id": rpc_id,
                    "result": {
                        "query": query_str,
                        "data": event_data_json(msg.data),
                        "events": msg.events,
                    },
                }
                await self._send_json(payload)
        except (pubsub.PubSubError, asyncio.CancelledError):
            pass
        except ConnectionError:
            pass

    # ------------------------------------------------------------------
    async def _result(self, rpc_id, result) -> None:
        await self._send_json({"jsonrpc": "2.0", "id": rpc_id,
                               "result": result})

    async def _error(self, rpc_id, code: int, message: str) -> None:
        await self._send_json({"jsonrpc": "2.0", "id": rpc_id,
                               "error": {"code": code,
                                         "message": message}})

    async def _send_json(self, obj) -> None:
        await self._send_raw(frame(OP_TEXT, json.dumps(obj).encode()))

    async def _send_raw(self, data: bytes) -> None:
        async with self._send_lock:
            self.writer.write(data)
            await self.writer.drain()
