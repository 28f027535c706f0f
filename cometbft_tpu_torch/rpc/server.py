"""JSON-RPC 2.0 server over HTTP.

Reference: rpc/jsonrpc/server/ (http_json_handler.go POST dispatch,
http_uri_handler.go GET-with-query-params), rpc/core/routes.go (method
table), rpc/core/env.go (the environment of store/mempool/consensus
references the methods close over).  asyncio-native minimal HTTP/1.1 —
the RPC surface, not a general web server.

A copy of cometbft_tpu/rpc/server.py: the same parsing of POST and URI
requests, the same error codes and texts, the WebSocket upgrade and
``/metrics``.  It also holds ``max_open_connections`` (a connection
past the limit is closed unanswered) and ``max_header_bytes`` (a request
line and headers past it get a 431 and the connection is closed), which
the JAX config carries and its server leaves unread.  The metrics page
is the Prometheus text format; ``?exemplars=1`` switches it to
OpenMetrics with each histogram bucket's trace-height exemplar.

Each limit holds only when it is > 0, as in the reference: a zero
``max_open_connections`` means no limit (config.go, "0 - unlimited"),
and a zero ``max_header_bytes`` takes net/http's 1 MiB default.
``routes=`` overrides the method table: the light verifying proxy
(light/proxy.py) serves its own routes and has no node.
"""
from __future__ import annotations

import asyncio
import json
from typing import Optional
from urllib.parse import parse_qsl, urlsplit

from ..config import RPCConfig
from ..libs.log import new_logger
from . import core


class RPCError(Exception):
    def __init__(self, code: int, message: str, data: str = ""):
        super().__init__(message)
        self.code = code
        self.message = message
        self.data = data


# net/http's DefaultMaxHeaderBytes, taken for a zero max_header_bytes
DEFAULT_MAX_HEADER_BYTES = 1 << 20


class RPCServer:
    def __init__(self, node, config: RPCConfig, routes=None):
        """``node`` is anything with the attributes rpc/core's routes
        read (cometbft_tpu/node/node.py's Node names them).  ``routes``
        overrides the method table; a ``node=None`` server then has no
        Environment."""
        self.node = node
        self.config = config
        self.logger = new_logger("rpc")
        self.env = core.Environment(node) if node is not None else None
        self.routes = routes if routes is not None \
            else core.routes(self.env)
        self._server: Optional[asyncio.base_events.Server] = None
        self.listen_addr = ""
        self._ws_counter = 0
        self._open_conns = 0

    async def start(self) -> None:
        addr = self.config.laddr.replace("tcp://", "")
        host, port = addr.rsplit(":", 1)
        self._server = await asyncio.start_server(
            self._handle_conn, host or "127.0.0.1", int(port))
        sock = self._server.sockets[0].getsockname()
        self.listen_addr = f"{sock[0]}:{sock[1]}"
        self.logger.info("RPC listening", addr=self.listen_addr)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()

    @property
    def port(self) -> int:
        return int(self.listen_addr.rsplit(":", 1)[1])

    # ------------------------------------------------------------------
    async def _handle_conn(self, reader: asyncio.StreamReader,
                           writer: asyncio.StreamWriter) -> None:
        max_conns = self.config.max_open_connections
        if 0 < max_conns <= self._open_conns:
            writer.close()
            return
        max_header = self.config.max_header_bytes
        if max_header <= 0:
            max_header = DEFAULT_MAX_HEADER_BYTES
        self._open_conns += 1
        try:
            while True:
                request_line = await reader.readline()
                if not request_line:
                    return
                try:
                    method, target, _ = \
                        request_line.decode().strip().split(" ", 2)
                except ValueError:
                    return
                headers = {}
                header_bytes = len(request_line)
                while True:
                    line = await reader.readline()
                    header_bytes += len(line)
                    if header_bytes > max_header:
                        writer.write(
                            b"HTTP/1.1 431 Request Header Fields Too "
                            b"Large\r\nContent-Length: 0\r\n"
                            b"Connection: close\r\n\r\n")
                        await writer.drain()
                        return
                    if line in (b"\r\n", b"\n", b""):
                        break
                    k, _, v = line.decode().partition(":")
                    headers[k.strip().lower()] = v.strip()
                if http_method_is_metrics(method, target):
                    payload, ctype = self._render_metrics(target)
                    writer.write(
                        b"HTTP/1.1 200 OK\r\n"
                        b"Content-Type: " + ctype + b"\r\n"
                        b"Content-Length: " +
                        str(len(payload)).encode() + b"\r\n"
                        b"Connection: keep-alive\r\n\r\n" + payload)
                    await writer.drain()
                    if headers.get("connection", "").lower() == "close":
                        break
                    continue
                if headers.get("upgrade", "").lower() == "websocket":
                    # reference: ws_handler.go — the /websocket endpoint
                    from .ws import WsSession
                    self._ws_counter += 1
                    peer = writer.get_extra_info("peername")
                    remote = f"{peer}#{self._ws_counter}"
                    await WsSession(self, reader, writer, remote).run(
                        headers)
                    return
                body = b""
                clen = int(headers.get("content-length", 0) or 0)
                if clen:
                    if clen > self.config.max_body_bytes:
                        return
                    body = await reader.readexactly(clen)
                resp = await self._dispatch(method, target, body)
                payload = json.dumps(resp).encode()
                writer.write(
                    b"HTTP/1.1 200 OK\r\n"
                    b"Content-Type: application/json\r\n"
                    b"Content-Length: " +
                    str(len(payload)).encode() + b"\r\n"
                    b"Connection: keep-alive\r\n\r\n" + payload)
                await writer.drain()
                if headers.get("connection", "").lower() == "close":
                    break
        except (asyncio.IncompleteReadError, ConnectionError):
            pass
        finally:
            self._open_conns -= 1
            try:
                writer.close()
            except Exception:
                pass

    def _render_metrics(self, target: str) -> tuple[bytes, bytes]:
        """The Prometheus exposition page: the node registry merged
        with the process-global DEFAULT (the verification path's
        histograms, fed below the node seam).  ``?exemplars=1`` switches
        to OpenMetrics with per-bucket trace-height exemplars."""
        reg = getattr(self.node, "metrics_registry", None)
        if reg is None:
            return b"# metrics disabled\n", b"text/plain; version=0.0.4"
        from ..libs import metrics as libmetrics
        try:
            params = dict(parse_qsl(urlsplit(target).query))
        except ValueError:
            params = {}
        exemplars = params.get("exemplars", "") in ("1", "true")
        payload = libmetrics.render_merged(
            reg, libmetrics.DEFAULT, exemplars=exemplars).encode()
        if exemplars:
            # OpenMetrics requires the explicit EOF terminator
            return payload + b"# EOF\n", \
                b"application/openmetrics-text; version=1.0.0"
        return payload, b"text/plain; version=0.0.4"

    async def _dispatch(self, http_method: str, target: str,
                        body: bytes) -> dict:
        if http_method == "POST":
            try:
                req = json.loads(body or b"{}")
            except (json.JSONDecodeError, UnicodeDecodeError) as e:
                # invalid UTF-8 raises UnicodeDecodeError, not
                # JSONDecodeError — both are the client's parse error,
                # not a server crash (found by the input fuzzer)
                return _err_response(None, -32700,
                                     "Parse error", str(e))
            if isinstance(req, list):
                if not req:
                    # JSON-RPC 2.0: an empty batch is itself invalid
                    # and gets a single error object, not []
                    return _err_response(None, -32600,
                                         "Invalid request",
                                         "empty batch")
                return [await self._call_one(r) for r in req]
            return await self._call_one(req)
        # URI over GET: /method?param=value
        try:
            parts = urlsplit(target)
        except ValueError as e:
            # e.g. "//[" -> "Invalid IPv6 URL" (found by the fuzzer)
            return _err_response(None, -32700, "Parse error", str(e))
        name = parts.path.lstrip("/")
        if not name:
            return _err_response(
                None, -32601, "Method not found",
                "available: " + ", ".join(sorted(self.routes)))
        params = {k: _parse_uri_value(v)
                  for k, v in parse_qsl(parts.query)}
        return await self._call(name, params, rpc_id=-1)

    async def _call_one(self, req: dict) -> dict:
        if not isinstance(req, dict):
            # valid JSON that isn't a request object (e.g. `1`,
            # `"str"`, or such an element inside a batch) — JSON-RPC
            # Invalid Request, not a server crash (found by the fuzzer)
            return _err_response(None, -32600, "Invalid request",
                                 "request must be an object")
        rpc_id = req.get("id")
        name = req.get("method", "")
        if not isinstance(name, str):
            # "method" may be any JSON value on the wire (the fuzzer
            # sent a dict, which is unhashable and crashed the route
            # lookup) — JSON-RPC Invalid Request, not a server error
            return _err_response(rpc_id, -32600, "Invalid request",
                                 "method must be a string")
        params = req.get("params")
        if params is None:
            params = {}
        if isinstance(params, list):
            return _err_response(rpc_id, -32602,
                                 "Invalid params",
                                 "positional params not supported")
        if not isinstance(params, dict):
            return _err_response(rpc_id, -32602, "Invalid params",
                                 "params must be an object")
        return await self._call(name, params, rpc_id)

    async def _call(self, name: str, params: dict, rpc_id) -> dict:
        fn = self.routes.get(name)
        if fn is None:
            return _err_response(
                rpc_id, -32601, "Method not found",
                "available: " + ", ".join(sorted(self.routes)))
        try:
            result = await fn(**params)
        except RPCError as e:
            return _err_response(rpc_id, e.code, e.message, e.data)
        except TypeError as e:
            return _err_response(rpc_id, -32602, "Invalid params",
                                 str(e))
        except Exception as e:
            # correlate the client-visible error with the server log
            # line via a trace id (reference: internal/rpctrace — "ask
            # the operator about error <uuid>" without leaking
            # internals to the caller)
            import uuid
            trace = uuid.uuid4().hex[:16]
            self.logger.error("RPC method failed", method=name,
                              err=str(e), trace=trace,
                              exc_info=True)
            return _err_response(
                rpc_id, -32603, "Internal error",
                f"error trace {trace} (see server log)")
        return {"jsonrpc": "2.0", "id": rpc_id, "result": result}


def http_method_is_metrics(method: str, target: str) -> bool:
    """GET /metrics — the Prometheus exposition endpoint (reference:
    node/node.go prometheusSrv + instrumentation config)."""
    return method == "GET" and target.split("?", 1)[0] == "/metrics"


def _err_response(rpc_id, code: int, message: str,
                  data: str = "") -> dict:
    return {"jsonrpc": "2.0", "id": rpc_id,
            "error": {"code": code, "message": message, "data": data}}


def _parse_uri_value(v: str):
    """URI params: 0x-hex → bytes-as-hex-string, quoted strings
    unquoted and tagged as raw (reference: http_uri_handler parsing —
    a quoted []byte param is the raw string content, not base64)."""
    if v.startswith('"') and v.endswith('"'):
        return core.UriString(v[1:-1])
    return v
