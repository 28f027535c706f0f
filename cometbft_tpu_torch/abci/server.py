"""ABCI socket server: serve an Application to an out-of-process node.

Reference: abci/server/socket_server.go:334 — accepts connections (the node
opens one per AppConn), reads uvarint-length-delimited Request frames,
dispatches to the Application strictly in order per connection, and writes
the Response stream back.  A request that raises produces an
ExceptionResponse (reference: socket_server.go handleRequest recover).
A copy of cometbft_tpu/abci/server.py: the same frames, texts and ready
line, so a client of either package drives a server of the other.  The
app process imports nothing that touches CUDA.

Runnable stand-alone:  python -m cometbft_tpu_torch.abci.server \
    --address unix:///tmp/kvstore.sock --app kvstore
"""
from __future__ import annotations

import argparse
import asyncio
from typing import Optional
from urllib.parse import urlparse

from ..libs.log import new_logger
from . import pb
from . import types as abci


class ABCIServerError(Exception):
    pass


def parse_address(addr: str) -> tuple[str, str, int]:
    """'unix:///p' | 'tcp://h:p' | 'h:p' -> (scheme, host_or_path, port)."""
    if "://" not in addr:
        addr = "tcp://" + addr
    u = urlparse(addr)
    if u.scheme == "unix":
        return "unix", u.path or addr[len("unix://"):], 0
    if u.scheme == "tcp":
        return "tcp", u.hostname or "127.0.0.1", int(u.port or 26658)
    raise ABCIServerError(f"unsupported ABCI address scheme {u.scheme!r}")


async def read_frame(reader: asyncio.StreamReader,
                     max_size: int = pb.MAX_MSG_SIZE) -> Optional[bytes]:
    """Read one uvarint-length-delimited frame; None on clean EOF."""
    from ..libs.protoio import read_delimited
    return await read_delimited(reader, max_size, ABCIServerError)


class SocketServer:
    """Serves one Application over unix/tcp sockets."""

    def __init__(self, address: str, app: abci.Application, logger=None):
        self.address = address
        self.app = app
        self.logger = logger or new_logger("abci-server")
        self._server: Optional[asyncio.AbstractServer] = None
        self._conns: set[asyncio.Task] = set()

    async def start(self) -> None:
        scheme, host, port = parse_address(self.address)
        if scheme == "unix":
            self._server = await asyncio.start_unix_server(
                self._handle, path=host)
        else:
            self._server = await asyncio.start_server(
                self._handle, host=host, port=port)
        self.logger.info("ABCI server listening", addr=self.address)

    async def stop(self) -> None:
        if self._server is not None:
            self._server.close()
            await self._server.wait_closed()
        for t in list(self._conns):
            t.cancel()

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        assert self._server is not None
        async with self._server:
            await self._server.serve_forever()

    async def _handle(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        task = asyncio.current_task()
        if task:
            self._conns.add(task)
        try:
            while True:
                payload = await read_frame(reader)
                if payload is None:
                    return
                try:
                    req = pb.decode_request(payload)
                    resp = await self._dispatch(req)
                except Exception as e:  # noqa: BLE001 — becomes Exception resp
                    self.logger.error("ABCI request failed", err=str(e))
                    resp = abci.ExceptionResponse(error=str(e))
                writer.write(pb.encode_response_frame(resp))
                await writer.drain()
        except (asyncio.IncompleteReadError, ConnectionResetError,
                ABCIServerError):
            pass
        finally:
            if task:
                self._conns.discard(task)
            try:
                writer.close()
            except Exception:
                pass

    async def _dispatch(self, req) -> object:
        app = self.app
        t = type(req).__name__
        if t == "EchoRequest":
            return await app.echo(req)
        if t == "FlushRequest":
            return abci.FlushResponse()
        if t == "InfoRequest":
            return await app.info(req)
        if t == "InitChainRequest":
            return await app.init_chain(req)
        if t == "QueryRequest":
            return await app.query(req)
        if t == "CheckTxRequest":
            return await app.check_tx(req)
        if t == "CommitRequest":
            return await app.commit(req)
        if t == "ListSnapshotsRequest":
            return await app.list_snapshots(req)
        if t == "OfferSnapshotRequest":
            return await app.offer_snapshot(req)
        if t == "LoadSnapshotChunkRequest":
            return await app.load_snapshot_chunk(req)
        if t == "ApplySnapshotChunkRequest":
            return await app.apply_snapshot_chunk(req)
        if t == "PrepareProposalRequest":
            return await app.prepare_proposal(req)
        if t == "ProcessProposalRequest":
            return await app.process_proposal(req)
        if t == "ExtendVoteRequest":
            return await app.extend_vote(req)
        if t == "VerifyVoteExtensionRequest":
            return await app.verify_vote_extension(req)
        if t == "FinalizeBlockRequest":
            return await app.finalize_block(req)
        raise ABCIServerError(f"unknown request {t}")


def _build_app(name: str) -> abci.Application:
    if name == "kvstore":
        from .kvstore import KVStoreApplication
        return KVStoreApplication()
    if name == "noop":
        from .types import BaseApplication
        return BaseApplication()
    raise ABCIServerError(f"unknown app {name!r} (kvstore|noop)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="ABCI socket server (reference: abci-cli + "
                    "socket_server.go)")
    ap.add_argument("--address", default="unix:///tmp/abci.sock")
    ap.add_argument("--app", default="kvstore")
    ap.add_argument("--transport", default="socket",
                    choices=["socket", "grpc"])
    args = ap.parse_args(argv)
    app = _build_app(args.app)
    if args.transport == "grpc":
        from .grpc import GRPCServer
        srv = GRPCServer(args.address, app)
    else:
        srv = SocketServer(args.address, app)

    async def _serve():
        await srv.start()
        # machine-readable ready line: parents wait for this instead of
        # guessing at import/startup time (reference: e2e runner greps
        # the node's listen log line before dialing)
        print(f"abci-server listening {args.address}", flush=True)
        await srv.serve_forever()

    try:
        asyncio.run(_serve())
    except KeyboardInterrupt:
        pass
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
