"""ABCI over gRPC: out-of-process applications behind a real gRPC
channel.

Reference: proto/cometbft/abci/v2/service.proto (ABCIService — 16
unary methods), abci/client/grpc_client.go (:247) and
abci/server/grpc_server.go.  Wire messages are the bare per-method
request/response protos (not the socket protocol's Request/Response
oneof envelope); this module reuses the envelope converters in
abci/pb.py and unwraps them per method.  A copy of
cometbft_tpu/abci/grpc.py on the same generic handlers and descriptor
codec, so the bytes on the wire are the same.  It is the one module of
abci/ that imports ``grpc``; ``ClientCreator`` imports it only for the
``grpc`` transport.
"""
from __future__ import annotations

from typing import Optional

import grpc

from ..libs.log import Logger, new_logger
from ..wire import abci_pb, decode, encode
from . import pb as codec
from . import types as abci

SERVICE = "cometbft.abci.v2.ABCIService"

# gRPC method name -> (oneof key, request desc, response desc)
_METHODS = {
    "Echo": ("echo", abci_pb.ECHO_REQUEST, abci_pb.ECHO_RESPONSE),
    "Flush": ("flush", abci_pb.FLUSH_REQUEST, abci_pb.FLUSH_RESPONSE),
    "Info": ("info", abci_pb.INFO_REQUEST, abci_pb.INFO_RESPONSE),
    "CheckTx": ("check_tx", abci_pb.CHECK_TX_REQUEST,
                abci_pb.CHECK_TX_RESPONSE),
    "Query": ("query", abci_pb.QUERY_REQUEST, abci_pb.QUERY_RESPONSE),
    "Commit": ("commit", abci_pb.COMMIT_REQUEST,
               abci_pb.COMMIT_RESPONSE),
    "InitChain": ("init_chain", abci_pb.INIT_CHAIN_REQUEST,
                  abci_pb.INIT_CHAIN_RESPONSE),
    "ListSnapshots": ("list_snapshots", abci_pb.LIST_SNAPSHOTS_REQUEST,
                      abci_pb.LIST_SNAPSHOTS_RESPONSE),
    "OfferSnapshot": ("offer_snapshot", abci_pb.OFFER_SNAPSHOT_REQUEST,
                      abci_pb.OFFER_SNAPSHOT_RESPONSE),
    "LoadSnapshotChunk": ("load_snapshot_chunk",
                          abci_pb.LOAD_SNAPSHOT_CHUNK_REQUEST,
                          abci_pb.LOAD_SNAPSHOT_CHUNK_RESPONSE),
    "ApplySnapshotChunk": ("apply_snapshot_chunk",
                           abci_pb.APPLY_SNAPSHOT_CHUNK_REQUEST,
                           abci_pb.APPLY_SNAPSHOT_CHUNK_RESPONSE),
    "PrepareProposal": ("prepare_proposal",
                        abci_pb.PREPARE_PROPOSAL_REQUEST,
                        abci_pb.PREPARE_PROPOSAL_RESPONSE),
    "ProcessProposal": ("process_proposal",
                        abci_pb.PROCESS_PROPOSAL_REQUEST,
                        abci_pb.PROCESS_PROPOSAL_RESPONSE),
    "ExtendVote": ("extend_vote", abci_pb.EXTEND_VOTE_REQUEST,
                   abci_pb.EXTEND_VOTE_RESPONSE),
    "VerifyVoteExtension": ("verify_vote_extension",
                            abci_pb.VERIFY_VOTE_EXTENSION_REQUEST,
                            abci_pb.VERIFY_VOTE_EXTENSION_RESPONSE),
    "FinalizeBlock": ("finalize_block", abci_pb.FINALIZE_BLOCK_REQUEST,
                      abci_pb.FINALIZE_BLOCK_RESPONSE),
}


def _grpc_addr(addr: str) -> str:
    for prefix in ("grpc://", "tcp://"):
        if addr.startswith(prefix):
            return addr[len(prefix):]
    return addr


# ABCI payloads (blocks, snapshot chunks) routinely exceed gRPC's
# default 4 MiB cap; the reference client dials with unbounded sizes
GRPC_OPTIONS = [("grpc.max_send_message_length", -1),
                ("grpc.max_receive_message_length", -1)]


class GRPCServer:
    """Serve an Application as the reference's ABCIService
    (abci/server/grpc_server.go)."""

    def __init__(self, address: str, app: abci.Application,
                 logger: Optional[Logger] = None):
        self.address = address
        self.app = app
        self.logger = logger or new_logger("abci-grpc-server")
        self._server: Optional[grpc.aio.Server] = None
        self.port: Optional[int] = None
        self._table = {
            "InfoRequest": app.info,
            "InitChainRequest": app.init_chain,
            "QueryRequest": app.query,
            "CheckTxRequest": app.check_tx,
            "CommitRequest": app.commit,
            "ListSnapshotsRequest": app.list_snapshots,
            "OfferSnapshotRequest": app.offer_snapshot,
            "LoadSnapshotChunkRequest": app.load_snapshot_chunk,
            "ApplySnapshotChunkRequest": app.apply_snapshot_chunk,
            "PrepareProposalRequest": app.prepare_proposal,
            "ProcessProposalRequest": app.process_proposal,
            "ExtendVoteRequest": app.extend_vote,
            "VerifyVoteExtensionRequest": app.verify_vote_extension,
            "FinalizeBlockRequest": app.finalize_block,
        }

    async def start(self) -> None:
        handlers: dict[str, grpc.RpcMethodHandler] = {}
        for method, (key, req_desc, resp_desc) in _METHODS.items():
            async def handler(req_dict, ctx, _key=key):
                req = codec.request_from_proto({_key: req_dict})
                try:
                    resp = await self._dispatch(req)
                except Exception as e:
                    await ctx.abort(grpc.StatusCode.INTERNAL, str(e))
                env = codec.response_to_proto(resp)
                return next(iter(env.values())) if env else {}
            handlers[f"/{SERVICE}/{method}"] = \
                grpc.unary_unary_rpc_method_handler(
                    handler,
                    request_deserializer=(
                        lambda b, d=req_desc: decode(d, b)),
                    response_serializer=(
                        lambda m, d=resp_desc: encode(d, m)))

        class _H(grpc.GenericRpcHandler):
            def service(self, details):
                return handlers.get(details.method)

        self._server = grpc.aio.server(options=GRPC_OPTIONS)
        self._server.add_generic_rpc_handlers((_H(),))
        self.port = self._server.add_insecure_port(
            _grpc_addr(self.address))
        await self._server.start()
        self.logger.info("ABCI gRPC server listening",
                         addr=self.address, port=self.port)

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None

    async def serve_forever(self) -> None:
        if self._server is None:
            await self.start()
        await self._server.wait_for_termination()

    async def _dispatch(self, req):
        t = type(req).__name__
        if t == "EchoRequest":
            return await self.app.echo(req)
        if t == "FlushRequest":
            return abci.FlushResponse()
        fn = self._table.get(t)
        if fn is None:
            raise ValueError(f"unknown request {t}")
        return await fn(req)


class GRPCClient:
    """ABCI client over a gRPC channel, same surface as SocketClient
    (reference: abci/client/grpc_client.go)."""

    def __init__(self, address: str):
        self.address = address
        self._channel: Optional[grpc.aio.Channel] = None
        self._calls: dict = {}

    async def connect(self, timeout_s: Optional[float] = None) -> None:
        """Dial and block until the channel is READY.

        The reference dials with grpc.WaitForReady(true)
        (abci/client/grpc_client.go:109) — no fixed retry budget; the
        channel's own reconnect logic absorbs slow server startup
        (e.g. a subprocess still importing).  channel_ready() is the
        grpc.aio analog; the deadline only bounds pathological cases.
        """
        if timeout_s is None:
            import os
            timeout_s = float(os.environ.get(
                "COMETBFT_ABCI_GRPC_CONNECT_TIMEOUT", "60"))
        if self._channel is not None:
            await self.close()
        self._channel = grpc.aio.insecure_channel(
            _grpc_addr(self.address), options=GRPC_OPTIONS)
        # one multicallable per method, built once (CheckTx is the
        # per-tx hot path)
        self._calls = {
            method: self._channel.unary_unary(
                f"/{SERVICE}/{method}",
                request_serializer=(
                    lambda m, d=req_desc: encode(d, m)),
                response_deserializer=(
                    lambda b, d=resp_desc: decode(d, b)))
            for method, (key, req_desc, resp_desc)
            in _METHODS.items()
        }
        import asyncio
        try:
            await asyncio.wait_for(self._channel.channel_ready(),
                                   timeout=timeout_s)
            await self.echo("ping")
        except (asyncio.TimeoutError, grpc.aio.AioRpcError):
            await self.close()
            raise

    async def close(self) -> None:
        if self._channel is not None:
            await self._channel.close()
            self._channel = None
            self._calls = {}

    async def _call(self, method: str, req) -> object:
        key = _METHODS[method][0]
        env = codec.request_to_proto(req)
        bare = next(iter(env.values())) if env else {}
        resp_dict = await self._calls[method](bare)
        return codec.response_from_proto({key: resp_dict})

    # -- the 15-method surface + echo/flush -----------------------------
    async def echo(self, message: str) -> abci.EchoResponse:
        return await self._call("Echo", abci.EchoRequest(
            message=message))

    async def flush(self) -> None:
        await self._call("Flush", abci.FlushRequest())

    async def info(self, req): return await self._call("Info", req)

    async def query(self, req): return await self._call("Query", req)

    async def check_tx(self, req):
        return await self._call("CheckTx", req)

    async def init_chain(self, req):
        return await self._call("InitChain", req)

    async def prepare_proposal(self, req):
        return await self._call("PrepareProposal", req)

    async def process_proposal(self, req):
        return await self._call("ProcessProposal", req)

    async def finalize_block(self, req):
        return await self._call("FinalizeBlock", req)

    async def extend_vote(self, req):
        return await self._call("ExtendVote", req)

    async def verify_vote_extension(self, req):
        return await self._call("VerifyVoteExtension", req)

    async def commit(self) -> abci.CommitResponse:
        return await self._call("Commit", abci.CommitRequest())

    async def list_snapshots(self, req):
        return await self._call("ListSnapshots", req)

    async def offer_snapshot(self, req):
        return await self._call("OfferSnapshot", req)

    async def load_snapshot_chunk(self, req):
        return await self._call("LoadSnapshotChunk", req)

    async def apply_snapshot_chunk(self, req):
        return await self._call("ApplySnapshotChunk", req)


class GRPCAppConns:
    """proxy.AppConns over one shared gRPC channel (the reference's
    grpc client is connection-concurrent, so one client serves all
    four logical conns)."""

    def __init__(self, address: str):
        cli = GRPCClient(address)
        self.consensus = cli
        self.mempool = cli
        self.query = cli
        self.snapshot = cli
        self._cli = cli

    async def start(self) -> None:
        await self._cli.connect()

    async def stop(self) -> None:
        await self._cli.close()
