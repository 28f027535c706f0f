"""gRPC data-companion server.

Reference: rpc/grpc/server/server.go (Serve/ServePrivileged) and the
four services under rpc/grpc/server/services/, through
cometbft_tpu/rpc/grpc/server.py.  Built on grpc.aio generic handlers —
each method is registered by full name with the descriptor codec as
(de)serializer, which keeps the wire format identical to the reference
schemas without generated stubs.  The bodies are the servicers of
services.py; this module adds the transport and turns a
``ServiceError`` into the same status and text the JAX server aborts
with.
"""
from __future__ import annotations

from typing import Optional

import grpc

from ...libs.log import Logger, new_logger
from ...wire import decode, encode
from . import pb
from .services import (BlockResultsServicer, BlockServicer,
                       PruningServicer, ServiceError, VersionServicer)


def _grpc_addr(laddr: str) -> str:
    """tcp://host:port → host:port (grpc target syntax)."""
    if "://" in laddr:
        laddr = laddr.split("://", 1)[1]
    return laddr


async def _abort(ctx, e: ServiceError):
    await ctx.abort(getattr(grpc.StatusCode, e.code), e.message)


def _unary(fn):
    async def handler(req, ctx):
        try:
            return await fn(req)
        except ServiceError as e:
            await _abort(ctx, e)
    return handler


class _Handlers(grpc.GenericRpcHandler):
    """Routes /<service>/<method> to registered method handlers."""

    def __init__(self):
        self._methods: dict[str, grpc.RpcMethodHandler] = {}

    def add_unary(self, service: str, method: str, req, resp, fn):
        self._methods[f"/{service}/{method}"] = \
            grpc.unary_unary_rpc_method_handler(
                _unary(fn),
                request_deserializer=lambda b, d=req: decode(d, b),
                response_serializer=lambda m, d=resp: encode(d, m))

    def add_server_stream(self, service: str, method: str, req, resp,
                          fn):
        self._methods[f"/{service}/{method}"] = \
            grpc.unary_stream_rpc_method_handler(
                fn,
                request_deserializer=lambda b, d=req: decode(d, b),
                response_serializer=lambda m, d=resp: encode(d, m))

    def service(self, handler_call_details):
        return self._methods.get(handler_call_details.method)


class GRPCServer:
    """One listener exposing a configured subset of the companion
    services.  The pruning service belongs on a separate privileged
    listener (reference: config.go GRPCConfig.Privileged)."""

    def __init__(self, *, block_store=None, state_store=None,
                 event_bus=None, pruner=None,
                 version_service: bool = False,
                 block_service: bool = False,
                 block_results_service: bool = False,
                 pruning_service: bool = False,
                 logger: Optional[Logger] = None):
        self.block_store = block_store
        self.state_store = state_store
        self.event_bus = event_bus
        self.pruner = pruner
        self.logger = logger or new_logger("grpc")
        self._server: Optional[grpc.aio.Server] = None
        self.port: Optional[int] = None

        self._handlers = _Handlers()
        if version_service:
            self._register_version()
        if block_service:
            self._register_block()
        if block_results_service:
            self._register_block_results()
        if pruning_service:
            self._register_pruning()

    # -- lifecycle ---------------------------------------------------------
    async def start(self, laddr: str) -> int:
        # blocks can exceed gRPC's default 4 MiB message cap
        from ...abci.grpc import GRPC_OPTIONS
        self._server = grpc.aio.server(options=GRPC_OPTIONS)
        self._server.add_generic_rpc_handlers((self._handlers,))
        self.port = self._server.add_insecure_port(_grpc_addr(laddr))
        await self._server.start()
        self.logger.info("gRPC server listening", addr=laddr,
                         port=self.port)
        return self.port

    async def stop(self) -> None:
        if self._server is not None:
            await self._server.stop(grace=1.0)
            self._server = None

    # -- services ----------------------------------------------------------
    def _register_version(self) -> None:
        svc = VersionServicer()
        self._handlers.add_unary(
            pb.VERSION_SERVICE, "GetVersion",
            pb.GET_VERSION_REQUEST, pb.GET_VERSION_RESPONSE,
            svc.get_version)

    def _register_block(self) -> None:
        svc = BlockServicer(self.block_store, self.event_bus)

        async def get_latest_height(req, ctx):
            async for msg in svc.get_latest_height(
                    req, f"grpc-latest-height-{id(ctx)}"):
                yield msg

        self._handlers.add_unary(
            pb.BLOCK_SERVICE, "GetByHeight",
            pb.GET_BY_HEIGHT_REQUEST, pb.GET_BY_HEIGHT_RESPONSE,
            svc.get_by_height)
        self._handlers.add_server_stream(
            pb.BLOCK_SERVICE, "GetLatestHeight",
            pb.GET_LATEST_HEIGHT_REQUEST, pb.GET_LATEST_HEIGHT_RESPONSE,
            get_latest_height)

    def _register_block_results(self) -> None:
        svc = BlockResultsServicer(self.block_store, self.state_store)
        self._handlers.add_unary(
            pb.BLOCK_RESULTS_SERVICE, "GetBlockResults",
            pb.GET_BLOCK_RESULTS_REQUEST, pb.GET_BLOCK_RESULTS_RESPONSE,
            svc.get_block_results)

    def _register_pruning(self) -> None:
        svc = PruningServicer(self.pruner)
        add = self._handlers.add_unary
        for method in ("SetBlockRetainHeight", "GetBlockRetainHeight",
                       "SetBlockResultsRetainHeight",
                       "GetBlockResultsRetainHeight",
                       "SetTxIndexerRetainHeight",
                       "GetTxIndexerRetainHeight",
                       "SetBlockIndexerRetainHeight",
                       "GetBlockIndexerRetainHeight"):
            snake = "".join("_" + c.lower() if c.isupper() else c
                            for c in method).lstrip("_")
            add(pb.PRUNING_SERVICE, method,
                getattr(pb, snake.upper() + "_REQUEST"),
                getattr(pb, snake.upper() + "_RESPONSE"),
                getattr(svc, snake))
