"""gRPC data-companion clients.

Reference: rpc/grpc/client/ (Client with block/blockresults/version
services, PrivilegedClient with the pruning service).  A copy of
cometbft_tpu/rpc/grpc/client.py: the same calls and answers.
"""
from __future__ import annotations

from typing import AsyncIterator

import grpc

from ...wire import encode, decode
from .server import _grpc_addr
from . import pb


class _BaseClient:
    def __init__(self, addr: str):
        from ...abci.grpc import GRPC_OPTIONS
        self._channel = grpc.aio.insecure_channel(
            _grpc_addr(addr), options=GRPC_OPTIONS)

    async def close(self) -> None:
        await self._channel.close()

    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        await self.close()

    def _unary(self, service: str, method: str, req_desc, resp_desc):
        return self._channel.unary_unary(
            f"/{service}/{method}",
            request_serializer=lambda m: encode(req_desc, m),
            response_deserializer=lambda b: decode(resp_desc, b))

    def _stream(self, service: str, method: str, req_desc, resp_desc):
        return self._channel.unary_stream(
            f"/{service}/{method}",
            request_serializer=lambda m: encode(req_desc, m),
            response_deserializer=lambda b: decode(resp_desc, b))


class VersionServiceClient(_BaseClient):
    async def get_version(self) -> dict:
        return await self._unary(
            pb.VERSION_SERVICE, "GetVersion",
            pb.GET_VERSION_REQUEST, pb.GET_VERSION_RESPONSE)({})


class BlockServiceClient(_BaseClient):
    async def get_by_height(self, height: int = 0) -> dict:
        """Returns {"block_id": ..., "block": ...} proto dicts."""
        return await self._unary(
            pb.BLOCK_SERVICE, "GetByHeight",
            pb.GET_BY_HEIGHT_REQUEST, pb.GET_BY_HEIGHT_RESPONSE)(
                {"height": height} if height else {})

    async def get_latest_height(self) -> AsyncIterator[int]:
        """Yields committed heights until the stream is cancelled."""
        call = self._stream(
            pb.BLOCK_SERVICE, "GetLatestHeight",
            pb.GET_LATEST_HEIGHT_REQUEST,
            pb.GET_LATEST_HEIGHT_RESPONSE)({})
        async for resp in call:
            yield resp.get("height", 0)


class BlockResultsServiceClient(_BaseClient):
    async def get_block_results(self, height: int = 0) -> dict:
        return await self._unary(
            pb.BLOCK_RESULTS_SERVICE, "GetBlockResults",
            pb.GET_BLOCK_RESULTS_REQUEST,
            pb.GET_BLOCK_RESULTS_RESPONSE)(
                {"height": height} if height else {})


class PruningServiceClient(_BaseClient):
    """Privileged client (reference: rpc/grpc/client/privileged.go)."""

    async def set_block_retain_height(self, height: int) -> None:
        await self._unary(
            pb.PRUNING_SERVICE, "SetBlockRetainHeight",
            pb.SET_BLOCK_RETAIN_HEIGHT_REQUEST,
            pb.SET_BLOCK_RETAIN_HEIGHT_RESPONSE)({"height": height})

    async def get_block_retain_height(self) -> dict:
        return await self._unary(
            pb.PRUNING_SERVICE, "GetBlockRetainHeight",
            pb.GET_BLOCK_RETAIN_HEIGHT_REQUEST,
            pb.GET_BLOCK_RETAIN_HEIGHT_RESPONSE)({})

    async def set_block_results_retain_height(self, height: int) -> None:
        await self._unary(
            pb.PRUNING_SERVICE, "SetBlockResultsRetainHeight",
            pb.SET_BLOCK_RESULTS_RETAIN_HEIGHT_REQUEST,
            pb.SET_BLOCK_RESULTS_RETAIN_HEIGHT_RESPONSE)(
                {"height": height})

    async def get_block_results_retain_height(self) -> int:
        resp = await self._unary(
            pb.PRUNING_SERVICE, "GetBlockResultsRetainHeight",
            pb.GET_BLOCK_RESULTS_RETAIN_HEIGHT_REQUEST,
            pb.GET_BLOCK_RESULTS_RETAIN_HEIGHT_RESPONSE)({})
        return resp.get("pruning_service_retain_height", 0)

    async def set_tx_indexer_retain_height(self, height: int) -> None:
        await self._unary(
            pb.PRUNING_SERVICE, "SetTxIndexerRetainHeight",
            pb.SET_TX_INDEXER_RETAIN_HEIGHT_REQUEST,
            pb.SET_TX_INDEXER_RETAIN_HEIGHT_RESPONSE)(
                {"height": height})

    async def get_tx_indexer_retain_height(self) -> int:
        resp = await self._unary(
            pb.PRUNING_SERVICE, "GetTxIndexerRetainHeight",
            pb.GET_TX_INDEXER_RETAIN_HEIGHT_REQUEST,
            pb.GET_TX_INDEXER_RETAIN_HEIGHT_RESPONSE)({})
        return resp.get("height", 0)

    async def set_block_indexer_retain_height(self, height: int) -> None:
        await self._unary(
            pb.PRUNING_SERVICE, "SetBlockIndexerRetainHeight",
            pb.SET_BLOCK_INDEXER_RETAIN_HEIGHT_REQUEST,
            pb.SET_BLOCK_INDEXER_RETAIN_HEIGHT_RESPONSE)(
                {"height": height})

    async def get_block_indexer_retain_height(self) -> int:
        resp = await self._unary(
            pb.PRUNING_SERVICE, "GetBlockIndexerRetainHeight",
            pb.GET_BLOCK_INDEXER_RETAIN_HEIGHT_REQUEST,
            pb.GET_BLOCK_INDEXER_RETAIN_HEIGHT_RESPONSE)({})
        return resp.get("height", 0)
