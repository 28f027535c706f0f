"""The data-companion services' bodies, without a transport.

Reference: rpc/grpc/server/services/{versionservice,blockservice,
blockresultservice,pruningservice}, through cometbft_tpu/rpc/grpc/
server.py.  Each servicer reads the stores, the event bus or the pruner
and answers the same proto dicts, or raises ``ServiceError`` with the
gRPC status name and text, that the JAX server's handlers answer or
abort with.  Nothing here imports ``grpc``: server.py wraps these
servicers in ``grpc.aio`` handlers, and a process without ``grpc``
drives them in process.
"""
from __future__ import annotations

from typing import AsyncIterator

from ... import version as ver


class ServiceError(Exception):
    """A call refused with a gRPC status (``code`` is the
    ``grpc.StatusCode`` member's name)."""

    def __init__(self, code: str, message: str):
        super().__init__(message)
        self.code = code
        self.message = message


class VersionServicer:
    """cometbft.services.version.v1.VersionService."""

    async def get_version(self, req: dict) -> dict:
        return {"node": ver.CMT_SEM_VER, "abci": ver.ABCI_SEM_VER,
                "p2p": ver.P2P_PROTOCOL, "block": ver.BLOCK_PROTOCOL}


class BlockServicer:
    """cometbft.services.block.v1.BlockService."""

    def __init__(self, block_store, event_bus=None):
        self.block_store = block_store
        self.event_bus = event_bus

    async def get_by_height(self, req: dict) -> dict:
        height = req.get("height", 0)
        store = self.block_store
        if height == 0:
            height = store.height
        if height < store.base or height > store.height:
            raise ServiceError(
                "NOT_FOUND", f"height {height} not in store "
                f"[{store.base},{store.height}]")
        block = store.load_block(height)
        meta = store.load_block_meta(height)
        if block is None or meta is None:
            raise ServiceError("NOT_FOUND", f"no block at height {height}")
        return {"block_id": meta.block_id.to_proto(),
                "block": block.to_proto()}

    async def get_latest_height(self, req: dict,
                                subscriber: str) -> AsyncIterator[dict]:
        """Long-lived stream of committed heights: the current one, then
        each new block header's (reference: blockservice
        GetLatestHeight)."""
        from ...types import events as ev
        sub = self.event_bus.subscribe(
            subscriber, ev.EVENT_QUERY_NEW_BLOCK_HEADER, out_capacity=16)
        try:
            h = self.block_store.height
            if h > 0:
                yield {"height": h}
            while True:
                msg = await sub.next()
                yield {"height": msg.data.payload["header"].height}
        finally:
            self.event_bus.unsubscribe_all(subscriber)


class BlockResultsServicer:
    """cometbft.services.block_results.v1.BlockResultsService."""

    def __init__(self, block_store, state_store):
        self.block_store = block_store
        self.state_store = state_store

    async def get_block_results(self, req: dict) -> dict:
        height = req.get("height", 0)
        if height == 0:
            height = self.block_store.height
        if height < 0 or height > self.block_store.height:
            raise ServiceError("INVALID_ARGUMENT",
                               f"height {height} out of range")
        resp = self.state_store.load_finalize_block_response(height)
        if resp is None:
            raise ServiceError("NOT_FOUND",
                               f"no results for height {height}")
        from ...abci.pb import fbr_to_proto
        d = fbr_to_proto(resp)
        return {"height": height,
                "tx_results": d.get("tx_results", []),
                "finalize_block_events": d.get("events", []),
                "validator_updates": d.get("validator_updates", []),
                **({"consensus_param_updates":
                    d["consensus_param_updates"]}
                   if d.get("consensus_param_updates") else {}),
                "app_hash": d.get("app_hash", b"")}


class PruningServicer:
    """cometbft.services.pruning.v1.PruningService (privileged): the
    block retain height and the three companion retain heights of a
    ``state.pruner.Pruner``."""

    def __init__(self, pruner):
        self.pruner = pruner

    @staticmethod
    def _set(set_fn, req: dict) -> dict:
        try:
            set_fn(req.get("height", 0))
        except ValueError as e:
            raise ServiceError("INVALID_ARGUMENT", str(e)) from None
        return {}

    async def set_block_retain_height(self, req: dict) -> dict:
        return self._set(self.pruner.set_companion_retain_height, req)

    async def get_block_retain_height(self, req: dict) -> dict:
        p = self.pruner
        return {"app_retain_height": p.get_application_retain_height(),
                "pruning_service_retain_height":
                p.get_companion_retain_height()}

    async def set_block_results_retain_height(self, req: dict) -> dict:
        return self._set(self.pruner.set_abci_results_retain_height, req)

    async def get_block_results_retain_height(self, req: dict) -> dict:
        return {"pruning_service_retain_height":
                self.pruner.get_abci_results_retain_height()}

    async def set_tx_indexer_retain_height(self, req: dict) -> dict:
        return self._set(self.pruner.set_tx_indexer_retain_height, req)

    async def get_tx_indexer_retain_height(self, req: dict) -> dict:
        return {"height": self.pruner.get_tx_indexer_retain_height()}

    async def set_block_indexer_retain_height(self, req: dict) -> dict:
        return self._set(self.pruner.set_block_indexer_retain_height, req)

    async def get_block_indexer_retain_height(self, req: dict) -> dict:
        return {"height": self.pruner.get_block_indexer_retain_height()}
