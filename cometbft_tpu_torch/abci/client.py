"""ABCI clients over an in-process application.

Reference: abci/client/local_client.go (one mutex, so the app sees at
most one call at a time), unsync_local_client.go (no mutex) and
proxy/multi_app_conn.go (the four named connections), through
cometbft_tpu/abci/client.py.  The socket and gRPC clients and the
deadline and tracing wrappers wait for ROADMAP A.7e.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from . import types as abci


class LocalClient:
    """In-process client serializing calls with one lock.

    Reference: abci/client/local_client.go — a global mutex makes the app
    see at most one concurrent call, which is the ABCI concurrency
    contract for a single connection.
    """

    def __init__(self, app: abci.Application,
                 lock: Optional[asyncio.Lock] = None):
        self._app = app
        self._lock = lock if lock is not None else asyncio.Lock()

    async def echo(self, message: str) -> abci.EchoResponse:
        async with self._lock:
            return await self._app.echo(abci.EchoRequest(message=message))

    async def flush(self) -> None:
        return None

    async def info(self, req: abci.InfoRequest) -> abci.InfoResponse:
        async with self._lock:
            return await self._app.info(req)

    async def query(self, req: abci.QueryRequest) -> abci.QueryResponse:
        async with self._lock:
            return await self._app.query(req)

    async def check_tx(self, req: abci.CheckTxRequest
                       ) -> abci.CheckTxResponse:
        async with self._lock:
            return await self._app.check_tx(req)

    async def init_chain(self, req: abci.InitChainRequest
                         ) -> abci.InitChainResponse:
        async with self._lock:
            return await self._app.init_chain(req)

    async def prepare_proposal(self, req: abci.PrepareProposalRequest
                               ) -> abci.PrepareProposalResponse:
        async with self._lock:
            return await self._app.prepare_proposal(req)

    async def process_proposal(self, req: abci.ProcessProposalRequest
                               ) -> abci.ProcessProposalResponse:
        async with self._lock:
            return await self._app.process_proposal(req)

    async def finalize_block(self, req: abci.FinalizeBlockRequest
                             ) -> abci.FinalizeBlockResponse:
        async with self._lock:
            return await self._app.finalize_block(req)

    async def extend_vote(self, req: abci.ExtendVoteRequest
                          ) -> abci.ExtendVoteResponse:
        async with self._lock:
            return await self._app.extend_vote(req)

    async def verify_vote_extension(
            self, req: abci.VerifyVoteExtensionRequest
    ) -> abci.VerifyVoteExtensionResponse:
        async with self._lock:
            return await self._app.verify_vote_extension(req)

    async def commit(self) -> abci.CommitResponse:
        async with self._lock:
            return await self._app.commit(abci.CommitRequest())

    async def list_snapshots(self, req: abci.ListSnapshotsRequest
                             ) -> abci.ListSnapshotsResponse:
        async with self._lock:
            return await self._app.list_snapshots(req)

    async def offer_snapshot(self, req: abci.OfferSnapshotRequest
                             ) -> abci.OfferSnapshotResponse:
        async with self._lock:
            return await self._app.offer_snapshot(req)

    async def load_snapshot_chunk(self, req: abci.LoadSnapshotChunkRequest
                                  ) -> abci.LoadSnapshotChunkResponse:
        async with self._lock:
            return await self._app.load_snapshot_chunk(req)

    async def apply_snapshot_chunk(
            self, req: abci.ApplySnapshotChunkRequest
    ) -> abci.ApplySnapshotChunkResponse:
        async with self._lock:
            return await self._app.apply_snapshot_chunk(req)


class _NoopLock:
    async def __aenter__(self):
        return self

    async def __aexit__(self, *exc):
        return False


class UnsyncLocalClient(LocalClient):
    """Local client without any lock: the app handles its own
    synchronization (reference: unsync_local_client.go has no mutex)."""

    def __init__(self, app: abci.Application):
        super().__init__(app, lock=_NoopLock())


class AppConns:
    """The four named ABCI connections sharing one client.

    Reference: proxy/multi_app_conn.go — consensus/mempool/query/snapshot.
    With a local client they share one mutex (the reference's
    NewConnSyncLocalClientCreator semantics).
    """

    def __init__(self, app: abci.Application):
        lock = asyncio.Lock()
        self.consensus = LocalClient(app, lock)
        self.mempool = LocalClient(app, lock)
        self.query = LocalClient(app, lock)
        self.snapshot = LocalClient(app, lock)
