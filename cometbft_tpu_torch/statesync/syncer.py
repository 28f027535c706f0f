"""Statesync syncer: discover snapshots → offer → fetch chunks → apply.

Reference: statesync/syncer.go (:144 SyncAny, :236 Sync),
statesync/chunks.go (queue), statesync/stateprovider.go (light-client
backed trusted state at the snapshot height); through
cometbft_tpu/statesync/syncer.py, step for step: the same app calls, the
same light-client heights in the same order, the same texts.

``StateProvider`` wraps the port's light ``Client``, which resolves its
device when it is built (``device=None`` is the card, and raises where
CUDA is absent), so each light block the provider verifies (H+1 for the
app hash, then H, H+1 and H+2 for the state) runs its commit checks on
B1 unless the caller built the client on the CPU.  ``sync_any`` catches
only ``RejectSnapshotError``: a light-client error or a kernel that
fails ends the sync with nothing bootstrapped.
"""
from __future__ import annotations

import asyncio
import os
import shutil
import tempfile
from dataclasses import dataclass
from typing import Optional

from ..abci import types as abci
from ..libs.log import Logger, new_logger
from ..light.provider import ProviderError
from ..state.state import State as SMState, StateVersion
from ..types.block import ConsensusVersion
from ..types.commit import Commit

# the reference's defaults for its two retry bounds: discovery rounds that
# find no snapshot before sync_any gives up, and chunk-timeout rounds with
# no progress before a snapshot is rejected (syncer.go fetchChunks
# errTimeout: SyncAny tries the next snapshot instead of waiting on a
# peer that pruned it)
MAX_DISCOVERY_ROUNDS = 20
CHUNK_FETCH_ROUNDS = 4


class StatesyncError(Exception):
    pass


class RejectSnapshotError(StatesyncError):
    pass


@dataclass(frozen=True)
class SnapshotKey:
    height: int
    format: int
    chunks: int
    hash: bytes
    metadata: bytes = b""


class StateProvider:
    """Trusted state + commit at a height, via the light client
    (reference: stateprovider.go:29 — the light client runs over RPC;
    here over any light Provider)."""

    def __init__(self, light_client, chain_id: str,
                 genesis_doc):
        self.light_client = light_client
        self.chain_id = chain_id
        self.genesis_doc = genesis_doc

    async def app_hash(self, height: int) -> bytes:
        # header at height+1 carries the app hash AFTER height
        lb = await self.light_client.verify_light_block_at_height(
            height + 1)
        return lb.signed_header.header.app_hash

    async def commit(self, height: int) -> Commit:
        lb = await self.light_client.verify_light_block_at_height(
            height)
        return lb.signed_header.commit

    async def state(self, height: int) -> SMState:
        """Reconstruct sm.State at `height` (reference:
        stateprovider State)."""
        cur = await self.light_client.verify_light_block_at_height(
            height)
        nxt = await self.light_client.verify_light_block_at_height(
            height + 1)
        nxt2 = await self.light_client.verify_light_block_at_height(
            height + 2)
        state = SMState(
            version=StateVersion(consensus=ConsensusVersion(
                block=cur.signed_header.header.version.block,
                app=cur.signed_header.header.version.app)),
            chain_id=self.chain_id,
            initial_height=self.genesis_doc.initial_height,
            last_block_height=cur.height,
            # the commit AT `height` carries block `height`'s BlockID —
            # including the part-set header blocksync validates the next
            # block's Header.LastBlockID against
            last_block_id=cur.signed_header.commit.block_id,
            last_block_time=cur.signed_header.header.time,
            validators=nxt.validator_set,
            next_validators=nxt2.validator_set,
            last_validators=cur.validator_set,
            last_height_validators_changed=cur.height,
            consensus_params=self.genesis_doc.consensus_params
            .update(None),
            last_height_consensus_params_changed=(
                self.genesis_doc.initial_height),
            last_results_hash=(
                nxt.signed_header.header.last_results_hash),
            app_hash=nxt.signed_header.header.app_hash,
        )
        return state


class ChunkQueue:
    """Disk-backed chunk staging (reference: statesync/chunks.go — a
    temp-dir queue so a large snapshot never lives in process memory,
    with per-chunk sender tracking for reject_senders)."""

    def __init__(self, snap: SnapshotKey, directory: str):
        self.snap = snap
        self.dir = directory
        os.makedirs(directory, exist_ok=True)
        self._have: set[int] = set()
        self._senders: dict[int, str] = {}
        self.event = asyncio.Event()

    def _path(self, index: int) -> str:
        return os.path.join(self.dir, f"chunk-{index:06d}")

    def add(self, index: int, chunk: bytes, sender: str = "") -> bool:
        if index in self._have or not (0 <= index < self.snap.chunks):
            return False
        with open(self._path(index), "wb") as f:
            f.write(chunk)
        self._have.add(index)
        self._senders[index] = sender
        self.event.set()
        return True

    def has(self, index: int) -> bool:
        return index in self._have

    def load(self, index: int) -> bytes:
        with open(self._path(index), "rb") as f:
            return f.read()

    def sender(self, index: int) -> str:
        return self._senders.get(index, "")

    def discard(self, index: int) -> None:
        """Drop a chunk so it gets refetched (reference: chunks.go
        Discard)."""
        import os
        if index in self._have:
            self._have.discard(index)
            self._senders.pop(index, None)
            try:
                os.remove(self._path(index))
            except OSError:
                pass

    def discard_from_sender(self, sender: str) -> list[int]:
        """Drop every chunk from a banned sender (reject_senders)."""
        bad = [i for i, s in self._senders.items() if s == sender]
        for i in bad:
            self.discard(i)
        return bad

    def close(self) -> None:
        shutil.rmtree(self.dir, ignore_errors=True)


class Syncer:
    """Reference: statesync/syncer.go."""

    def __init__(self, app_conns, state_provider: StateProvider,
                 request_chunk,
                 chunk_timeout_s: float = 10.0,
                 chunk_dir: Optional[str] = None,
                 logger: Optional[Logger] = None):
        """request_chunk(snapshot, index) asks some peer for a chunk;
        results arrive via add_chunk."""
        self.app_conns = app_conns
        self.state_provider = state_provider
        self.request_chunk = request_chunk
        self.request_snapshots = None   # optional reactor hook
        self.chunk_timeout_s = chunk_timeout_s
        self.chunk_dir = chunk_dir
        self._owns_chunk_dir = chunk_dir is None
        self.logger = logger if logger is not None else \
            new_logger("statesync")
        self.snapshots: dict[SnapshotKey, set[str]] = {}
        self._queue: Optional[ChunkQueue] = None
        self.banned_senders: set[str] = set()

    # ------------------------------------------------------------------
    def add_snapshot(self, peer_id: str, snap: SnapshotKey) -> None:
        self.snapshots.setdefault(snap, set()).add(peer_id)

    def add_chunk(self, height: int, format_: int, index: int,
                  chunk: bytes, sender: str = "") -> None:
        q = self._queue
        if q is None or q.snap.height != height or \
                q.snap.format != format_:
            return
        if sender in self.banned_senders:
            return
        q.add(index, chunk, sender)

    # ------------------------------------------------------------------
    async def sync_any(self, discovery_time_s: float = 2.0
                       ) -> tuple[SMState, Commit]:
        """Try snapshots best-first until one applies; keeps
        re-discovering while none are available (reference: SyncAny
        retries discovery instead of failing on a slow peer)."""
        await asyncio.sleep(discovery_time_s)
        tried: set[SnapshotKey] = set()
        rounds = 0
        while True:
            best = self._best_snapshot(tried)
            if best is None:
                rounds += 1
                if rounds >= MAX_DISCOVERY_ROUNDS:
                    raise StatesyncError(
                        "no viable snapshots (discovered "
                        f"{len(self.snapshots)})")
                self.logger.info("no snapshots yet; rediscovering",
                                 round=rounds)
                if self.request_snapshots is not None:
                    # ask peers again — sources prune old snapshots
                    # and take new ones while we retry (reference:
                    # reactor.go re-requests on recentSnapshots)
                    self.request_snapshots()
                await asyncio.sleep(discovery_time_s)
                continue
            tried.add(best)
            try:
                return await self._sync(best)
            except RejectSnapshotError as e:
                self.logger.info("snapshot rejected; trying next",
                                 height=best.height, err=str(e))
                if self.request_snapshots is not None:
                    self.request_snapshots()
                continue

    def _best_snapshot(self, tried: set) -> Optional[SnapshotKey]:
        candidates = [s for s in self.snapshots if s not in tried]
        if not candidates:
            return None
        return max(candidates, key=lambda s: (s.height, -s.format))

    async def _sync(self, snap: SnapshotKey) -> tuple[SMState, Commit]:
        """Reference: syncer.Sync (:236)."""
        # verify the app hash for the snapshot height FIRST (trusted
        # via the light client).  A provider that cannot serve the light
        # blocks above it yet (a snapshot at the tip) drops the snapshot
        # for the next one (reference: syncer.go Sync, "failed to fetch
        # and verify app hash"); a verification failure still raises.
        try:
            app_hash = await self.state_provider.app_hash(snap.height)
        except ProviderError as e:
            raise RejectSnapshotError(
                f"failed to fetch and verify app hash: {e}") from e
        offer = await self.app_conns.snapshot.offer_snapshot(
            abci.OfferSnapshotRequest(
                snapshot=abci.Snapshot(
                    height=snap.height, format=snap.format,
                    chunks=snap.chunks, hash=snap.hash,
                    metadata=snap.metadata),
                app_hash=app_hash))
        if offer.result != abci.OFFER_SNAPSHOT_RESULT_ACCEPT:
            raise RejectSnapshotError(
                f"app rejected snapshot: {offer.result}")

        if self.chunk_dir is None:
            self.chunk_dir = tempfile.mkdtemp(
                prefix="statesync-chunks-")
        self._queue = ChunkQueue(
            snap, os.path.join(self.chunk_dir,
                               f"snap-{snap.height}-{snap.format}"))
        q = self._queue
        try:
            # parallel fetchers with per-chunk retry; chunks applied
            # strictly in order (reference: syncer.go fetchChunks +
            # applyChunks)
            applied = 0
            requested: set[int] = set()
            dry_rounds = 0
            while applied < snap.chunks:
                for i in range(snap.chunks):
                    if not q.has(i) and i not in requested:
                        self.request_chunk(snap, i)
                        requested.add(i)
                if not q.has(applied):
                    # clear BEFORE re-checking: a chunk landing between
                    # a has() miss and the clear would otherwise wipe
                    # its own wakeup and stall a full chunk_timeout_s
                    q.event.clear()
                    if not q.has(applied):
                        try:
                            await asyncio.wait_for(
                                q.event.wait(), self.chunk_timeout_s)
                            dry_rounds = 0
                        except asyncio.TimeoutError:
                            dry_rounds += 1
                            if dry_rounds >= CHUNK_FETCH_ROUNDS:
                                # the advertising peers cannot serve it
                                # anymore (pruned / gone) — reject and
                                # let sync_any pick a newer snapshot
                                raise RejectSnapshotError(
                                    "timed out waiting for chunks "
                                    f"({dry_rounds} rounds)")
                            # re-request everything missing
                            requested.clear()
                    continue
                dry_rounds = 0
                resp = await \
                    self.app_conns.snapshot.apply_snapshot_chunk(
                        abci.ApplySnapshotChunkRequest(
                            index=applied, chunk=q.load(applied),
                            sender=q.sender(applied)))
                # senders the app rejects are banned and their chunks
                # refetched (reference: syncer.go applyChunks)
                for bad in resp.reject_senders:
                    if bad:
                        self.banned_senders.add(bad)
                        for i in q.discard_from_sender(bad):
                            requested.discard(i)
                for i in resp.refetch_chunks:
                    q.discard(i)
                    requested.discard(i)
                if resp.result == \
                        abci.APPLY_SNAPSHOT_CHUNK_RESULT_ACCEPT:
                    applied += 1
                elif resp.result == \
                        abci.APPLY_SNAPSHOT_CHUNK_RESULT_RETRY:
                    q.discard(applied)
                    requested.discard(applied)
                else:
                    raise RejectSnapshotError(
                        f"chunk apply failed: {resp.result}")
        finally:
            q.close()
            self._queue = None
            if self._owns_chunk_dir and self.chunk_dir is not None:
                shutil.rmtree(self.chunk_dir, ignore_errors=True)
                self.chunk_dir = None

        # verify the app's restored state matches the trusted app hash
        info = await self.app_conns.query.info(abci.InfoRequest())
        if info.last_block_app_hash != app_hash:
            raise RejectSnapshotError(
                "restored app hash does not match trusted header")
        if info.last_block_height != snap.height:
            raise RejectSnapshotError(
                "restored app height does not match snapshot")

        state = await self.state_provider.state(snap.height)
        commit = await self.state_provider.commit(snap.height)
        self.logger.info("Snapshot restored", height=snap.height)
        return state, commit


async def new_rpc_state_provider(chain_id: str, genesis_doc,
                                 servers: list[str],
                                 trust_height: int, trust_hash: bytes,
                                 trust_period_ns: int = 168 * 3600 * 10**9,
                                 device=None) -> StateProvider:
    """StateProvider backed by a light client over real RPC servers
    (reference: stateprovider.go:29 NewLightClientStateProvider — the
    config.statesync rpc_servers + trust height/hash path).  The first
    server is the primary, the rest are witnesses.  The light client
    resolves ``device`` as the port does (None is the card), so each
    light block it verifies runs on B1 unless the caller asks for the
    CPU."""
    from ..db.db import MemDB
    from ..light.client import Client as LightClient, TrustOptions
    from ..light.provider import HttpProvider
    from ..light.store import TrustedStore

    if not servers:
        raise StatesyncError("statesync needs at least one RPC server")
    providers = [HttpProvider(addr, chain_id) for addr in servers]
    client = LightClient(
        chain_id,
        TrustOptions(period_ns=trust_period_ns, height=trust_height,
                     header_hash=trust_hash),
        providers[0], providers[1:], TrustedStore(MemDB()),
        device=device)
    await client.initialize()
    return StateProvider(client, chain_id, genesis_doc)
