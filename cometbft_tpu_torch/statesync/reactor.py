"""Statesync reactor: snapshot discovery + chunk transfer channels.

Reference: statesync/reactor.go — SnapshotChannel 0x60 and ChunkChannel
0x61; serves snapshots from the local app, feeds the Syncer.  A copy of
cometbft_tpu/statesync/reactor.py: the four messages are byte-equal.
"""
from __future__ import annotations

from typing import Optional

from ..abci import types as abci
from ..libs.log import Logger
from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Peer, Reactor
from ..wire import encode, decode
from ..wire.proto import F, Msg
from .metrics import Metrics
from .syncer import SnapshotKey, Syncer

SNAPSHOT_CHANNEL = 0x60
CHUNK_CHANNEL = 0x61

SNAPSHOTS_REQUEST = Msg("cometbft.statesync.v1.SnapshotsRequest")
SNAPSHOTS_RESPONSE = Msg(
    "cometbft.statesync.v1.SnapshotsResponse",
    F(1, "height", "uint64"), F(2, "format", "uint32"),
    F(3, "chunks", "uint32"), F(4, "hash", "bytes"),
    F(5, "metadata", "bytes"))
CHUNK_REQUEST = Msg(
    "cometbft.statesync.v1.ChunkRequest",
    F(1, "height", "uint64"), F(2, "format", "uint32"),
    F(3, "index", "uint32"))
CHUNK_RESPONSE = Msg(
    "cometbft.statesync.v1.ChunkResponse",
    F(1, "height", "uint64"), F(2, "format", "uint32"),
    F(3, "index", "uint32"), F(4, "chunk", "bytes"),
    F(5, "missing", "bool"))
MESSAGE = Msg(
    "cometbft.statesync.v1.Message",
    F(1, "snapshots_request", "msg", msg=SNAPSHOTS_REQUEST),
    F(2, "snapshots_response", "msg", msg=SNAPSHOTS_RESPONSE),
    F(3, "chunk_request", "msg", msg=CHUNK_REQUEST),
    F(4, "chunk_response", "msg", msg=CHUNK_RESPONSE),
)


class StatesyncReactor(Reactor):
    def __init__(self, app_conns, syncer: Optional[Syncer] = None,
                 logger: Optional[Logger] = None, metrics=None):
        """syncer present = we are state-syncing; absent = serve only."""
        super().__init__("STATESYNC")
        if logger is not None:
            self.logger = logger
        self.metrics = metrics if metrics is not None else Metrics()
        self.metrics.syncing.set(1 if syncer is not None else 0)
        self.app_conns = app_conns
        self.syncer = syncer
        if syncer is not None:
            syncer.request_snapshots = self.request_snapshots
        # chunk requests round-robin across peers that offered the
        # snapshot
        self._snapshot_peers: dict[SnapshotKey, list[str]] = {}
        self._rr = 0

    def get_channels(self) -> list[ChannelDescriptor]:
        return [
            ChannelDescriptor(id=SNAPSHOT_CHANNEL, priority=5,
                              send_queue_capacity=10),
            ChannelDescriptor(id=CHUNK_CHANNEL, priority=3,
                              send_queue_capacity=16),
        ]

    async def add_peer(self, peer: Peer) -> None:
        if self.syncer is not None:
            peer.send(SNAPSHOT_CHANNEL,
                      encode(MESSAGE, {"snapshots_request": {}}))

    def request_snapshots(self) -> None:
        """Re-poll every peer's snapshot list (Syncer re-discovery
        hook: advertised snapshots age out on the serving side while
        chunks are being fetched)."""
        if self.switch is None:
            return
        for peer in list(self.switch.peers.values()):
            peer.send(SNAPSHOT_CHANNEL,
                      encode(MESSAGE, {"snapshots_request": {}}))

    async def receive(self, chan_id: int, peer: Peer,
                      msg_bytes: bytes) -> None:
        d = decode(MESSAGE, msg_bytes)
        if "snapshots_request" in d:
            res = await self.app_conns.snapshot.list_snapshots(
                abci.ListSnapshotsRequest())
            for s in res.snapshots[:10]:
                peer.send(SNAPSHOT_CHANNEL, encode(MESSAGE, {
                    "snapshots_response": {
                        **({"height": s.height} if s.height else {}),
                        **({"format": s.format} if s.format else {}),
                        **({"chunks": s.chunks} if s.chunks else {}),
                        **({"hash": s.hash} if s.hash else {}),
                        **({"metadata": s.metadata}
                           if s.metadata else {})}}))
        elif "snapshots_response" in d and self.syncer is not None:
            sr = d["snapshots_response"]
            snap = SnapshotKey(
                height=sr.get("height", 0), format=sr.get("format", 0),
                chunks=sr.get("chunks", 0), hash=sr.get("hash", b""),
                metadata=sr.get("metadata", b""))
            self.syncer.add_snapshot(peer.id, snap)
            self._snapshot_peers.setdefault(snap, [])
            if peer.id not in self._snapshot_peers[snap]:
                self._snapshot_peers[snap].append(peer.id)
        elif "chunk_request" in d:
            cr = d["chunk_request"]
            res = await self.app_conns.snapshot.load_snapshot_chunk(
                abci.LoadSnapshotChunkRequest(
                    height=cr.get("height", 0),
                    format=cr.get("format", 0),
                    chunk=cr.get("index", 0)))
            peer.send(CHUNK_CHANNEL, encode(MESSAGE, {
                "chunk_response": {
                    **({"height": cr.get("height", 0)}
                       if cr.get("height") else {}),
                    **({"format": cr.get("format", 0)}
                       if cr.get("format") else {}),
                    **({"index": cr.get("index", 0)}
                       if cr.get("index") else {}),
                    **({"chunk": res.chunk} if res.chunk else {}),
                    **({} if res.chunk else {"missing": True})}}))
        elif "chunk_response" in d and self.syncer is not None:
            cr = d["chunk_response"]
            if not cr.get("missing", False):
                self.syncer.add_chunk(
                    cr.get("height", 0), cr.get("format", 0),
                    cr.get("index", 0), cr.get("chunk", b""),
                    sender=peer.id)

    # ------------------------------------------------------------------
    def request_chunk(self, snap: SnapshotKey, index: int) -> None:
        """Chunk fetch hook for the Syncer (round-robin over the peers
        that advertised this snapshot)."""
        if self.switch is None:
            return
        peer_ids = self._snapshot_peers.get(snap, [])
        candidates = [self.switch.peers[pid] for pid in peer_ids
                      if pid in self.switch.peers]
        if not candidates:
            candidates = list(self.switch.peers.values())
        if not candidates:
            return
        self._rr += 1
        peer = candidates[self._rr % len(candidates)]
        peer.send(CHUNK_CHANNEL, encode(MESSAGE, {
            "chunk_request": {
                **({"height": snap.height} if snap.height else {}),
                **({"format": snap.format} if snap.format else {}),
                **({"index": index} if index else {})}}))
