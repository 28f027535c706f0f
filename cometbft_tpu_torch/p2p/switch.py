"""Switch: peer lifecycle + reactor registry + broadcast.

Reference: p2p/switch.go (:867) — reactors claim channels, dial/accept
loops produce authenticated peers, Receive routes inbound messages to
the owning reactor, StopPeerForError tears down; p2p/peer.go — the
per-peer service wrapping an MConnection.

The port's copy of cometbft_tpu/p2p/switch.py: the same NodeInfo JSON
(byte-equal), the same handshake order and refusal texts, the same
persistent dial loops, every background loop under the port's
libs/supervisor.Supervisor.  The rates each MConnection meters come
from ``config.P2PConfig``.
"""
from __future__ import annotations

import asyncio
import json
from dataclasses import dataclass
from typing import Optional

from .. import version as _version
from ..config import P2PConfig
from ..libs import tracing
from ..libs.log import Logger, new_logger
from ..libs.supervisor import Supervisor
from .conn import ChannelDescriptor, MConnection
from .key import NodeKey, node_id_from_pub_key
from .secret_connection import SecretConnection


class SwitchError(Exception):
    pass


@dataclass
class NodeInfo:
    """Identity + capability advertisement exchanged at handshake.

    Reference: p2p/internal/nodeinfo/nodeinfo.go."""
    node_id: str = ""
    listen_addr: str = ""
    network: str = ""          # chain id
    version: str = _version.CMT_SEM_VER
    channels: bytes = b""
    moniker: str = "anonymous"
    block_version: int = _version.BLOCK_PROTOCOL
    p2p_version: int = _version.P2P_PROTOCOL
    # optional protocol capabilities (e.g. "txrecon/1",
    # "compactblocks/1", "votebatch/1"): purely additive negotiation —
    # a capability is USED on a link only when both sides advertise
    # it, and a peer that sends none (an older build) gets the
    # pre-capability wire behavior (flood gossip, full block parts,
    # single-vote messages).  Never part of compatible_with.
    features: tuple = ()

    def to_json(self) -> bytes:
        return json.dumps({
            "node_id": self.node_id, "listen_addr": self.listen_addr,
            "network": self.network, "version": self.version,
            "channels": self.channels.hex(), "moniker": self.moniker,
            "block_version": self.block_version,
            "p2p_version": self.p2p_version,
            "features": list(self.features),
        }).encode()

    @classmethod
    def from_json(cls, raw: bytes) -> "NodeInfo":
        d = json.loads(raw)
        return cls(node_id=d.get("node_id", ""),
                   listen_addr=d.get("listen_addr", ""),
                   network=d.get("network", ""),
                   version=d.get("version", ""),
                   channels=bytes.fromhex(d.get("channels", "")),
                   moniker=d.get("moniker", ""),
                   block_version=d.get("block_version", 0),
                   p2p_version=d.get("p2p_version", 0),
                   features=tuple(d.get("features", ())))

    def compatible_with(self, other: "NodeInfo") -> Optional[str]:
        """None when compatible, else the reason (reference:
        nodeinfo CompatibleWith)."""
        if self.block_version != other.block_version:
            return (f"peer block version {other.block_version} != "
                    f"{self.block_version}")
        if self.network != other.network:
            return f"peer network {other.network!r} != {self.network!r}"
        if not set(self.channels) & set(other.channels):
            return "no common channels"
        return None


class Peer:
    """Reference: p2p/peer.go — wraps the MConnection for one peer."""

    def __init__(self, node_info: NodeInfo, mconn: MConnection,
                 outbound: bool, remote_addr: str):
        self.node_info = node_info
        self.mconn = mconn
        self.outbound = outbound
        self.remote_addr = remote_addr
        self.data: dict = {}   # reactor-attached state (e.g. PeerState)

    @property
    def id(self) -> str:
        return self.node_info.node_id

    def has_feature(self, name: str) -> bool:
        """Did the peer advertise this capability at handshake?"""
        return name in self.node_info.features

    def send(self, channel_id: int, msg: bytes) -> bool:
        return self.mconn.send(channel_id, msg)

    async def send_blocking(self, channel_id: int, msg: bytes) -> bool:
        return await self.mconn.send_blocking(channel_id, msg)

    def close(self) -> None:
        self.mconn.close()

    def __repr__(self) -> str:
        return f"Peer{{{self.id[:12]} {self.remote_addr}}}"


class Reactor:
    """Reference: p2p/base_reactor.go:15."""

    def __init__(self, name: str):
        self.name = name
        self.switch: Optional["Switch"] = None
        self.logger = new_logger(name.lower())
        self._own_supervisor: Optional[Supervisor] = None

    @property
    def supervisor(self) -> Supervisor:
        """Every reactor background loop is supervisor-owned: a crash
        restarts the loop (with metrics) instead of silently killing
        it.  Reactors attached to a switch share its supervisor;
        standalone reactors (tests) lazily get a private one."""
        if self.switch is not None:
            return self.switch.supervisor
        if self._own_supervisor is None:
            self._own_supervisor = Supervisor(self.name.lower(),
                                              logger=self.logger)
        return self._own_supervisor

    def get_channels(self) -> list[ChannelDescriptor]:
        return []

    def get_features(self) -> list[str]:
        """Capability strings this reactor wants advertised in the
        handshake NodeInfo (config-gated; see NodeInfo.features)."""
        return []

    async def add_peer(self, peer: Peer) -> None:
        pass

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        pass

    async def receive(self, chan_id: int, peer: Peer,
                      msg_bytes: bytes) -> None:
        pass


class Switch:
    def __init__(self, node_key: NodeKey, network: str,
                 listen_addr: str = "",
                 moniker: str = "anonymous",
                 logger: Optional[Logger] = None,
                 config: Optional[P2PConfig] = None,
                 metrics=None,
                 supervisor_metrics=None):
        self.node_key = node_key
        self.network = network
        self.listen_addr = listen_addr
        self.moniker = moniker
        self.config = config if config is not None else P2PConfig()
        self.logger = logger if logger is not None else \
            new_logger("p2p")
        if metrics is None:
            from .metrics import Metrics
            metrics = Metrics()
        self.metrics = metrics
        self.reactors: dict[str, Reactor] = {}
        self._chan_to_reactor: dict[int, Reactor] = {}
        self._channel_descs: list[ChannelDescriptor] = []
        self.peers: dict[str, Peer] = {}
        self._server: Optional[asyncio.base_events.Server] = None
        self._persistent_addrs: list[str] = []
        self._dial_tasks: list = []   # SupervisedTask handles
        # peer ids whose addresses must never be gossiped via PEX
        # (reference: sw.AddPrivatePeerIDs / p2p.private_peer_ids)
        self.private_ids: set[str] = set()
        # one-for-one supervision of every switch/reactor background
        # loop; reactors reach it via Reactor.supervisor
        self.supervisor = Supervisor("p2p", logger=self.logger,
                                     metrics=supervisor_metrics)
        # test seam (nemesis/fuzz link faults): wraps the authenticated
        # secret connection before the MConnection is built —
        # conn_wrapper(sconn, peer_node_id, outbound) -> conn
        self.conn_wrapper = None
        self._stopped = False

    # ------------------------------------------------------------------
    def add_reactor(self, reactor: Reactor) -> None:
        for desc in reactor.get_channels():
            if desc.id in self._chan_to_reactor:
                raise SwitchError(
                    f"channel {desc.id:#x} already claimed")
            self._chan_to_reactor[desc.id] = reactor
            self._channel_descs.append(desc)
            # per-channel size/stall distributions exist from reactor
            # registration on, not from the first peer — a zero-peer
            # node still scrapes the full bucket ladders
            self.metrics.touch_channel(f"{desc.id:#x}")
        self.reactors[reactor.name] = reactor
        reactor.switch = self

    def node_info(self) -> NodeInfo:
        feats: set[str] = set()
        for reactor in self.reactors.values():
            feats.update(reactor.get_features())
        return NodeInfo(
            node_id=self.node_key.id,
            listen_addr=self.listen_addr,
            network=self.network,
            channels=bytes(sorted(self._chan_to_reactor)),
            moniker=self.moniker,
            features=tuple(sorted(feats)),
        )

    # ------------------------------------------------------------------
    async def start(self) -> None:
        if self.listen_addr:
            host, port = _split_addr(self.listen_addr)
            self._server = await asyncio.start_server(
                self._accept, host, port)
            addr = self._server.sockets[0].getsockname()
            self.listen_addr = f"{addr[0]}:{addr[1]}"
            self.logger.info("P2P listening", addr=self.listen_addr)

    async def stop(self) -> None:
        self._stopped = True
        await self.supervisor.stop()
        self._dial_tasks = []
        if self._server is not None:
            self._server.close()
        for peer in list(self.peers.values()):
            await self.stop_peer(peer, "switch stopping")

    @property
    def local_port(self) -> int:
        return int(self.listen_addr.rsplit(":", 1)[1])

    # ------------------------------------------------------------------
    async def dial_peer(self, addr: str) -> Peer:
        """Dial, upgrade to a secret connection, handshake, add."""
        host, port = _split_addr(addr)
        reader, writer = await asyncio.open_connection(host, port)
        try:
            return await self._upgrade(reader, writer, outbound=True,
                                       remote_addr=addr)
        except Exception:
            writer.close()
            raise

    async def _accept(self, reader: asyncio.StreamReader,
                      writer: asyncio.StreamWriter) -> None:
        peername = writer.get_extra_info("peername")
        addr = f"{peername[0]}:{peername[1]}" if peername else "?"
        try:
            await self._upgrade(reader, writer, outbound=False,
                                remote_addr=addr)
        except Exception as e:
            self.logger.info("inbound handshake failed", addr=addr,
                             err=str(e))
            writer.close()

    async def _upgrade(self, reader, writer, outbound: bool,
                       remote_addr: str) -> Peer:
        sconn = await SecretConnection.make(reader, writer,
                                            self.node_key.priv_key)
        # node info exchange
        await sconn.write_msg(self.node_info().to_json())
        their_info = NodeInfo.from_json(await sconn.read_msg())
        expected_id = node_id_from_pub_key(sconn.remote_pub_key)
        if their_info.node_id != expected_id:
            raise SwitchError(
                f"peer claimed id {their_info.node_id[:12]} but "
                f"authenticated as {expected_id[:12]}")
        reason = self.node_info().compatible_with(their_info)
        if reason is not None:
            raise SwitchError(f"incompatible peer: {reason}")
        if their_info.node_id == self.node_key.id:
            raise SwitchError("connected to self")
        if their_info.node_id in self.peers:
            raise SwitchError("duplicate peer")
        if self._stopped:
            # a handshake that finished after stop() adds no peer (and
            # starts no reactor task on the stopped supervisor);
            # reference: Switch.addPeer ignores peers once not running
            raise SwitchError("switch stopped")

        peer_holder: list[Peer] = []

        conn = sconn
        if self.conn_wrapper is not None:
            # nemesis/fuzz seam: slot link-fault wrappers between the
            # authenticated transport and the MConnection
            conn = self.conn_wrapper(sconn, their_info.node_id,
                                     outbound)

        async def on_receive(chan_id: int, msg: bytes) -> None:
            reactor = self._chan_to_reactor.get(chan_id)
            if reactor is not None and peer_holder:
                await reactor.receive(chan_id, peer_holder[0], msg)

        def on_error(e: Exception) -> None:
            if peer_holder:
                # supervised one-shot: a crash inside stop_peer is
                # metered and retried instead of vanishing with the
                # fire-and-forget task
                self.supervisor.spawn(
                    lambda: self.stop_peer(peer_holder[0], str(e)),
                    name=f"stop_peer:{their_info.node_id[:12]}",
                    kind="stop_peer")

        mconn = MConnection(conn, self._channel_descs, on_receive,
                            on_error, send_rate=self.config.send_rate,
                            recv_rate=self.config.recv_rate,
                            metrics=self.metrics,
                            peer_id=their_info.node_id)
        peer = Peer(their_info, mconn, outbound, remote_addr)
        peer_holder.append(peer)
        self.peers[peer.id] = peer
        self.metrics.peers.set(len(self.peers))
        tracing.instant(tracing.P2P, "peer_add", peer=peer.id[:12],
                        outbound=outbound)
        mconn.start()
        for reactor in self.reactors.values():
            await reactor.add_peer(peer)
        self.logger.info("Added peer", peer=peer.id[:12],
                         outbound=outbound)
        return peer

    async def stop_peer(self, peer: Peer, reason: str) -> None:
        """Reference: Switch.StopPeerForError."""
        if self.peers.pop(peer.id, None) is None:
            return
        self.metrics.peers.set(len(self.peers))
        tracing.instant(tracing.P2P, "peer_remove",
                        peer=peer.id[:12], reason=reason[:64])
        peer.close()
        for reactor in self.reactors.values():
            await reactor.remove_peer(peer, reason)
        self.logger.info("Removed peer", peer=peer.id[:12],
                         reason=reason)

    # ------------------------------------------------------------------
    def broadcast(self, channel_id: int, msg: bytes) -> None:
        """Queue to every peer (reference: Switch.Broadcast)."""
        for peer in self.peers.values():
            peer.send(channel_id, msg)

    def num_peers(self) -> int:
        return len(self.peers)

    # ------------------------------------------------------------------
    def dial_peers_async(self, addrs: list[str],
                         persistent: bool = True) -> None:
        """Background dialing with exponential backoff for persistent
        peers (reference: dial loops + reconnect).  Each dial loop is
        supervisor-owned: an uncaught exception restarts it instead of
        silently ending redials for that address."""
        for addr in addrs:
            self._dial_tasks.append(self.supervisor.spawn(
                lambda a=addr, p=persistent: self._dial_loop(a, p),
                name=f"dial:{addr}", kind="dial"))

    async def _dial_loop(self, addr: str, persistent: bool) -> None:
        """Dial with backoff; persistent peers are re-dialed forever
        after any disconnect (reference: reconnectToPeer)."""
        backoff = 0.2
        while True:
            peer = None
            try:
                peer = await self.dial_peer(addr)
            except SwitchError as e:
                if "connected to self" in str(e):
                    return
                if "duplicate peer" in str(e):
                    peer = "duplicate"
            except asyncio.CancelledError:
                raise
            except Exception as e:
                # any transport/handshake failure (ConnectionError,
                # IncompleteReadError — an EOFError, not an OSError —
                # timeouts, garbage from a mid-reset peer) must NOT
                # kill the persistent redial loop (reference:
                # reconnectToPeer retries on every error)
                self.logger.debug("dial failed", addr=addr,
                                  err=str(e))
            if peer is None:
                if not persistent:
                    return
                await asyncio.sleep(backoff)
                backoff = min(backoff * 2, 10.0)
                continue
            if not persistent:
                return
            backoff = 0.2
            # watch for disconnect, then re-dial
            peer_id = peer.id if isinstance(peer, Peer) else None
            while True:
                await asyncio.sleep(1.0)
                if peer_id is not None:
                    if peer_id not in self.peers:
                        break
                else:
                    # duplicate: find the live peer for this addr
                    if not any(p.remote_addr == addr or
                               p.node_info.listen_addr == addr
                               for p in self.peers.values()):
                        break


def _split_addr(addr: str) -> tuple[str, int]:
    addr = addr.replace("tcp://", "")
    host, port = addr.rsplit(":", 1)
    return host or "127.0.0.1", int(port)
