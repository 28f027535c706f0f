"""Evidence reactor: gossip pending evidence.

Reference: internal/evidence/reactor.go — EvidenceChannel 0x38, a
broadcast routine a peer walking the pending list — through
cometbft_tpu/evidence/reactor.py, whose message (byte-equal), channel
and texts this copy keeps.

One departure (ROADMAP.md §C): the JAX ``receive`` logs and drops every
exception as "bad evidence message".  The port drops only what a peer
can be at fault for — a message that does not decode, evidence that
does not convert (``EncodingError``: a key of an unknown type;
``BlockError``: a signed header with both commit forms), evidence the
pool refuses (``EvidenceError``) and votes that do not validate or
verify (``VoteError``).  Anything else, a kernel that does not build or
launch among them, lands in ``failure`` (``raise_if_failed()`` raises
it) and is raised, which drops the link it came on.
"""
from __future__ import annotations

import asyncio
from typing import Optional

from ..crypto.encoding import EncodingError
from ..libs.log import Logger
from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Peer, Reactor
from ..types.block import BlockError
from ..types.evidence import EvidenceError as EvidenceTypeError
from ..types.evidence import evidence_from_proto_wrapped
from ..types.vote import VoteError
from ..wire import decode, encode, pb
from ..wire.proto import F, Msg
from .pool import EvidenceError, EvidencePool

EVIDENCE_CHANNEL = 0x38
_BROADCAST_INTERVAL_S = 0.5

EVIDENCE_LIST_MSG = Msg(
    "cometbft.evidence.v2.EvidenceList",
    F(1, "evidence", "msg", msg=pb.EVIDENCE, repeated=True))


class EvidenceReactor(Reactor):
    def __init__(self, pool: EvidencePool,
                 logger: Optional[Logger] = None):
        super().__init__("EVIDENCE")
        if logger is not None:
            self.logger = logger
        self.pool = pool
        self._tasks: dict[str, object] = {}   # SupervisedTask
        # the first error receive raised that no peer can be at fault for
        self.failure: Optional[BaseException] = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=EVIDENCE_CHANNEL, priority=6,
                                  send_queue_capacity=100)]

    def raise_if_failed(self) -> None:
        if self.failure is not None:
            raise self.failure

    async def add_peer(self, peer: Peer) -> None:
        self._tasks[peer.id] = self.supervisor.spawn(
            lambda: self._broadcast_routine(peer),
            name=f"evidence_broadcast:{peer.id[:12]}",
            kind="evidence_broadcast")

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        t = self._tasks.pop(peer.id, None)
        if t is not None:
            t.cancel()

    async def receive(self, chan_id: int, peer: Peer,
                      msg_bytes: bytes) -> None:
        try:
            d = decode(EVIDENCE_LIST_MSG, msg_bytes)
            for wrapped in d.get("evidence", []):
                ev = evidence_from_proto_wrapped(wrapped)
                try:
                    self.pool.add_evidence(ev)
                except EvidenceError as e:
                    self.logger.info("rejected evidence from peer",
                                     peer=peer.id[:12], err=str(e))
        except (ValueError, EncodingError, BlockError, EvidenceTypeError,
                VoteError) as e:
            self.logger.error("bad evidence message", err=str(e))
        except Exception as e:
            if self.failure is None:
                self.failure = e
            raise

    async def _broadcast_routine(self, peer: Peer) -> None:
        sent: set[bytes] = set()
        seen_version = -1
        while True:
            if self.pool.version != seen_version:
                seen_version = self.pool.version
                pending = self.pool.all_pending()
                live = {ev.hash() for ev in pending}
                sent &= live   # forget committed and pruned evidence
                for ev in pending:
                    h = ev.hash()
                    if h in sent:
                        continue
                    if peer.send(EVIDENCE_CHANNEL, encode(
                            EVIDENCE_LIST_MSG,
                            {"evidence": [ev.to_proto_wrapped()]})):
                        sent.add(h)
            await asyncio.sleep(_BROADCAST_INTERVAL_S)
