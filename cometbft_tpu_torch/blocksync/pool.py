"""BlockPool: parallel in-flight block requests to several peers.

Reference: internal/blocksync/pool.go — one requester a height in
flight, up to 20 pending requests a peer, timeouts and bans,
PeekTwoBlocks / PopRequest for the verify-then-apply loop — through
cometbft_tpu/blocksync/pool.py, whose limits, order of requests and
texts this copy keeps.  The pool touches no device.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass
from typing import Callable, Optional

from ..libs.log import Logger, new_logger
from ..types.block import Block
from ..types.commit import ExtendedCommit

MAX_PENDING_REQUESTS_PER_PEER = 20
_REQUEST_TIMEOUT_S = 10.0
_MAX_TOTAL_REQUESTERS = 600


@dataclass
class _PoolPeer:
    peer_id: str
    base: int = 0
    height: int = 0
    num_pending: int = 0


@dataclass
class _Requester:
    height: int
    peer_id: str = ""
    block: Optional[Block] = None
    ext_commit: Optional[ExtendedCommit] = None
    requested_at: float = 0.0


class BlockPool:
    """``send_request(peer_id, height)`` is the reactor's hook; the
    reactor drives the pool through add_block / remove_peer /
    set_peer_range and the sync loop through peek / pop."""

    def __init__(self, start_height: int,
                 send_request: Callable[[str, int], bool],
                 ban_peer: Callable[[str, str], None],
                 logger: Optional[Logger] = None,
                 supervisor=None):
        self.height = start_height      # the next height to sync
        self._send_request = send_request
        self._ban_peer = ban_peer
        self.logger = logger if logger is not None else \
            new_logger("blockpool")
        self.peers: dict[str, _PoolPeer] = {}
        self.requesters: dict[int, _Requester] = {}
        self._supervisor = supervisor
        self._task = None   # asyncio.Task or SupervisedTask
        self.is_running = False
        # the requester loop waits on events (reference: pool.go
        # makeRequestersRoutine); a slow fallback tick runs the timeout
        # scan
        self._wake = asyncio.Event()
        # the verify-then-apply loop's own wakeup
        self._apply_wake = asyncio.Event()

    def _wakeup(self) -> None:
        self._wake.set()

    async def wait_apply(self, timeout: float = 0.25) -> None:
        """Park the apply loop until a block lands or the head advances
        (the fallback tick covers the caught-up transition)."""
        try:
            await asyncio.wait_for(self._apply_wake.wait(), timeout)
        except asyncio.TimeoutError:
            pass
        self._apply_wake.clear()

    # ------------------------------------------------------------------
    def start(self) -> None:
        self.is_running = True
        if self._supervisor is not None:
            self._task = self._supervisor.spawn(
                lambda: self._make_requesters_routine(),
                name="blockpool_requesters",
                kind="blockpool_requesters")
        else:
            self._task = asyncio.get_running_loop().create_task(
                self._make_requesters_routine())

    def stop(self) -> None:
        self.is_running = False
        if self._task is not None:
            self._task.cancel()

    # ------------------------------------------------------------------
    def set_peer_range(self, peer_id: str, base: int,
                       height: int) -> None:
        """Reference: SetPeerRange — from a StatusResponse."""
        p = self.peers.get(peer_id)
        if p is None:
            p = _PoolPeer(peer_id=peer_id)
            self.peers[peer_id] = p
        p.base, p.height = base, height
        self._wakeup()                    # new capacity / a taller peer

    def remove_peer(self, peer_id: str) -> None:
        self.peers.pop(peer_id, None)
        for r in self.requesters.values():
            if r.peer_id == peer_id and r.block is None:
                r.peer_id = ""
                r.requested_at = 0.0
        self._wakeup()                    # orphaned requesters to reassign

    def max_peer_height(self) -> int:
        return max((p.height for p in self.peers.values()), default=0)

    def is_caught_up(self) -> bool:
        """Reference: IsCaughtUp — at the best peer's height."""
        if not self.peers:
            return False
        return self.height >= self.max_peer_height()

    # ------------------------------------------------------------------
    def add_block(self, peer_id: str, block: Block,
                  ext_commit: Optional[ExtendedCommit],
                  block_size: int) -> None:
        """Reference: AddBlock — taken only from the peer asked."""
        r = self.requesters.get(block.header.height)
        if r is None:
            return
        if r.peer_id != peer_id:
            return
        if r.block is not None:
            return
        r.block = block
        r.ext_commit = ext_commit
        p = self.peers.get(peer_id)
        if p is not None and p.num_pending > 0:
            p.num_pending -= 1
        self._wakeup()                    # per-peer capacity freed
        self._apply_wake.set()            # two blocks may be ready now

    def redo_request(self, height: int, reason: str) -> None:
        """The block at ``height`` failed verification: ban its sender
        and ask someone else (reference: RedoRequest)."""
        r = self.requesters.get(height)
        if r is None:
            return
        if r.peer_id:
            self._ban_peer(r.peer_id, reason)
            self.remove_peer(r.peer_id)
        r.peer_id = ""
        r.block = None
        r.ext_commit = None
        r.requested_at = 0.0
        self._wakeup()

    def peek_two_blocks(self):
        """(first, second, first's extended commit) at height, height+1."""
        first = self.requesters.get(self.height)
        second = self.requesters.get(self.height + 1)
        return (first.block if first else None,
                second.block if second else None,
                first.ext_commit if first else None)

    def pop_request(self) -> None:
        """The first block was applied: advance (reference: PopRequest)."""
        self.requesters.pop(self.height, None)
        self.height += 1
        self._wakeup()                    # room for a new requester
        self._apply_wake.set()            # the next pair may be complete

    # ------------------------------------------------------------------
    async def _make_requesters_routine(self) -> None:
        while self.is_running:
            self._retry_timeouts()
            self._spawn_requesters()
            try:
                await asyncio.wait_for(self._wake.wait(), 0.25)
            except asyncio.TimeoutError:
                pass                  # fallback tick: the timeout scan
            self._wake.clear()

    def _retry_timeouts(self) -> None:
        now = time.monotonic()
        for r in list(self.requesters.values()):
            if r.block is None and r.peer_id and \
                    now - r.requested_at > _REQUEST_TIMEOUT_S:
                self.logger.info("block request timed out",
                                 height=r.height, peer=r.peer_id[:12])
                slow = r.peer_id
                self._ban_peer(slow, "block request timed out")
                self.remove_peer(slow)

    def _spawn_requesters(self) -> None:
        max_total = min(_MAX_TOTAL_REQUESTERS,
                        len(self.peers) * MAX_PENDING_REQUESTS_PER_PEER)
        next_height = self.height
        while len(self.requesters) < max_total:
            while next_height in self.requesters:
                next_height += 1
            if self.peers and next_height > self.max_peer_height():
                break
            self.requesters[next_height] = _Requester(height=next_height)
            next_height += 1
        # hand unassigned requesters to peers with room
        for r in self.requesters.values():
            if r.block is not None or r.peer_id:
                continue
            peer = self._pick_peer(r.height)
            if peer is None:
                continue
            if self._send_request(peer.peer_id, r.height):
                r.peer_id = peer.peer_id
                r.requested_at = time.monotonic()
                peer.num_pending += 1

    def _pick_peer(self, height: int) -> Optional[_PoolPeer]:
        for p in self.peers.values():
            if p.num_pending >= MAX_PENDING_REQUESTS_PER_PEER:
                continue
            if p.base <= height <= p.height:
                return p
        return None
