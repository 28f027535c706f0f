"""Block-sync reactor: serve and fetch committed blocks.

Reference: internal/blocksync/reactor.go — BlocksyncChannel 0x40; the
first block's commit is verified with VerifyCommitLight against the
SECOND block's LastCommit, the block validated, then applied; the node
switches to consensus once caught up — through
cometbft_tpu/blocksync/reactor.py, whose five wire messages (byte-equal),
log texts and ban reasons this copy keeps.

``BlocksyncReactor(..., device=None)`` resolves its device at
construction (the card; it raises where CUDA is absent).  The sync
routine verifies on B1: ``verify_commit_light`` on the next block's
LastCommit, then ``BlockExecutor.validate_block`` on the block's own.  A
block that fails either (``VerificationError``, ``BlockValidationError``)
is asked for again from another peer, as in the JAX package.  Any other
error of the sync routine — a kernel that does not build or launch, a
store or the app failing — is not restarted (the JAX supervisor
restarts it): it stops the sync, lands in ``failure``,
``raise_if_failed()`` raises it and ``stop_sync()`` re-raises it.
"""
from __future__ import annotations

import asyncio
from typing import Callable, Optional

from ..device import resolve
from ..libs.log import Logger
from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Peer, Reactor
from ..state.state import State as SMState
from ..state.validation import BlockValidationError
from ..types.block import Block
from ..types.block_id import BlockID
from ..types.commit import CommitError, ExtendedCommit
from ..types.validation import VerificationError, verify_commit_light
from ..wire import decode, encode, pb
from ..wire.proto import F, Msg
from .metrics import Metrics
from .pool import BlockPool

BLOCKSYNC_CHANNEL = 0x40
_STATUS_UPDATE_INTERVAL_S = 2.0

BLOCK_REQUEST = Msg("cometbft.blocksync.v2.BlockRequest",
                    F(1, "height", "int64"))
NO_BLOCK_RESPONSE = Msg("cometbft.blocksync.v2.NoBlockResponse",
                        F(1, "height", "int64"))
STATUS_REQUEST = Msg("cometbft.blocksync.v2.StatusRequest")
STATUS_RESPONSE = Msg("cometbft.blocksync.v2.StatusResponse",
                      F(1, "height", "int64"), F(2, "base", "int64"))
BLOCK_RESPONSE = Msg(
    "cometbft.blocksync.v2.BlockResponse",
    F(1, "block", "msg", msg=pb.BLOCK),
    F(2, "ext_commit", "msg", msg=pb.EXTENDED_COMMIT),
)
MESSAGE = Msg(
    "cometbft.blocksync.v2.Message",
    F(1, "block_request", "msg", msg=BLOCK_REQUEST),
    F(2, "no_block_response", "msg", msg=NO_BLOCK_RESPONSE),
    F(3, "block_response", "msg", msg=BLOCK_RESPONSE),
    F(4, "status_request", "msg", msg=STATUS_REQUEST),
    F(5, "status_response", "msg", msg=STATUS_RESPONSE),
)


def _every_error(exc: BaseException) -> bool:
    """The sync routine's crashes are all fatal: the protocol errors are
    handled inside it, block by block."""
    return True


class BlocksyncReactor(Reactor):
    def __init__(self, state: SMState, block_exec, block_store,
                 active: bool,
                 on_caught_up: Optional[Callable] = None,
                 logger: Optional[Logger] = None,
                 metrics=None, device=None):
        """``on_caught_up(state, height)`` is awaited once when the sync
        completes (the node switches to consensus there — reference:
        SwitchToConsensus)."""
        super().__init__("BLOCKSYNC")
        self.device = resolve(device)   # the card unless the caller names one
        if logger is not None:
            self.logger = logger
        self.metrics = metrics if metrics is not None else Metrics()
        self.state = state
        self.block_exec = block_exec
        self.block_store = block_store
        self.active = active
        self.on_caught_up = on_caught_up
        self.pool: Optional[BlockPool] = None
        self._tasks: list = []   # SupervisedTask handles
        # the sync routine's fatal error (module docstring)
        self.failure: Optional[BaseException] = None

    def get_channels(self) -> list[ChannelDescriptor]:
        return [ChannelDescriptor(id=BLOCKSYNC_CHANNEL, priority=5,
                                  send_queue_capacity=1000)]

    # ------------------------------------------------------------------
    async def start_sync(self) -> None:
        """Begin syncing (reference: OnStart with block sync on).  The
        pool's requester loop and the status routine are restarted by
        the supervisor if they crash; the sync routine is not."""
        self.pool = BlockPool(
            self.block_store.height + 1
            if self.block_store.height else
            max(self.state.initial_height, 1),
            send_request=self._send_block_request,
            ban_peer=self._ban_peer,
            supervisor=self.supervisor)
        self.pool.start()
        self.metrics.syncing.set(1)
        self._tasks = [
            self.supervisor.spawn(lambda: self._sync_routine(),
                                  name="blocksync_sync",
                                  kind="blocksync_sync",
                                  on_giveup=self._on_giveup,
                                  fatal=_every_error),
            self.supervisor.spawn(lambda: self._status_routine(),
                                  name="blocksync_status",
                                  kind="blocksync_status"),
        ]

    def _on_giveup(self, st, exc: BaseException) -> None:
        """The sync routine failed: the sync stops here, and the error
        waits for whoever polls the reactor."""
        if self.failure is None:
            self.failure = exc
        if self.pool is not None:
            self.pool.stop()
        for t in self._tasks:
            if t is not st:
                t.cancel()

    def raise_if_failed(self) -> None:
        """Raise the error that stopped the sync, if any."""
        if self.failure is not None:
            raise self.failure

    async def stop_sync(self) -> None:
        if self.pool is not None:
            self.pool.stop()
        tasks, self._tasks = self._tasks, []
        for t in tasks:
            t.cancel()
        for t in tasks:
            try:
                await t.wait()
            except Exception as e:   # the sync routine's fatal error
                if self.failure is None:
                    self.failure = e
        self.raise_if_failed()

    # ------------------------------------------------------------------
    def _status_response(self) -> bytes:
        return encode(MESSAGE, {"status_response": {
            "height": self.block_store.height,
            "base": self.block_store.base}})

    async def add_peer(self, peer: Peer) -> None:
        # announce our range; ask for theirs
        peer.send(BLOCKSYNC_CHANNEL, self._status_response())
        if self.active:
            peer.send(BLOCKSYNC_CHANNEL,
                      encode(MESSAGE, {"status_request": {}}))

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        if self.pool is not None:
            self.pool.remove_peer(peer.id)

    async def receive(self, chan_id: int, peer: Peer,
                      msg_bytes: bytes) -> None:
        d = decode(MESSAGE, msg_bytes)
        if "block_request" in d:
            self._respond_to_block_request(
                peer, d["block_request"].get("height", 0))
        elif "status_request" in d:
            peer.send(BLOCKSYNC_CHANNEL, self._status_response())
        elif "status_response" in d and self.pool is not None:
            sr = d["status_response"]
            self.pool.set_peer_range(peer.id, sr.get("base", 0),
                                     sr.get("height", 0))
        elif "block_response" in d and self.pool is not None:
            br = d["block_response"]
            if br.get("block") is None:
                return
            block = Block.from_proto(br["block"])
            ec = ExtendedCommit.from_proto(br["ext_commit"]) \
                if br.get("ext_commit") is not None else None
            self.pool.add_block(peer.id, block, ec, len(msg_bytes))
        # no_block_response: the peer lacks it; timeouts reassign

    def _respond_to_block_request(self, peer: Peer, height: int) -> None:
        block = self.block_store.load_block(height)
        if block is None:
            peer.send(BLOCKSYNC_CHANNEL, encode(MESSAGE, {
                "no_block_response": {"height": height}}))
            return
        resp: dict = {"block": block.to_proto()}
        ec = self.block_store.load_block_ext_commit(height)
        if ec is not None:
            resp["ext_commit"] = ec.to_proto()
        peer.send(BLOCKSYNC_CHANNEL,
                  encode(MESSAGE, {"block_response": resp}))

    # ------------------------------------------------------------------
    def _send_block_request(self, peer_id: str, height: int) -> bool:
        peer = self.switch.peers.get(peer_id) if self.switch else None
        if peer is None:
            return False
        return peer.send(BLOCKSYNC_CHANNEL, encode(MESSAGE, {
            "block_request": {"height": height}}))

    def _ban_peer(self, peer_id: str, reason: str) -> None:
        if self.switch is None:
            return
        peer = self.switch.peers.get(peer_id)
        if peer is not None:
            self.supervisor.spawn(
                lambda: self.switch.stop_peer(peer, reason),
                name=f"stop_peer:{peer_id[:12]}", kind="stop_peer")

    # ------------------------------------------------------------------
    async def _status_routine(self) -> None:
        while True:
            if self.switch is not None:
                self.switch.broadcast(
                    BLOCKSYNC_CHANNEL,
                    encode(MESSAGE, {"status_request": {}}))
            await asyncio.sleep(_STATUS_UPDATE_INTERVAL_S)

    async def _sync_routine(self) -> None:
        """The verify-then-apply loop (reference: poolRoutine /
        processBlock)."""
        started = asyncio.get_running_loop().time()
        while True:
            pool = self.pool
            if pool is None:
                return
            # park until a block arrives or the head advances; the
            # 250 ms fallback drives the caught-up check
            await pool.wait_apply()
            # caught up?  Not before two status rounds have passed since
            # the sync began, so that one early low StatusResponse cannot
            # end it; after that, at the first check that finds the pool
            # caught up (reference: switchToConsensusTicker + IsCaughtUp).
            # The JAX reactor makes the caught-up state HOLD for two
            # rounds, which a net committing a block faster than a status
            # round never lets happen (ROADMAP.md section C).
            now = asyncio.get_running_loop().time()
            if pool.peers and pool.is_caught_up() and \
                    now - started > 2 * _STATUS_UPDATE_INTERVAL_S:
                self.logger.info(
                    "blocksync complete; switching to consensus",
                    height=pool.height - 1)
                await self._finish_sync(pool)
                return

            first, second, first_ext = pool.peek_two_blocks()
            if first is None or second is None:
                continue
            first_parts = first.make_part_set()
            first_id = BlockID(hash=first.hash(),
                               part_set_header=first_parts.header())
            try:
                # the second block's LastCommit certifies the first
                if second.last_commit is None:
                    raise VerificationError("missing last commit")
                verify_commit_light(
                    self.state.chain_id, self.state.validators,
                    first_id, first.header.height, second.last_commit,
                    device=self.device)
                # the commit certifies the header hash only: validate the
                # whole block before it is stored and executed
                # (reference: reactor.go:552 ValidateBlock)
                self.block_exec.validate_block(self.state, first)
            except (VerificationError, BlockValidationError) as e:
                self.logger.error("invalid block in sync",
                                  height=first.header.height, err=str(e))
                pool.redo_request(first.header.height, str(e))
                pool.redo_request(first.header.height + 1, str(e))
                continue

            seen_commit = second.last_commit
            ext_enabled = self.state.consensus_params.feature \
                .vote_extensions_enabled(first.header.height)
            if ext_enabled:
                if first_ext is None:
                    self.logger.error(
                        "peer sent block without extended commit while "
                        "extensions are enabled",
                        height=first.header.height)
                    pool.redo_request(first.header.height,
                                      "missing extended commit")
                    continue
                try:
                    # never store an extended commit that lacks extension
                    # signatures (reference: reactor.go:565)
                    first_ext.ensure_extensions(True)
                except CommitError as e:
                    self.logger.error(
                        "peer sent extended commit with missing "
                        "extension signatures",
                        height=first.header.height, err=str(e))
                    pool.redo_request(first.header.height, str(e))
                    continue
                self.block_store.save_block_with_extended_commit(
                    first, first_parts, first_ext)
            else:
                self.block_store.save_block(first, first_parts,
                                            seen_commit)
            self.state = await self.block_exec.apply_verified_block(
                self.state, first_id, first, pool.max_peer_height())
            self.metrics.latest_block_height.set(first.header.height)
            self.metrics.num_txs.set(len(first.data.txs))
            self.metrics.total_txs.add(len(first.data.txs))
            self.metrics.block_size_bytes.set(first_parts.byte_size)
            pool.pop_request()

    async def _finish_sync(self, pool) -> None:
        """Hand off to consensus WITHOUT cancelling the task running this
        method: a pending self-cancellation would abort the switch at its
        first suspension point."""
        height = pool.height - 1
        pool.stop()
        self.metrics.syncing.set(0)
        self.pool = None
        current = asyncio.current_task()
        for t in self._tasks:
            if getattr(t, "runner", t) is not current:
                t.cancel()
        self._tasks = []
        if self.on_caught_up is not None:
            await self.on_caught_up(self.state, height)
