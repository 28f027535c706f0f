"""The Tendermint consensus state machine.

Reference: internal/consensus/state.go (2792 LoC) — a single receive
routine serializes ALL inputs (peer messages, internal messages,
timeouts); step functions enterNewRound → enterPropose → enterPrevote →
enterPrecommit → enterCommit → finalizeCommit; WAL-before-process;
lock/valid-block rules; PBTS timely checks; vote extensions — through
cometbft_tpu/consensus/state.py, whose ConsensusState (the step
functions, the pipelined commit, adaptive timeouts, aggregate-commit
catch-up and the compact-block arm) and log texts this copy keeps.

Here the receive routine is one asyncio task; the same serialization
invariant holds (only that task mutates RoundState).

The vote intake is also kept as module functions, each taking
explicitly what the method reads from ``self``: ``preverify_burst`` and
``append_vote_entries`` (JAX :325-391), ``preverify_votes``,
``vote_set_from_commit`` and ``vote_set_from_extended_commit``
(:591-659).  The methods call them.

Departures, each the port's no-fallback rule:

* ``ConsensusState(..., device=None)`` resolves its device at
  construction (the card; it raises where CUDA is absent) and passes it
  on: B1 pre-verifies each burst of queued votes and each restored last
  commit there, and the block executor validates every block on its own
  device.
* A failure of the batch (a kernel that does not build or launch, the
  BLS library) raises from ``preverify_burst`` and ``preverify_votes``,
  where the JAX package logs it and leaves every vote to the serial
  tally.
* The supervisor restarts the receive routine (up to 3 times) only for
  the state machine's own protocol errors (``is_fatal``).  Any other
  error — a kernel, its build, the BLS library, the stores — stops
  consensus at once and is not restarted: ``failure`` holds it,
  ``raise_if_failed()`` raises it, and ``stop()`` re-raises it after
  closing the WAL.  The pipelined apply task is never restarted, as in
  the JAX package, and its failure takes the same route.
"""
from __future__ import annotations

import asyncio
import logging
import time
from typing import Callable, Optional

from ..config import ConsensusConfig
from ..crypto.encoding import EncodingError
from ..device import resolve
from ..libs import fail
from ..libs import tracing
from ..libs.log import Logger, new_logger
from ..state.execution import BlockExecutor, provisional_next_state
from ..state.state import State as SMState
from ..state.validation import BlockValidationError
from ..types import canonical
from ..types.block import Block
from ..types.block_id import BlockID
from ..types.commit import AggregateCommit, Commit, ExtendedCommit
from ..types.events import EventBus, NopEventBus
from ..types.evidence import EvidenceError
from ..types.params import MAX_BLOCK_SIZE_BYTES, BLOCK_PART_SIZE_BYTES
from ..types.part_set import PartSet, PartSetError, PartSetHeader
from ..types.priv_validator import PrivValidator
from ..types.proposal import Proposal
from ..types.timestamp import Timestamp
from ..types.validator_set import ValidatorSet
from ..types import vote as vote_mod
from ..types.vote import Vote, VoteError
from ..types.vote_set import ConflictingVoteError, VoteSet, VoteSetError
from ..wire import pb, decode
from .height_vote_set import HeightVoteSet, HeightVoteSetError
from .messages import (
    COMPACT_MIN_TXS, AggregateCommitMessage, BlockPartMessage,
    CompactBlockPartMessage, ProposalMessage, VoteBatchMessage,
    VoteMessage, reconstruct_block_bytes,
)
from .adaptive import AdaptiveTimeouts
from .round_state import (
    STEP_COMMIT, STEP_NAMES, STEP_NEW_HEIGHT, STEP_NEW_ROUND,
    STEP_PRECOMMIT, STEP_PRECOMMIT_WAIT, STEP_PREVOTE,
    STEP_PREVOTE_WAIT, STEP_PROPOSE, RoundState, TimeoutInfo,
)
from .ticker import TimeoutTicker
from .wal import WAL, NilWAL

_TIME_IOTA_NS = 1_000_000  # minimum time increment between blocks (1ms)

_log = logging.getLogger(__name__)


class ConsensusError(Exception):
    pass


# the state machine's own protocol errors: the only crashes of the
# receive routine the supervisor restarts (see the module docstring)
_PROTOCOL_ERRORS = (ConsensusError, RoundState.TransitionError,
                    BlockValidationError, VoteSetError, HeightVoteSetError,
                    PartSetError, VoteError)


# what decoding or converting a peer's proposal block may raise: the
# block is dropped, as the reference's addProposalBlockPart returns
# BlockFromProto's error (state.go:2160-2170); no kernel runs there
_UNDECODABLE_BLOCK = (ValueError, TypeError, KeyError, AttributeError,
                      EncodingError, EvidenceError)


def is_fatal(exc: BaseException) -> bool:
    """True for every error but the state machine's own protocol errors:
    a kernel, its build, the BLS library or a store failing is never
    restarted away."""
    return not isinstance(exc, _PROTOCOL_ERRORS)


async def preverify_burst(burst, height: int, validators: ValidatorSet,
                          chain_id: str, device=None) -> None:
    """Batch-verify the signatures of the burst's VoteMessages for
    ``height`` against ``validators`` into the verified-triple memo
    (types/vote.py).  ``burst`` holds (kind, msg, peer_id) entries as
    the receive routine queues them.  The batch runs on the
    verification staging worker; this await is the verdict barrier
    after which the burst is tallied serially in arrival order."""
    entries = []
    for kind, msg, _peer in burst:
        if kind == "timeout" or not isinstance(msg, VoteMessage):
            continue
        vote = msg.vote
        if vote is None or vote.height != height:
            continue
        if (validators is None or vote.validator_index < 0 or
                vote.validator_index >= validators.size()):
            continue
        val = validators.validators[vote.validator_index]
        if (val.pub_key is None or
                val.pub_key.address() != vote.validator_address):
            continue
        append_vote_entries(entries, vote, val.pub_key, chain_id)
    if len(entries) >= 2:
        await asyncio.wrap_future(
            vote_mod.preverify_signatures_async(entries, device))


def append_vote_entries(entries, vote, pub_key, chain_id: str) -> None:
    """Append a vote's signature triples — the vote's own and, for a
    non-nil precommit carrying both, the two extension signatures.
    Never raises: a malformed vote is left for the serial path's own
    errors."""
    try:
        entries.append((pub_key, vote.sign_bytes(chain_id),
                        vote.signature))
        if (vote.type == canonical.PRECOMMIT_TYPE and
                not vote.block_id.is_nil() and
                vote.extension_signature and
                vote.non_rp_extension_signature):
            entries.append((pub_key, vote.extension_sign_bytes(chain_id),
                            vote.extension_signature))
            entries.append((pub_key, vote.non_rp_extension_sign_bytes(),
                            vote.non_rp_extension_signature))
    except Exception:
        _log.debug("vote preverify: skipping malformed vote (serial tally "
                   "will report it)", exc_info=True)


def preverify_votes(chain_id: str, vals: ValidatorSet, votes,
                    device=None) -> None:
    """Batch pre-verification of constructed votes into the memo, all
    three signatures of an extended vote.  A vote whose validator is
    not in ``vals`` is left to the serial path."""
    entries = []
    for v in votes:
        idx = vals.index_by_address(v.validator_address)
        if idx < 0:
            continue
        pub_key = vals.validators[idx].pub_key
        if pub_key is None:
            continue
        append_vote_entries(entries, v, pub_key, chain_id)
    if len(entries) >= 2:
        vote_mod.preverify_signatures(entries, device)


def vote_set_from_commit(chain_id: str, commit: Commit | AggregateCommit,
                         vals: ValidatorSet, device=None) -> VoteSet:
    """The last commit as a precommit VoteSet (reference: types
    Commit.ToVoteSet).  The votes are built once, pre-verified in one
    batch and tallied serially, each add_vote reading the memo.  An
    AggregateCommit has no per-vote signatures: it is restored as an
    aggregate-backed set (VoteSet.from_aggregate_commit)."""
    if isinstance(commit, AggregateCommit):
        return VoteSet.from_aggregate_commit(chain_id, commit, vals)
    votes = [commit.get_vote(i) for i, cs in enumerate(commit.signatures)
             if not cs.absent_flag()]
    preverify_votes(chain_id, vals, votes, device)
    vs = VoteSet(chain_id, commit.height, commit.round,
                 canonical.PRECOMMIT_TYPE, vals)
    for v in votes:
        vs.add_vote(v)
    return vs


def vote_set_from_extended_commit(chain_id: str, ec: ExtendedCommit,
                                  vals: ValidatorSet,
                                  device=None) -> VoteSet:
    """The last extended commit as an extended precommit VoteSet: every
    vote's signature and both extension signatures pre-verified in one
    batch, then tallied serially."""
    votes = [ec.get_extended_vote(i)
             for i, ecs in enumerate(ec.extended_signatures)
             if not ecs.absent_flag()]
    preverify_votes(chain_id, vals, votes, device)
    vs = VoteSet.extended(chain_id, ec.height, ec.round,
                          canonical.PRECOMMIT_TYPE, vals)
    for v in votes:
        vs.add_vote(v)
    return vs


class _PipelinedCommit:
    """One in-flight background execute/commit (docs/pipeline.md).

    ``future`` resolves to the post-apply SMState (or the apply
    failure).  Only the receive routine awaits it — the completion
    hand-off back into consensus state happens on the single-writer
    task, never from the background task itself."""

    __slots__ = ("height", "future", "task", "t0")

    def __init__(self, height: int, future: "asyncio.Future",
                 t0: float):
        self.height = height
        self.future = future
        self.task = None
        self.t0 = t0


class ConsensusState:
    """The consensus machine for one node.

    External inputs arrive via set_proposal / add_proposal_block_part /
    try_add_vote (thread-unsafe; call from the event loop) or the async
    queues used by the reactor.
    """

    def __init__(self, config: ConsensusConfig, state: SMState,
                 block_exec: BlockExecutor, block_store,
                 priv_validator: Optional[PrivValidator] = None,
                 event_bus: Optional[EventBus] = None,
                 wal: Optional[WAL] = None,
                 logger: Optional[Logger] = None,
                 metrics: Optional["Metrics"] = None,
                 supervisor=None, device=None):
        from .metrics import Metrics
        self.device = resolve(device)   # the card unless the caller names one
        # the first fatal error of a supervised task (module docstring)
        self.failure: Optional[BaseException] = None
        self.metrics = metrics if metrics is not None else Metrics()
        # when set (node wiring), the receive routine is
        # supervisor-owned: a crash restarts it (bounded) with metrics
        # instead of silently halting consensus
        self.supervisor = supervisor
        self.config = config
        self.block_exec = block_exec
        self.block_store = block_store
        self.priv_validator = priv_validator
        self.priv_validator_pub_key = \
            priv_validator.get_pub_key() if priv_validator else None
        self.event_bus = event_bus if event_bus is not None \
            else NopEventBus()
        self.wal = wal if wal is not None else NilWAL()
        self.logger = logger if logger is not None else \
            new_logger("consensus")

        self.rs = RoundState()
        self.sm_state: Optional[SMState] = None
        # pipelined commit: the one background execute/commit allowed
        # in flight (pipeline depth 1); None when the machine is fully
        # applied.  Steps that need the applied state call
        # _sync_pipeline() — the explicit barrier.
        self._pipeline: Optional[_PipelinedCommit] = None
        # measured adaptive timeouts (consensus.adaptive_timeouts):
        # fed from the same quorum-prevote-delay latch the histogram
        # records; None = static config only
        self._adaptive: Optional[AdaptiveTimeouts] = None
        if getattr(config, "adaptive_timeouts", False):
            self._adaptive = AdaptiveTimeouts(
                config.adaptive_timeout_floor_ns,
                config.adaptive_timeout_ceiling_ns)
        # highest (height, round) whose quorum-prevote delay was
        # observed: two_thirds_majority() stays true for every prevote
        # trailing the quorum — including stragglers from EARLIER
        # rounds arriving after a later round already observed — and
        # the histogram must record only the earliest quorum-achieving
        # prevote of each round, once, so the latch is monotonic
        self._quorum_delay_observed: tuple = (-1, -1)

        # one merged input queue (Go's select over the three channels is
        # unbiased, so FIFO merging preserves the semantics)
        self._input_queue: asyncio.Queue = asyncio.Queue(2000)
        self.ticker = TimeoutTicker(self._on_timeout_fired)
        self._task: Optional[asyncio.Task] = None
        self._stopped = asyncio.Event()
        self.n_steps = 0
        self.replay_mode = False
        # peers that sent a provably-invalid aggregate catchup commit
        # (each costs an O(n) pubkey sum + pairing to reject — see
        # _try_add_aggregate_commit).  Peer ids are attacker-minted
        # (fresh node key per reconnect), so this is a bounded
        # insertion-ordered dict with oldest-evicted, not a grow-only
        # set — an id churner gets one wasted verification per
        # identity either way, without growing memory
        self._agg_commit_forgers: dict = {}
        self._agg_commit_forgers_max = 1024
        # flight recorder: (height, round, step, t0_ns) of the step in
        # progress — closed into a span when the next step begins
        self._trace_step: Optional[tuple] = None
        # monotonic anchor for rs.start_time (wall): interval math on
        # it (reactor's seconds_since_start_time) must survive
        # wall-clock steps
        self._start_time_mono = time.monotonic()

        # hooks for the reactor / tests: called after state transitions
        self.on_new_step: list[Callable[[RoundState], None]] = []
        # broadcast hooks: the reactor wires these to peer gossip
        self.broadcast_hooks: list[Callable[[object], None]] = []
        # decide-proposal override (byzantine tests)
        self.decide_proposal_override: Optional[Callable] = None

        # reconstruct LastCommit from the stored seen commit BEFORE
        # updateToState (reference: NewState — reconstructLastCommit runs
        # first when LastBlockHeight > 0)
        self._reconstruct_last_commit_if_needed(state)
        self.update_to_state(state)

    # ==================================================================
    # lifecycle

    async def start(self) -> None:
        self._stopped.clear()
        if self.supervisor is None:
            # standalone (tests / light wiring): the receive routine
            # still runs supervisor-owned — a bare create_task would
            # die silently on the first uncaught exception, and the
            # bftlint supervised-spawn rule, run over the port by
            # tests/test_torch_bftlint.py, locks that invariant for
            # all reactor/node loops
            from ..libs.supervisor import Supervisor
            self.supervisor = Supervisor("consensus",
                                         logger=self.logger)
        from ..libs.supervisor import RestartPolicy
        self._task = self.supervisor.spawn(
            lambda: self._receive_routine(),
            name="consensus_receive", kind="consensus_receive",
            policy=RestartPolicy(max_restarts=3, window_s=60.0,
                                 backoff_base_s=0.05,
                                 backoff_max_s=1.0),
            on_giveup=self._on_giveup, fatal=is_fatal)
        self._schedule_round0()

    def _on_giveup(self, st, exc: BaseException) -> None:
        """A supervised task gave up or met a fatal error: consensus
        stops here, and the error waits for whoever awaits the
        machine."""
        if self.failure is None:
            self.failure = exc
        self.ticker.stop()
        self._stopped.set()

    def raise_if_failed(self) -> None:
        """Raise the fatal error that stopped consensus, if any."""
        if self.failure is not None:
            raise self.failure

    async def stop(self, drain_pipeline: bool = True) -> None:
        """``drain_pipeline=False`` models a hard crash: an in-flight
        pipelined apply is aborted instead of awaited, leaving the
        stores wherever the crash-consistency barriers put them — the
        WAL end-height record is already fsync'd, so restart recovery
        (handshake + catchup replay) re-applies the block."""
        if self._task is not None:
            self._task.cancel()
            try:
                await self._task
            except asyncio.CancelledError:
                pass
            except Exception as e:   # the fatal error, kept in failure
                if self.failure is None:
                    self.failure = e
        # drain any in-flight pipelined apply: the block is decided
        # and WAL-barriered, so letting the execute/commit finish
        # keeps the stores one-height-consistent when it can complete;
        # a failure here is already logged by the task itself
        p, self._pipeline = self._pipeline, None
        if p is not None and drain_pipeline:
            # join the TASK, not the barrier future: cancelling the
            # receive routine mid-barrier also cancelled the future
            # it was awaiting, but the background apply keeps running
            # and must be waited out (or aborted) before the stores
            # are handed to a restart
            try:
                if p.task is not None:
                    await asyncio.wait_for(p.task.wait(), 10.0)
                else:
                    await asyncio.wait_for(asyncio.shield(p.future),
                                           10.0)
            except Exception:
                self.logger.info(
                    "in-flight pipelined apply did not complete on "
                    "stop; replay/handshake re-applies the block",
                    height=p.height, exc_info=True)
                if p.task is not None:
                    p.task.cancel()
        elif p is not None:
            if p.task is not None:
                p.task.cancel()
            if not p.future.done():
                p.future.cancel()
            else:
                try:
                    p.future.exception()   # consume, never re-raised
                except asyncio.CancelledError:
                    pass
        self.ticker.stop()
        self.wal.close()
        self._stopped.set()
        self.raise_if_failed()

    # ==================================================================
    # external input API (reference: state.go AddVote/SetProposal/
    # AddProposalBlockPart — enqueue into peer/internal queues)

    def send_internal(self, msg, peer_id: str = "") -> None:
        item = ("internal", msg, peer_id)
        try:
            self._input_queue.put_nowait(item)
        except asyncio.QueueFull:
            # overload (e.g. a 900-height catchup storm filling the
            # queue with peer messages): our OWN vote/proposal must
            # never crash the receive routine — and since that
            # routine IS the consumer, blocking here would deadlock.
            # Defer the put to a supervised task; the state machine
            # re-validates on delivery, so the slight reordering is
            # benign (the nemesis catchup scenario caught the old
            # put_nowait crash wedging a node for good).
            self.logger.info(
                "consensus input queue full; deferring internal "
                "message", msg_type=type(msg).__name__)
            if self.supervisor is not None:
                self.supervisor.spawn(
                    lambda: self._input_queue.put(item),
                    name="internal_requeue",
                    kind="consensus_internal_requeue")

    def send_peer(self, msg, peer_id: str) -> None:
        self._input_queue.put_nowait(("peer", msg, peer_id))

    def _on_timeout_fired(self, ti: TimeoutInfo) -> None:
        self._input_queue.put_nowait(("timeout", ti, ""))

    # ==================================================================
    # the receive routine — the ONLY mutator of RoundState

    async def _receive_routine(self) -> None:
        while True:
            try:
                # fairness: Queue.get returns without suspending while
                # items are ready, which would starve every other task
                # (peers, RPC, watchers) on a busy chain
                await asyncio.sleep(0)
                first = await self._input_queue.get()
                # burst drain: batch-pre-verify the signatures of every
                # queued vote in one shot (TPU kernel / native MSM by
                # key type), then process the burst serially in the
                # exact arrival order — the state machine sees the same
                # sequence as unbatched processing, but vote storms pay
                # one batched verification instead of per-vote ones
                burst = [first]
                while len(burst) < 256:
                    try:
                        burst.append(self._input_queue.get_nowait())
                    except asyncio.QueueEmpty:
                        break
                if len(burst) > 1:
                    await self._preverify_burst(burst)
                for i, (kind, msg, peer_id) in enumerate(burst):
                    if i:
                        # keep the old per-message fairness yield: the
                        # handlers have no guaranteed suspension point,
                        # and a 256-message stretch would starve peers
                        await asyncio.sleep(0)
                    if kind == "timeout":
                        await self._handle_timeout(msg)
                    else:
                        await self._handle_msg(
                            msg, peer_id, internal=(kind == "internal"))
            except asyncio.CancelledError:
                raise
            except Exception:
                # reference: receiveRoutine recovers by flushing WAL then
                # re-panicking; we log and crash the task
                self.logger.error("consensus failure",
                                  exc_info=True)
                self.wal.flush_and_sync()
                raise

    async def _preverify_burst(self, burst) -> None:
        """Batch-verify the signatures of the burst's VoteMessages for
        the CURRENT height into the verified-triple memo
        (``preverify_burst``); the await is the verdict barrier after
        which the burst is tallied serially in arrival order."""
        await preverify_burst(burst, self.rs.height, self.rs.validators,
                              self.sm_state.chain_id, self.device)

    async def _handle_msg(self, msg, peer_id: str, internal: bool) -> None:
        # a vote batch unpacks into individual VoteMessages (each
        # WAL'd exactly as an unbatched peer would have logged it);
        # the batch rides the input queue as ONE entry so wire-level
        # backpressure is preserved
        if isinstance(msg, VoteBatchMessage):
            for v in msg.votes:
                await self._handle_msg(VoteMessage(v), peer_id,
                                       internal=internal)
            return

        # the compact form is never WAL'd: reconstruction feeds the
        # rebuilt parts through the normal BlockPartMessage path
        # below, so the WAL records exactly what a full-part peer
        # would have logged and replay needs no mempool
        if isinstance(msg, CompactBlockPartMessage):
            try:
                await self._apply_compact_block(msg, peer_id)
            except (PartSetError, ConsensusError) as e:
                self.logger.error("failed to apply compact block",
                                  err=str(e), peer=peer_id)
            return

        # WAL-before-process (reference: state.go:886 handleMsg; internal
        # messages are fsync'd — they may carry our own signatures).
        # During catchup replay the messages are already in the WAL.
        if not self.replay_mode:
            if internal:
                self.wal.write_sync(msg.to_wal())
            else:
                self.wal.write(msg.to_wal())

        if isinstance(msg, ProposalMessage):
            try:
                self._set_proposal(msg.proposal, Timestamp.now())
            except ConsensusError as e:
                self.logger.error("failed to set proposal", err=str(e),
                                  peer=peer_id)
        elif isinstance(msg, BlockPartMessage):
            try:
                added = await self._add_proposal_block_part(msg, peer_id)
            except (PartSetError, ConsensusError) as e:
                self.logger.error("failed to add block part",
                                  err=str(e), peer=peer_id)
        elif isinstance(msg, VoteMessage):
            try:
                await self._try_add_vote(msg.vote, peer_id)
            except (VoteSetError, HeightVoteSetError, VoteError) as e:
                self.logger.error("failed to add vote", err=str(e),
                                  peer=peer_id)
        elif isinstance(msg, AggregateCommitMessage):
            try:
                await self._try_add_aggregate_commit(msg.commit,
                                                     peer_id)
            except ConsensusError as e:
                self.logger.error("failed to add aggregate commit",
                                  err=str(e), peer=peer_id)
        else:
            self.logger.error(f"unknown msg type {type(msg)}")

    async def _handle_timeout(self, ti: TimeoutInfo) -> None:
        """Reference: state.go handleTimeout."""
        rs = self.rs
        if ti.height != rs.height or ti.round < rs.round or \
                (ti.round == rs.round and ti.step < rs.step):
            return
        # create_empty_blocks gating (reference: state.go
        # waiting-for-txs in enterPropose): with
        # create_empty_blocks=false, or an interval that has not yet
        # elapsed, an empty mempool re-arms a short poll instead of
        # burning a full propose/prevote/precommit round on an empty
        # block — at pipelined sub-second intervals the empty-block
        # churn otherwise starves real work.  Checked BEFORE the WAL
        # write so idle polls never bloat the WAL (they carry no
        # state change to replay).
        if ti.step == STEP_NEW_HEIGHT and self._should_wait_for_txs():
            self._schedule_timeout(50 * 1_000_000, ti.height, 0,
                                   STEP_NEW_HEIGHT)
            return
        if not self.replay_mode:
            self.wal.write({"type": "timeout", "height": ti.height,
                            "round": ti.round, "step": ti.step})
        if ti.step == STEP_NEW_HEIGHT:
            await self._enter_new_round(ti.height, 0)
        elif ti.step == STEP_NEW_ROUND:
            await self._enter_propose(ti.height, 0)
        elif ti.step == STEP_PROPOSE:
            self.event_bus.publish_timeout_propose(rs.event_summary())
            await self._enter_prevote(ti.height, ti.round)
        elif ti.step == STEP_PREVOTE_WAIT:
            self.event_bus.publish_timeout_wait(rs.event_summary())
            await self._enter_precommit(ti.height, ti.round)
        elif ti.step == STEP_PRECOMMIT_WAIT:
            self.event_bus.publish_timeout_wait(rs.event_summary())
            await self._enter_precommit(ti.height, ti.round)
            await self._enter_new_round(ti.height, ti.round + 1)

    # ==================================================================
    # state update

    def update_to_state(self, state: SMState) -> None:
        """Reference: state.go updateToState (:660)."""
        rs = self.rs
        if rs.commit_round > -1 and 0 < rs.height and \
                rs.height != state.last_block_height:
            raise ConsensusError(
                f"updateToState expected state height {rs.height} but "
                f"got {state.last_block_height}")
        if self.sm_state is not None and not self.sm_state.is_empty():
            if self.sm_state.last_block_height > 0 and \
                    state.last_block_height <= \
                    self.sm_state.last_block_height:
                self._new_step()
                return

        validators = state.validators
        if state.last_block_height == 0:
            rs.set_last_commit(None)
        elif rs.commit_round > -1 and rs.votes is not None:
            precommits = rs.votes.precommits(rs.commit_round)
            if not precommits.has_two_thirds_majority():
                raise ConsensusError(
                    "wanted to form a commit but precommits lack 2/3+")
            rs.set_last_commit(precommits)
        elif rs.last_commit is None:
            raise ConsensusError(
                f"last commit cannot be empty after initial block "
                f"(H:{state.last_block_height + 1})")

        height = state.last_block_height + 1
        if height == 1:
            height = state.initial_height

        next_block_delay = state.next_block_delay_ns
        if next_block_delay == 0:
            # the padding came from static config, not from the app's
            # next_block_delay decision — adaptivity may shrink it
            next_block_delay = self._commit_padding_ns()
        if rs.commit_time.is_zero():
            start_time = Timestamp.now().add_ns(next_block_delay)
        else:
            start_time = rs.commit_time.add_ns(next_block_delay)

        ext_enabled = state.consensus_params.feature \
            .vote_extensions_enabled(height)
        rs.begin_height(
            height, start_time, validators,
            HeightVoteSet(state.chain_id, height, validators,
                          extensions_enabled=ext_enabled),
            state.last_validators)
        # re-anchor: start_time is wall (a protocol-adjacent value);
        # elapsed-time consumers use the monotonic twin.  The offset
        # is SIGNED — a start_time already in the past (WAL replay,
        # slow commit) must keep reporting real elapsed time
        self._start_time_mono = time.monotonic() + \
            rs.start_time.sub(Timestamp.now()) / 1e9
        self.sm_state = state
        self._new_step()

    async def reconstruct_last_commit_off_loop(
            self, state: SMState) -> None:
        """``_reconstruct_last_commit_if_needed`` on the verification
        staging worker — the blocksync→consensus switch reconstructs
        LastCommit while the p2p loop is live, and the commit's batch
        signature verification (O(validators) native kernel work)
        must not stall it.  Safe off-thread: consensus has not
        started yet at the switch, so RoundState has no other
        writer, and the native kernels release the GIL so the loop
        keeps scheduling while the worker verifies."""
        from ..crypto import pipeline
        await pipeline.run_off_loop(
            self._reconstruct_last_commit_if_needed, state)

    def _reconstruct_last_commit_if_needed(self, state: SMState) -> None:
        """Rebuild LastCommit from the stored seen commit on restart
        (reference: state.go reconstructLastCommit :602)."""
        if state.last_block_height == 0 or self.rs.last_commit is not None:
            return
        ext_enabled = state.consensus_params.feature \
            .vote_extensions_enabled(state.last_block_height)
        if ext_enabled:
            ec = self.block_store.load_block_ext_commit(
                state.last_block_height)
            if ec is None:
                raise ConsensusError(
                    f"failed to reconstruct last extended commit; commit "
                    f"for height {state.last_block_height} not found")
            self.rs.set_last_commit(self._vote_set_from_extended_commit(
                state, ec))
        else:
            sc = self.block_store.load_seen_commit(
                state.last_block_height)
            if sc is None:
                raise ConsensusError(
                    f"failed to reconstruct last commit; seen commit for "
                    f"height {state.last_block_height} not found")
            self.rs.set_last_commit(self._vote_set_from_commit(state, sc))

    def _vote_set_from_commit(self, state: SMState,
                              commit) -> VoteSet:
        """Reference: types Commit.ToVoteSet, through
        ``vote_set_from_commit``: the votes are built once, pre-verified
        in one batch on the device and tallied serially.  An
        AggregateCommit seen commit is restored as an aggregate-backed
        set."""
        try:
            vals = self.block_exec.store.load_validators(commit.height)
        except Exception:
            self.logger.debug(
                "no stored validator set; falling back to "
                "state.last_validators", height=commit.height,
                exc_info=True)
            vals = state.last_validators
        return vote_set_from_commit(state.chain_id, commit, vals,
                                    self.device)

    def _vote_set_from_extended_commit(self, state: SMState,
                                       ec: ExtendedCommit) -> VoteSet:
        vals = self.block_exec.store.load_validators(ec.height)
        return vote_set_from_extended_commit(state.chain_id, ec, vals,
                                             self.device)

    def seconds_since_start(self) -> int:
        """Whole seconds since this height's (wall) start_time,
        measured on the monotonic clock so a wall-clock step cannot
        corrupt the interval (reactor NewRoundStep messages)."""
        return int(time.monotonic() - self._start_time_mono)

    def _trace_step_transition(self) -> None:
        """Close the in-progress step into a flight-recorder span when
        the (height, round, step) triple advances."""
        rs = self.rs
        cur = (rs.height, rs.round, rs.step)
        prev = self._trace_step
        if prev is not None and (prev[0], prev[1], prev[2]) == cur:
            return                     # re-announce of the same step
        now = tracing.now_ns()
        if prev is not None:
            tracing.record_span(
                tracing.CONSENSUS,
                f"step:{STEP_NAMES.get(prev[2], '?')}",
                prev[3], now, height=prev[0], round=prev[1])
        self._trace_step = (*cur, now)

    def _new_step(self) -> None:
        self.wal.write({"type": "round_state",
                        **self.rs.event_summary()})
        self.n_steps += 1
        # height context first and unconditionally: other categories
        # (crypto/p2p/abci) rely on it even when the consensus
        # category itself is filtered out
        tracing.set_height(self.rs.height)
        if tracing.enabled(tracing.CONSENSUS):
            self._trace_step_transition()
        self.event_bus.publish_new_round_step(self.rs.event_summary())
        self.metrics.mark_step(self.rs)
        for hook in self.on_new_step:
            hook(self.rs)

    # ==================================================================
    # timeouts / round scheduling

    def _schedule_round0(self) -> None:
        sleep_ns = max(0, self.rs.start_time.sub(Timestamp.now()))
        self._schedule_timeout(sleep_ns, self.rs.height, 0,
                               STEP_NEW_HEIGHT)

    def _schedule_timeout(self, duration_ns: int, height: int,
                          round_: int, step: int) -> None:
        self.ticker.schedule_timeout(
            TimeoutInfo(duration_ns, height, round_, step))

    # ------------------------------------------------------------------
    # timeout derivation: measured-adaptive when enabled AND the
    # quorum-delay EWMA has data; the static config otherwise.  The
    # per-round escalation deltas always come from the static config
    # so liveness under asynchrony is unchanged (docs/pipeline.md).

    def _propose_timeout_ns(self, round_: int) -> int:
        if self._adaptive is not None:
            base = self._adaptive.propose_timeout_ns()
            if base is not None:
                return base + \
                    self.config.timeout_propose_delta_ns * round_
        return self.config.propose_timeout_ns(round_)

    def _vote_wait_timeout_ns(self, round_: int) -> int:
        if self._adaptive is not None:
            base = self._adaptive.vote_timeout_ns()
            if base is not None:
                return base + self.config.timeout_vote_delta_ns * round_
        return self.config.prevote_timeout_ns(round_)

    def _commit_padding_ns(self) -> int:
        """Static commit padding, adaptively shrunk when measured
        quorum delays say the net is faster than the config."""
        padding = self.config.timeout_commit_ns
        if self._adaptive is not None:
            padding = self._adaptive.commit_padding_ns(padding)
        return padding

    def _should_wait_for_txs(self) -> bool:
        """True while round 0 of a fresh height should hold off
        proposing because the pool is empty (config.wait_for_txs):
        create_empty_blocks=false waits indefinitely; a nonzero
        create_empty_blocks_interval waits until the interval since
        the height's start_time has elapsed.  Replay never waits (the
        WAL drives it), and only round 0 is gated — once any round
        ran, liveness wins."""
        if self.replay_mode or self.rs.round != 0:
            return False
        if not self.config.wait_for_txs():
            return False
        mp = getattr(self.block_exec, "mempool", None)
        if mp is None or mp.size() > 0:
            return False
        if not self.config.create_empty_blocks:
            return True
        interval_s = self.config.create_empty_blocks_interval_ns / 1e9
        return (time.monotonic() - self._start_time_mono) < interval_s

    # ==================================================================
    # step: NewRound

    async def _enter_new_round(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step != STEP_NEW_HEIGHT):
            return
        validators = rs.validators
        if rs.round < round_:
            validators = validators.copy()
            validators.increment_proposer_priority(round_ - rs.round)
        rs.begin_round(round_, validators)
        self.metrics.mark_round(round_)
        self.event_bus.publish_new_round(rs.event_summary())
        await self._enter_propose(height, round_)

    # ==================================================================
    # step: Propose

    def _is_proposer(self, address: bytes) -> bool:
        return self.rs.validators.get_proposer().address == address

    async def _enter_propose(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PROPOSE):
            return

        async def done() -> None:
            rs.advance(round_, STEP_PROPOSE)
            self._new_step()
            if self._is_proposal_complete():
                await self._enter_prevote(height, rs.round)

        self._schedule_timeout(
            self._propose_timeout_ns(round_), height, round_,
            STEP_PROPOSE)

        if self.priv_validator is None or \
                self.priv_validator_pub_key is None:
            await done()
            return
        addr = self.priv_validator_pub_key.address()
        if not rs.validators.has_address(addr):
            await done()
            return
        if self._is_proposer(addr):
            if self.decide_proposal_override is not None:
                self.decide_proposal_override(height, round_)
            else:
                await self._decide_proposal(height, round_)
        await done()

    async def _decide_proposal(self, height: int, round_: int) -> None:
        """Reference: defaultDecideProposal."""
        # pipeline barrier: the proposer needs the previous height's
        # app hash / results hash in the new block's header — wait out
        # any in-flight execute/commit before reaping and building
        await self._sync_pipeline()
        rs = self.rs
        if rs.height != height or round_ < rs.round:
            return   # the machine moved on while we waited
        if rs.valid_block is not None:
            block, block_parts = rs.valid_block, rs.valid_block_parts
        else:
            block = await self._create_proposal_block()
            if block is None:
                return
            block_parts = block.make_part_set(BLOCK_PART_SIZE_BYTES)

        self.wal.flush_and_sync()
        prop_block_id = BlockID(hash=block.hash(),
                                part_set_header=block_parts.header())
        proposal = Proposal(
            height=height, round=round_, pol_round=rs.valid_round,
            block_id=prop_block_id, timestamp=block.header.time)
        try:
            await self._pv_sign_proposal(proposal)
            self.metrics.proposal_create_count.add()
        except Exception as e:
            if not self.replay_mode:
                self.logger.error("failed signing proposal",
                                  height=height, err=str(e))
            return
        self.send_internal(ProposalMessage(proposal))
        for i in range(block_parts.total):
            self.send_internal(BlockPartMessage(
                height=rs.height, round=rs.round,
                part=block_parts.get_part(i)))
        self._broadcast(ProposalMessage(proposal))
        # first-sent marker: the proposer-side t0 the fleet report
        # pairs with every other node's proposal_recv (first-seen) to
        # measure proposal propagation per link
        tracing.instant(tracing.CONSENSUS, "proposal_broadcast",
                        height=height, round=round_,
                        parts=block_parts.total,
                        txs=len(block.data.txs))
        # compact-block relay (docs/gossip.md): peers that negotiated
        # it get skeleton + tx hashes and rebuild the parts from
        # their mempool; the part broadcasts below skip them for the
        # grace window, falling back to full parts on a nack or when
        # the grace expires.  Small blocks always ship as parts, and
        # so does every round > 0: a churning round means the fast
        # path already failed once — full parts, no reconstruct race
        # (the recon-gossip nemesis scenario wedged on exactly that
        # under aggressive timeouts).
        if rs.round == 0 and len(block.data.txs) >= COMPACT_MIN_TXS:
            self._broadcast(("compact_block", rs.height, rs.round,
                             block, block_parts.header()))
        for i in range(block_parts.total):
            self._broadcast(BlockPartMessage(
                height=rs.height, round=rs.round,
                part=block_parts.get_part(i)))

    async def _create_proposal_block(self) -> Optional[Block]:
        """Reference: createProposalBlock (sync wrapper over the async
        executor call — the receive routine runs in the loop, so the
        ABCI local client call is executed inline)."""
        rs = self.rs
        if rs.height == self.sm_state.initial_height:
            last_ext_commit = ExtendedCommit()
        elif rs.last_commit is not None and \
                rs.last_commit.has_two_thirds_majority():
            last_ext_commit = rs.last_commit.make_extended_commit(
                self.sm_state.consensus_params.feature
                .vote_extensions_enable_height)
        else:
            self.logger.error(
                "propose step; cannot propose anything without commit "
                "for the previous block")
            return None
        proposer_addr = self.priv_validator_pub_key.address()
        # restart-from-aggregate: no per-vote signatures exist, so the
        # stored aggregate rides through to the block unchanged
        last_agg = getattr(rs.last_commit, "stored_aggregate_commit",
                           None) if rs.last_commit is not None else None
        try:
            return await self.block_exec.create_proposal_block(
                rs.height, self.sm_state, last_ext_commit,
                proposer_addr, last_aggregate_commit=last_agg)
        except Exception as e:
            self.logger.error("unable to create proposal block",
                              err=str(e))
            return None

    def _is_proposal_complete(self) -> bool:
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            return False
        if rs.proposal.pol_round < 0:
            return True
        pv = rs.votes.prevotes(rs.proposal.pol_round)
        return pv is not None and pv.has_two_thirds_majority()

    # ==================================================================
    # proposal / block part ingestion

    def _set_proposal(self, proposal: Proposal,
                      recv_time: Timestamp) -> None:
        """Reference: defaultSetProposal (:2048)."""
        rs = self.rs
        if rs.proposal is not None or proposal is None:
            return
        if proposal.height != rs.height or proposal.round != rs.round:
            return
        if proposal.pol_round < -1 or \
                (proposal.pol_round >= 0 and
                 proposal.pol_round >= proposal.round):
            raise ConsensusError("invalid proposal POL round")
        proposer = rs.validators.get_proposer()
        if not proposer.pub_key.verify_signature(
                proposal.sign_bytes(self.sm_state.chain_id),
                proposal.signature):
            raise ConsensusError("invalid proposal signature")
        max_bytes = self.sm_state.consensus_params.block.max_bytes
        if max_bytes == -1:
            max_bytes = MAX_BLOCK_SIZE_BYTES
        if proposal.block_id.part_set_header.total > \
                (max_bytes - 1) // BLOCK_PART_SIZE_BYTES + 1:
            raise ConsensusError("proposal has too many parts")

        rs.apply_proposal(proposal, recv_time)
        diff_s = recv_time.sub(proposal.timestamp) / 1e9
        timely = "true"
        if self._pbts_enabled(rs.height):
            sp = self.sm_state.consensus_params.synchrony.in_round(
                proposal.round)
            timely = "true" if proposal.is_timely(
                recv_time, sp) else "false"
        self.metrics.proposal_timestamp_difference.with_labels(
            timely).observe(diff_s)
        tracing.instant(tracing.CONSENSUS, "proposal_received",
                        height=proposal.height, round=proposal.round,
                        parts=proposal.block_id.part_set_header.total)
        self.logger.info("Received proposal", proposal=str(proposal))

    async def _add_proposal_block_part(self, msg: BlockPartMessage,
                                 peer_id: str) -> bool:
        """Reference: addProposalBlockPart (:2129)."""
        rs = self.rs
        if rs.height != msg.height:
            return False
        if rs.proposal_block_parts is None:
            return False
        try:
            added = rs.proposal_block_parts.add_part(msg.part)
        except (PartSetError, ValueError) as e:
            # A part that doesn't match the current part-set header (e.g. a
            # part raced from another round's proposal) is dropped, not a
            # consensus failure — reference state.go:2129-2150 returns
            # ErrPartSetInvalidProof to handleMsg, which only logs it.
            self.logger.debug("Invalid block part", err=str(e), peer=peer_id)
            self.metrics.block_gossip_parts_received.with_labels(
                "false").add()
            return False
        if not added:
            self.metrics.duplicate_block_part.add()
            return False
        self.metrics.block_parts.with_labels(peer_id or "local").add()
        self.metrics.block_gossip_parts_received.with_labels(
            "true").add()
        max_bytes = self.sm_state.consensus_params.block.max_bytes
        if max_bytes == -1:
            max_bytes = MAX_BLOCK_SIZE_BYTES
        if rs.proposal_block_parts.byte_size > max_bytes:
            raise ConsensusError(
                "total size of proposal block parts exceeds block max "
                f"bytes ({rs.proposal_block_parts.byte_size} > "
                f"{max_bytes})")
        if rs.proposal_block_parts.is_complete():
            raw = rs.proposal_block_parts.assemble()
            try:
                block = Block.from_proto(decode(pb.BLOCK, raw))
            except _UNDECODABLE_BLOCK as e:
                # the proposer signed bytes that are no block: the
                # reference's BlockFromProto error goes back to
                # handleMsg, which logs it; the block stays unset
                self.logger.error("failed to decode proposal block",
                                  err=repr(e), peer=peer_id,
                                  height=msg.height)
                return added
            rs.complete_proposal_block(block)
            tracing.instant(tracing.CONSENSUS, "proposal_complete",
                            height=msg.height,
                            bytes=rs.proposal_block_parts.byte_size)
            self.logger.info(
                "Received complete proposal block",
                height=rs.proposal_block.header.height,
                hash=rs.proposal_block.hash().hex().upper()[:12])
            self.event_bus.publish_complete_proposal(rs.event_summary())
            await self._handle_complete_proposal(msg.height)
        return added

    async def _apply_compact_block(self, msg: CompactBlockPartMessage,
                                   peer_id: str) -> bool:
        """Rebuild the proposal's part set from the local mempool
        (docs/gossip.md).  All-or-nothing: any unresolved tx hash (or
        a skeleton that doesn't re-encode to the advertised part-set
        header) falls back to the existing full-part gossip — the
        sender resumes pushing parts once its grace window expires.
        Safety does not rest on the sender: every rebuilt part goes
        through ``_add_proposal_block_part``, whose merkle proofs
        verify against the proposal's own part-set header."""
        rs = self.rs

        def nack() -> bool:
            # receiver-driven fallback: tell the sender to cancel its
            # grace window and push full parts NOW — waiting out the
            # grace timer can outlive a whole round under aggressive
            # timeouts (the wedge the recon-gossip nemesis scenario
            # caught on its first run)
            self._broadcast(("compact_nack", msg.height, msg.round,
                             peer_id))
            return False

        if rs.height != msg.height:
            return False            # stale height: ignore silently
        if rs.round != msg.round:
            # same height, different round (we churned past, or the
            # compact outran the round-step gossip): reconstruction
            # is moot but the sender must still stop holding parts
            # back — nack so the fallback engages immediately
            return nack()
        parts = rs.proposal_block_parts
        if parts is None:
            return nack()           # reordered ahead of the proposal
        if parts.is_complete():
            return False            # nothing to do
        if parts.header() != msg.part_set_header:
            self.metrics.compact_block_mismatches.add()
            return nack()
        mempool = getattr(self.block_exec, "mempool", None)
        if mempool is None:
            return nack()
        txs = []
        missing = 0
        for h in msg.tx_hashes:
            tx = mempool.get_tx_by_hash(h)
            if tx is None:
                missing += 1
            else:
                txs.append(tx)
        if missing:
            self.metrics.compact_block_misses.add()
            tracing.instant(tracing.CONSENSUS, "compact_block_miss",
                            height=msg.height, missing=missing,
                            total=len(msg.tx_hashes))
            return nack()
        try:
            rebuilt = PartSet.from_data(
                reconstruct_block_bytes(msg.skeleton, txs))
        except Exception as e:
            self.metrics.compact_block_mismatches.add()
            self.logger.info("compact block reconstruct failed",
                             err=str(e), peer=peer_id)
            return nack()
        if rebuilt.header() != msg.part_set_header:
            # non-canonical skeleton or diverging txs: the advertised
            # header cannot be rebuilt — full parts must flow
            self.metrics.compact_block_mismatches.add()
            return nack()
        self.metrics.compact_blocks_reconstructed.add()
        tracing.instant(tracing.CONSENSUS, "compact_block_rebuilt",
                        height=msg.height, parts=rebuilt.total,
                        num_txs=len(txs))
        for i in range(rebuilt.total):
            pm = BlockPartMessage(height=msg.height, round=msg.round,
                                  part=rebuilt.get_part(i))
            if not self.replay_mode:
                self.wal.write(pm.to_wal())
            await self._add_proposal_block_part(pm, peer_id)
        if self.rs.height == msg.height and \
                self.rs.proposal_block_parts is not None and \
                self.rs.proposal_block_parts.is_complete():
            # tell every peer we hold the full block so nobody pushes
            # parts at us (reference: NewValidBlock re-announce)
            self._broadcast(("valid_block",))
            return True
        return False

    async def _handle_complete_proposal(self, height: int) -> None:
        """Reference: handleCompleteProposal (:2217)."""
        rs = self.rs
        prevotes = rs.votes.prevotes(rs.round)
        block_id, has_two_thirds = prevotes.two_thirds_majority()
        if has_two_thirds and not block_id.is_nil() and \
                rs.valid_round < rs.round:
            if rs.proposal_block.hash() == block_id.hash:
                rs.set_valid(rs.round, rs.proposal_block,
                             rs.proposal_block_parts)
        if rs.step <= STEP_PROPOSE and self._is_proposal_complete():
            await self._enter_prevote(height, rs.round)
            if has_two_thirds:
                await self._enter_precommit(height, rs.round)
        elif rs.step == STEP_COMMIT:
            await self._try_finalize_commit(height)

    # ==================================================================
    # step: Prevote

    async def _enter_prevote(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PREVOTE):
            return
        await self._do_prevote(height, round_)
        # the transition seam re-validates monotonicity at the store —
        # the cross-await discipline bftlint's await-atomicity rule
        # checks (the sign/validate awaits above suspend this routine)
        rs.advance(round_, STEP_PREVOTE)
        self._new_step()

    async def _do_prevote(self, height: int, round_: int) -> None:
        """Reference: defaultDoPrevote (:1387)."""
        rs = self.rs
        if rs.proposal is None or rs.proposal_block is None:
            await self._sign_add_vote(canonical.PREVOTE_TYPE, b"",
                                PartSetHeader())
            return

        block_hash = rs.proposal_block.hash()
        psh = rs.proposal_block_parts.header()

        if rs.proposal.pol_round == -1:
            if rs.locked_round == -1:
                if rs.valid_round != -1 and rs.valid_block is not None \
                        and block_hash == rs.valid_block.hash():
                    await self._sign_add_vote(canonical.PREVOTE_TYPE,
                                        block_hash, psh)
                    return
                # PBTS timeliness
                if self._pbts_enabled(height):
                    if rs.proposal.timestamp != \
                            rs.proposal_block.header.time:
                        await self._sign_add_vote(canonical.PREVOTE_TYPE, b"",
                                            PartSetHeader())
                        return
                    sp = self.sm_state.consensus_params.synchrony \
                        .in_round(rs.proposal.round)
                    if not rs.proposal.is_timely(
                            rs.proposal_receive_time, sp):
                        self.logger.info(
                            "Prevote step: proposal not timely; "
                            "prevoting nil")
                        await self._sign_add_vote(canonical.PREVOTE_TYPE, b"",
                                            PartSetHeader())
                        return
                # pipeline barrier: full validation needs the applied
                # previous height (app hash, results hash) and the app
                # itself must be past H-1's Commit before it sees
                # ProcessProposal(H)
                await self._sync_pipeline()
                try:
                    self.block_exec.validate_block(self.sm_state,
                                                   rs.proposal_block)
                except BlockValidationError as e:
                    self.logger.error(
                        "prevote step: invalid block; prevoting nil",
                        err=str(e))
                    await self._sign_add_vote(canonical.PREVOTE_TYPE, b"",
                                        PartSetHeader())
                    return
                is_app_valid = await self.block_exec.process_proposal(
                    rs.proposal_block, self.sm_state)
                self.metrics.proposal_receive_count.with_labels(
                    "accepted" if is_app_valid else "rejected").add()
                if not is_app_valid:
                    self.logger.error(
                        "prevote step: app rejected proposal; "
                        "prevoting nil")
                    await self._sign_add_vote(canonical.PREVOTE_TYPE, b"",
                                        PartSetHeader())
                    return
                await self._sign_add_vote(canonical.PREVOTE_TYPE, block_hash,
                                    psh)
                return
            if rs.locked_block is not None and \
                    block_hash == rs.locked_block.hash():
                await self._sign_add_vote(canonical.PREVOTE_TYPE, block_hash,
                                    psh)
                return
            await self._sign_add_vote(canonical.PREVOTE_TYPE, b"",
                                PartSetHeader())
            return

        # POLRound >= 0
        pv = rs.votes.prevotes(rs.proposal.pol_round)
        block_id, ok = (pv.two_thirds_majority() if pv is not None
                        else (BlockID(), False))
        ok = ok and not block_id.is_nil()
        if ok and block_hash == block_id.hash and \
                rs.proposal.pol_round < rs.round:
            if rs.locked_round < rs.proposal.pol_round:
                await self._sign_add_vote(canonical.PREVOTE_TYPE, block_hash,
                                    psh)
                return
            if rs.locked_block is not None and \
                    block_hash == rs.locked_block.hash():
                await self._sign_add_vote(canonical.PREVOTE_TYPE, block_hash,
                                    psh)
                return
            if rs.locked_round == rs.proposal.pol_round:
                await self._sign_add_vote(canonical.PREVOTE_TYPE, block_hash,
                                    psh)
                return
        await self._sign_add_vote(canonical.PREVOTE_TYPE, b"",
                            PartSetHeader())

    async def _enter_prevote_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PREVOTE_WAIT):
            return
        if not rs.votes.prevotes(round_).has_two_thirds_any():
            raise ConsensusError(
                "entering prevote wait without any +2/3 prevotes")
        rs.advance(round_, STEP_PREVOTE_WAIT)
        self._new_step()
        self._schedule_timeout(self._vote_wait_timeout_ns(round_),
                               height, round_, STEP_PREVOTE_WAIT)

    # ==================================================================
    # step: Precommit

    async def _enter_precommit(self, height: int, round_: int) -> None:
        """Reference: enterPrecommit (:1609)."""
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.step >= STEP_PRECOMMIT):
            return

        def done() -> None:
            rs.advance(round_, STEP_PRECOMMIT)
            self._new_step()

        block_id, ok = rs.votes.prevotes(round_).two_thirds_majority()
        if not ok:
            await self._sign_add_vote(canonical.PRECOMMIT_TYPE, b"",
                                PartSetHeader())
            done()
            return

        self.event_bus.publish_polka(rs.event_summary())

        if block_id.is_nil():
            await self._sign_add_vote(canonical.PRECOMMIT_TYPE, b"",
                                PartSetHeader())
            done()
            return

        # +2/3 prevoted a block
        if rs.locked_block is not None and \
                rs.locked_block.hash() == block_id.hash:
            rs.relock(round_)
            self.event_bus.publish_relock(rs.event_summary())
            await self._sign_add_vote(canonical.PRECOMMIT_TYPE, block_id.hash,
                                block_id.part_set_header,
                                block=rs.locked_block)
            done()
            return

        if rs.proposal_block is not None and \
                rs.proposal_block.hash() == block_id.hash:
            # pipeline barrier: validating a block we never prevoted
            # (we may be locking straight off a polka) needs the
            # applied previous height
            await self._sync_pipeline()
            try:
                self.block_exec.validate_block(self.sm_state,
                                               rs.proposal_block)
            except BlockValidationError as e:
                raise ConsensusError(
                    f"+2/3 prevoted for an invalid block: {e}") from e
            rs.lock(round_, rs.proposal_block, rs.proposal_block_parts)
            self.event_bus.publish_lock(rs.event_summary())
            await self._sign_add_vote(canonical.PRECOMMIT_TYPE, block_id.hash,
                                block_id.part_set_header,
                                block=rs.proposal_block)
            done()
            return

        # polka for a block we don't have: fetch it, precommit nil
        if rs.proposal_block_parts is None or \
                not rs.proposal_block_parts.has_header(
                    block_id.part_set_header):
            rs.reset_proposal_parts(block_id.part_set_header)
        await self._sign_add_vote(canonical.PRECOMMIT_TYPE, b"",
                            PartSetHeader())
        done()

    async def _enter_precommit_wait(self, height: int, round_: int) -> None:
        rs = self.rs
        if rs.height != height or round_ < rs.round or \
                (rs.round == round_ and rs.triggered_timeout_precommit):
            return
        if not rs.votes.precommits(round_).has_two_thirds_any():
            raise ConsensusError(
                "entering precommit wait without any +2/3 precommits")
        rs.mark_timeout_precommit(round_)
        self._new_step()
        self._schedule_timeout(self._vote_wait_timeout_ns(round_),
                               height, round_, STEP_PRECOMMIT_WAIT)

    # ==================================================================
    # step: Commit

    async def _enter_commit(self, height: int, commit_round: int) -> None:
        """Reference: enterCommit (:1743)."""
        rs = self.rs
        if rs.height != height or rs.step >= STEP_COMMIT:
            return

        block_id, ok = rs.votes.precommits(commit_round) \
            .two_thirds_majority()
        if not ok or block_id.is_nil():
            raise ConsensusError("enterCommit expects +2/3 precommits")

        rs.enter_commit(commit_round, Timestamp.now())
        self._new_step()

        if rs.locked_block is not None and \
                rs.locked_block.hash() == block_id.hash:
            rs.adopt_block(rs.locked_block, rs.locked_block_parts)

        if rs.proposal_block is None or \
                rs.proposal_block.hash() != block_id.hash:
            if rs.proposal_block_parts is None or \
                    not rs.proposal_block_parts.has_header(
                        block_id.part_set_header):
                rs.reset_proposal_parts(block_id.part_set_header)
                self.event_bus.publish_valid_block(rs.event_summary())
                # tell peers which parts we ACTUALLY hold (reference:
                # the reactor broadcasts NewValidBlockMessage on
                # EventValidBlock).  Without this, a part that was
                # queued-but-lost before we entered commit is never
                # re-sent — the sender's bookkeeping says delivered —
                # and this node wedges in the commit step forever.
                self._broadcast(("valid_block",))

        await self._try_finalize_commit(height)

    async def _try_finalize_commit(self, height: int) -> None:
        rs = self.rs
        if rs.height != height:
            raise ConsensusError("tryFinalizeCommit height mismatch")
        block_id, ok = rs.votes.precommits(rs.commit_round) \
            .two_thirds_majority()
        if not ok or block_id.is_nil():
            return
        if rs.proposal_block is None or \
                rs.proposal_block.hash() != block_id.hash:
            return
        await self._finalize_commit(height)

    async def _finalize_commit(self, height: int) -> None:
        """Reference: finalizeCommit (:1834), split for the commit
        pipeline (docs/pipeline.md) into

          decide  — validate, save block + seen commit, fsync the WAL
                    EndHeight barrier (synchronous, this method);
          execute — FinalizeBlock/save-responses/app-Commit/mempool
                    update (supervised background task when
                    ``consensus.pipeline_commit``; inline otherwise);
          advance — updateToState + schedule round 0.  Pipelined mode
                    advances on a *provisional* next state so H+1's
                    propose/gossip/vote tally overlap H's execution;
                    the barrier (``_sync_pipeline``) installs the real
                    post-apply state before anything reads it.
        """
        # pipeline depth is 1: H-1's execute/commit must have fully
        # landed before H's begins (also orders the mempool update
        # hand-offs)
        await self._sync_pipeline()
        rs = self.rs
        if rs.height != height or rs.step != STEP_COMMIT:
            return
        block_id, ok = rs.votes.precommits(rs.commit_round) \
            .two_thirds_majority()
        block, block_parts = rs.proposal_block, rs.proposal_block_parts
        if not ok:
            raise ConsensusError("cannot finalize; no 2/3 majority")
        if not block_parts.has_header(block_id.part_set_header):
            raise ConsensusError("proposal parts header != commit header")
        if block.hash() != block_id.hash:
            raise ConsensusError("proposal block != commit hash")
        with tracing.span(tracing.CONSENSUS, "validate_block",
                          height=height):
            self.block_exec.validate_block(self.sm_state, block)

        self.logger.info("Finalizing commit of block",
                         height=height,
                         hash=block.hash().hex().upper()[:12],
                         num_txs=len(block.data.txs))

        fail.fail()    # crash point: before block save (state.go:1872)

        with tracing.span(tracing.CONSENSUS, "save_block",
                          height=height):
            if self.block_store.height < block.header.height:
                precommits = rs.votes.precommits(rs.commit_round)
                seen_ext = precommits.make_extended_commit(
                    self.sm_state.consensus_params.feature
                    .vote_extensions_enable_height)
                if self.sm_state.consensus_params.feature \
                        .vote_extensions_enabled(block.header.height):
                    self.block_store.save_block_with_extended_commit(
                        block, block_parts, seen_ext)
                else:
                    seen = seen_ext.to_commit()
                    # a height decided by an injected/restored
                    # aggregate (catchup) may hold sub-quorum live
                    # votes: persist the VERIFIED aggregate instead,
                    # or restart reconstruction would restore a
                    # majority-less vote set that cannot re-propose
                    agg_seen = precommits.stored_aggregate_commit
                    if agg_seen is not None and \
                            not precommits \
                            .has_two_thirds_votes_for_maj23():
                        seen = agg_seen
                    self.block_store.save_block(block, block_parts,
                                                seen)

        fail.fail()    # crash point: block saved, WAL barrier not yet
                       # written (state.go:1889)

        # fsync'd end-of-height barrier BEFORE ApplyBlock: on crash,
        # replay/handshake re-applies the block.  In pipelined mode
        # every H+1 message the receive routine processes from here on
        # lands in the WAL after this record, so catchup replay sees
        # the same prefix the serial path would have written.
        self.wal.write_end_height(height)

        fail.fail()    # crash point: barrier written, block not applied
                       # (state.go:1911)

        self.metrics.record_commit(block, rs.last_validators,
                                   rs.validators,
                                   block_size=block_parts.byte_size,
                                   commit_round=rs.commit_round)
        state_copy = self.sm_state.copy()
        bid = BlockID(hash=block.hash(),
                      part_set_header=block_parts.header())
        if getattr(self.config, "pipeline_commit", False) and \
                not self.replay_mode:
            self._begin_pipelined_apply(height, bid, block,
                                        block_parts, state_copy,
                                        rs.commit_round)
            next_state = provisional_next_state(self.sm_state, bid,
                                                block)
        else:
            with tracing.span(tracing.CONSENSUS, "apply_block",
                              height=height,
                              num_txs=len(block.data.txs)):
                state_copy = await self.block_exec \
                    .apply_verified_block(state_copy, bid, block,
                                          block.header.height)

            fail.fail()    # crash point: applied, consensus state not
                           # yet advanced (state.go:1933)

            tracing.instant(tracing.CONSENSUS, "commit", height=height,
                            num_txs=len(block.data.txs),
                            round=rs.commit_round,
                            block_bytes=block_parts.byte_size)
            next_state = state_copy
        self.update_to_state(next_state)
        if self.priv_validator is not None:
            self.priv_validator_pub_key = \
                self.priv_validator.get_pub_key()
        self._schedule_round0()

    # ------------------------------------------------------------------
    # commit pipeline (docs/pipeline.md)

    def _begin_pipelined_apply(self, height: int, bid: BlockID, block,
                               block_parts, state_copy,
                               commit_round: int) -> None:
        """Launch the supervised background execute/commit for the
        decided block.  The task never touches RoundState or
        ``sm_state`` — it resolves the barrier future and the receive
        routine (the single writer) installs the result."""
        fut: asyncio.Future = asyncio.get_running_loop().create_future()
        p = _PipelinedCommit(height, fut, time.monotonic())

        async def _apply_task() -> None:
            try:
                with tracing.span(tracing.CONSENSUS, "apply_block",
                                  height=height,
                                  num_txs=len(block.data.txs)):
                    new_state = await self.block_exec \
                        .apply_verified_block(state_copy, bid, block,
                                              block.header.height)
                fail.fail()    # crash point: applied, consensus state
                               # not yet advanced (state.go:1933)
                tracing.instant(tracing.CONSENSUS, "commit",
                                height=height,
                                num_txs=len(block.data.txs),
                                round=commit_round,
                                block_bytes=block_parts.byte_size)
                self.metrics.pipeline_apply_seconds.observe(
                    time.monotonic() - p.t0)
            except asyncio.CancelledError:
                if not fut.done():
                    fut.cancel()
                raise
            except Exception as e:
                # surfaced to every barrier waiter; the receive
                # routine crashes loudly on its next sync, exactly
                # like a serial apply failure
                if not fut.done():
                    fut.set_exception(e)
                raise
            if not fut.done():
                fut.set_result(new_state)

        from ..libs.supervisor import RestartPolicy
        # no restarts: re-running FinalizeBlock after a partial apply
        # would double-execute the block — crash recovery is the WAL
        # barrier + handshake's job, not the supervisor's
        p.task = self.supervisor.spawn(
            _apply_task, name=f"pipeline_apply:{height}",
            kind="consensus_pipeline_apply",
            policy=RestartPolicy(max_restarts=0, window_s=1.0,
                                 backoff_base_s=0.01,
                                 backoff_max_s=0.01),
            on_giveup=self._on_giveup, fatal=is_fatal)
        self._pipeline = p
        tracing.instant(tracing.CONSENSUS, "pipeline_advance",
                        height=height)

    async def _sync_pipeline(self) -> None:
        """The pipeline barrier: wait for the in-flight execute/commit
        and install the real post-apply state over the provisional
        one.  Called from the receive routine only (the single
        writer), at every step that reads the applied state: our own
        proposal construction, prevote validation / ProcessProposal,
        vote-extension verification, and the next height's finalize."""
        p = self._pipeline
        if p is None:
            return
        t0 = time.monotonic()
        # on failure (or cancellation of this waiter) the pipeline
        # handle stays latched: an apply failure must poison every
        # later barrier too — clearing it here would let a
        # supervisor-restarted receive routine carry on at H+1 with
        # the provisional (pre-apply) state, which is unsound — and a
        # cancelled stop() still needs the handle to drain/abort the
        # background task
        new_state = await p.future
        self._pipeline = None
        self.metrics.pipeline_barrier_wait_seconds.observe(
            time.monotonic() - t0)
        tracing.record_span(tracing.CONSENSUS, "barrier_wait",
                            start_ns=int(t0 * 1e9),
                            height=p.height)
        self._reconcile_applied_state(p.height, new_state)

    def _reconcile_applied_state(self, applied_height: int,
                                 new_state: SMState) -> None:
        """Swap the provisional H+1 state for the real post-apply one.

        The provisional state already fixed the H+1 validator set and
        vote-extension schedule (validator updates from H land at
        H+2), so normally this is a plain assignment.  The one thing a
        committed block CAN change out from under the provisional
        snapshot is a consensus-param update taking effect at H+1 —
        then the height vote set was built under the wrong rules and
        is rebuilt; peers re-gossip any votes already tallied."""
        rs = self.rs
        if rs.height != applied_height + 1:
            raise ConsensusError(
                f"pipeline reconcile: round state at {rs.height}, "
                f"applied height {applied_height}")
        prov = self.sm_state
        prov_ext = prov.consensus_params.feature \
            .vote_extensions_enabled(rs.height)
        real_ext = new_state.consensus_params.feature \
            .vote_extensions_enabled(rs.height)
        prov_vals = prov.validators.hash()
        real_vals = new_state.validators.hash()
        self.sm_state = new_state
        if prov_ext != real_ext or prov_vals != real_vals:
            self.logger.info(
                "pipeline reconcile: consensus params changed at the "
                "pipelined height; rebuilding height vote set",
                height=rs.height, ext_changed=prov_ext != real_ext)
            vals = new_state.validators
            if rs.round > 0:
                # preserve the proposer rotation _enter_new_round
                # applied for the current round — installing round-0
                # priorities here would make this node disagree with
                # its peers about the round's proposer
                vals = vals.copy()
                vals.increment_proposer_priority(rs.round)
            rs.rebuild_votes(
                vals,
                HeightVoteSet(new_state.chain_id, rs.height, vals,
                              extensions_enabled=real_ext))

    # ==================================================================
    # votes

    async def _try_add_vote(self, vote: Vote, peer_id: str) -> bool:
        """Reference: tryAddVote (:2253) — turns conflicting votes into
        evidence."""
        try:
            return await self._add_vote(vote, peer_id)
        except ConflictingVoteError as e:
            if self.priv_validator_pub_key is not None and \
                    vote.validator_address == \
                    self.priv_validator_pub_key.address():
                self.logger.error(
                    "found conflicting vote from ourselves; "
                    "did you unsafe_reset a validator?",
                    height=vote.height, round=vote.round)
                return False
            if self.block_exec.evpool is not None and \
                    hasattr(self.block_exec.evpool,
                            "report_conflicting_votes"):
                self.block_exec.evpool.report_conflicting_votes(
                    e.vote_a, e.vote_b)
            self.logger.info("found and sent conflicting vote to evpool",
                             height=vote.height)
            return False

    def aggregate_commit_relevant(self, agg, peer_id: str = "") \
            -> bool:
        """Cheap (no-crypto) admission screen for the reactor: False
        when an incoming aggregate catchup commit provably cannot be
        ingested — wrong height, already at/past commit, feature off,
        or a known forger peer.  Shedding these BEFORE the input
        queue keeps the queue (the backpressure buffer while a
        verdict barrier is outstanding) for messages that can still
        matter; the authoritative re-check in
        ``_try_add_aggregate_commit`` is unchanged."""
        rs = self.rs
        if not isinstance(agg, AggregateCommit):
            return False
        if self.sm_state is None or \
                not self.sm_state.consensus_params.feature \
                .aggregate_commits_enabled(agg.height):
            return False
        if agg.height != rs.height or rs.step >= STEP_COMMIT:
            return False
        if peer_id and peer_id in self._agg_commit_forgers:
            return False
        return True

    async def _try_add_aggregate_commit(self, agg,
                                        peer_id: str) -> bool:
        """Catchup ingestion on an aggregate-commit chain: a verified
        AggregateCommit for the CURRENT height is this height's +2/3
        precommit evidence — individual votes cannot be reconstructed
        from peers' stores, so the aggregate stands in for them
        (docs/aggregate_commits.md).  The block parts still arrive via
        normal data gossip; entering commit here lets the existing
        parts-complete path finalize."""
        from ..types import validation as types_validation
        rs = self.rs
        # same admission rules the reactor screens with (ONE source
        # of truth) — re-checked here because the reactor's verdict
        # aged in the input queue, and the forger check bounds the
        # attack at one wasted verification per peer identity (the
        # pairing costs ~10 ms at 10k validators; honest peers never
        # send an invalid aggregate — they verified before storing)
        if not self.aggregate_commit_relevant(agg, peer_id):
            return False
        try:
            # off the event loop (crypto/pipeline.py seam): the
            # pairing runs GIL-free on the staging worker while the
            # loop keeps serving p2p/RPC.  RoundState stays
            # consistent across the await — this receive routine is
            # its only writer and it is parked right here.
            from ..crypto import pipeline as _pipeline
            await _pipeline.run_off_loop(
                types_validation.verify_commit,
                self.sm_state.chain_id, rs.validators, agg.block_id,
                agg.height, agg, None, self.device)
        except types_validation.VerificationError as e:
            self.logger.error("invalid aggregate catchup commit",
                              err=str(e), peer=peer_id)
            if peer_id:
                forgers = self._agg_commit_forgers
                forgers[peer_id] = True
                if len(forgers) > self._agg_commit_forgers_max:
                    del forgers[next(iter(forgers))]
            return False
        precommits = rs.votes.precommits(agg.round)
        if precommits is None:
            # the chain decided at a round we never reached locally
            rs.votes.ensure_round_tracked(agg.round)
            precommits = rs.votes.precommits(agg.round)
        if precommits is None or \
                not precommits.inject_aggregate_majority(agg):
            return False
        await self._enter_commit(rs.height, agg.round)
        return True

    async def _add_vote(self, vote: Vote, peer_id: str) -> bool:
        """Reference: addVote (:2299)."""
        rs = self.rs

        # precommit for the previous height (arrives during commit wait)
        if vote.height + 1 == rs.height and \
                vote.type == canonical.PRECOMMIT_TYPE:
            if rs.step != STEP_NEW_HEIGHT:
                return False
            if rs.last_commit is None:
                return False
            added = rs.last_commit.add_vote(vote)
            if not added:
                return False
            self.event_bus.publish_vote(vote)
            skip = (self.sm_state.next_block_delay_ns == 0 and
                    self.config.timeout_commit_ns == 0)
            if skip and rs.last_commit.has_all():
                await self._enter_new_round(rs.height, 0)
            return added

        if vote.height != rs.height:
            return False

        ext_enabled = self.sm_state.consensus_params.feature \
            .vote_extensions_enabled(vote.height)
        if ext_enabled:
            my_addr = self.priv_validator_pub_key.address() \
                if self.priv_validator_pub_key else b""
            if vote.type == canonical.PRECOMMIT_TYPE and \
                    not vote.block_id.is_nil() and \
                    vote.validator_address != my_addr:
                _, val = self.sm_state.validators.get_by_index(
                    vote.validator_index)
                if val is None:
                    raise VoteSetError(
                        f"validator index {vote.validator_index} out of "
                        f"bounds")
                vote.verify_extension(self.sm_state.chain_id,
                                      val.pub_key)
                # pipeline barrier: the app must be past the previous
                # height's Commit before VerifyVoteExtension(H)
                await self._sync_pipeline()
                ok = await self.block_exec.verify_vote_extension(vote)
                self.metrics.vote_extension_receive_count.with_labels(
                    "accepted" if ok else "rejected").add()
                if not ok:
                    raise VoteSetError("invalid vote extension")
        elif vote.extension or vote.extension_signature or \
                vote.non_rp_extension or vote.non_rp_extension_signature:
            raise VoteSetError(
                "received vote with extension while extensions are "
                "disabled")

        vt_label = "prevote" \
            if vote.type == canonical.PREVOTE_TYPE else "precommit"
        if vote.round < rs.round:
            self.metrics.late_votes.with_labels(vt_label).add()
        height = rs.height
        added = rs.votes.add_vote(vote, peer_id)
        if not added:
            self.metrics.duplicate_vote.add()
            return False
        vs = rs.votes.prevotes(vote.round) \
            if vote.type == canonical.PREVOTE_TYPE \
            else rs.votes.precommits(vote.round)
        total_power = rs.validators.total_voting_power()
        if vs is not None and total_power > 0:
            self.metrics.round_voting_power_percent.with_labels(
                vt_label).set(vs.sum / total_power)
        self.event_bus.publish_vote(vote)
        self._broadcast(("has_vote", vote))

        if vote.type == canonical.PREVOTE_TYPE:
            prevotes = rs.votes.prevotes(vote.round)
            block_id, ok = prevotes.two_thirds_majority()
            if ok and rs.proposal is not None:
                proposer = rs.validators.get_proposer() \
                    .address.hex().upper()
                delay_s = vote.timestamp.sub(
                    rs.proposal.timestamp) / 1e9
                self.metrics.quorum_prevote_delay.with_labels(
                    proposer).set(delay_s)
                if (height, vote.round) > self._quorum_delay_observed:
                    self._quorum_delay_observed = (height, vote.round)
                    self.metrics.quorum_prevote_delay_seconds.observe(
                        max(0.0, delay_s))
                    if self._adaptive is not None and \
                            not self.replay_mode:
                        self._adaptive.observe(delay_s)
                if prevotes.has_all():
                    self.metrics.full_prevote_delay.with_labels(
                        proposer).set(delay_s)
                    self.metrics.full_prevote_delay_seconds.observe(
                        max(0.0, delay_s))
            if ok and not block_id.is_nil():
                # update valid block
                if rs.valid_round < vote.round and \
                        vote.round == rs.round:
                    if rs.proposal_block is not None and \
                            rs.proposal_block.hash() == block_id.hash:
                        rs.set_valid(vote.round, rs.proposal_block,
                                     rs.proposal_block_parts)
                    else:
                        rs.drop_proposal_block()
                    if rs.proposal_block_parts is None or \
                            not rs.proposal_block_parts.has_header(
                                block_id.part_set_header):
                        rs.reset_proposal_parts(
                            block_id.part_set_header)
                    self.event_bus.publish_valid_block(
                        rs.event_summary())
                    # reference reactor: EventValidBlock ->
                    # NewValidBlockMessage broadcast (peers learn our
                    # real part bitmap and (re)send what we miss)
                    self._broadcast(("valid_block",))
            if rs.round < vote.round and prevotes.has_two_thirds_any():
                await self._enter_new_round(height, vote.round)
            elif rs.round == vote.round and rs.step >= STEP_PREVOTE:
                block_id, ok = prevotes.two_thirds_majority()
                if ok and (self._is_proposal_complete() or
                           block_id.is_nil()):
                    await self._enter_precommit(height, vote.round)
                elif prevotes.has_two_thirds_any():
                    await self._enter_prevote_wait(height, vote.round)
            elif rs.proposal is not None and \
                    0 <= rs.proposal.pol_round == vote.round:
                if self._is_proposal_complete():
                    await self._enter_prevote(height, rs.round)

        elif vote.type == canonical.PRECOMMIT_TYPE:
            precommits = rs.votes.precommits(vote.round)
            block_id, ok = precommits.two_thirds_majority()
            if ok:
                await self._enter_new_round(height, vote.round)
                await self._enter_precommit(height, vote.round)
                if not block_id.is_nil():
                    await self._enter_commit(height, vote.round)
                    skip = (self.sm_state.next_block_delay_ns == 0 and
                            self.config.timeout_commit_ns == 0)
                    if skip and precommits.has_all():
                        await self._enter_new_round(rs.height, 0)
                else:
                    await self._enter_precommit_wait(height, vote.round)
            elif rs.round <= vote.round and \
                    precommits.has_two_thirds_any():
                await self._enter_new_round(height, vote.round)
                await self._enter_precommit_wait(height, vote.round)
        else:
            raise ConsensusError(f"unexpected vote type {vote.type}")
        return True

    # ==================================================================
    # vote signing

    def _vote_time(self, height: int, msg_type: int = 0) -> Timestamp:
        """Reference: voteTime (:2578) — BFT time floor unless PBTS.

        Aggregate-commit mode zeroes the PRECOMMIT timestamp: every
        for-block precommit must sign the one canonical zero-timestamp
        message so the BLS signatures sum into a single aggregate
        (docs/aggregate_commits.md; params validation guarantees PBTS,
        so no consumer needs per-vote timestamps)."""
        if msg_type == canonical.PRECOMMIT_TYPE and \
                self.sm_state.consensus_params.feature \
                .aggregate_commits_enabled(height):
            return Timestamp.zero()
        if self._pbts_enabled(height):
            return Timestamp.now()
        now = Timestamp.now()
        min_vote_time = now
        rs = self.rs
        if rs.locked_block is not None:
            min_vote_time = rs.locked_block.header.time.add_ns(
                _TIME_IOTA_NS)
        elif rs.proposal_block is not None:
            min_vote_time = rs.proposal_block.header.time.add_ns(
                _TIME_IOTA_NS)
        return now if now.unix_ns() > min_vote_time.unix_ns() \
            else min_vote_time

    def _pbts_enabled(self, height: int) -> bool:
        return self.sm_state.consensus_params.feature.pbts_enabled(
            height)

    async def _pv_sign_vote(self, vote: Vote, sign_ext: bool) -> None:
        """One seam for local (sync) and remote (async) signers."""
        pv = self.priv_validator
        if hasattr(pv, "sign_vote_async"):
            await pv.sign_vote_async(self.sm_state.chain_id, vote,
                                     sign_ext)
        else:
            pv.sign_vote(self.sm_state.chain_id, vote,
                         sign_extension=sign_ext)

    async def _pv_sign_proposal(self, proposal: Proposal) -> None:
        pv = self.priv_validator
        if hasattr(pv, "sign_proposal_async"):
            await pv.sign_proposal_async(self.sm_state.chain_id,
                                         proposal)
        else:
            pv.sign_proposal(self.sm_state.chain_id, proposal)

    async def _sign_vote(self, msg_type: int, hash_: bytes,
                   psh: PartSetHeader,
                   block: Optional[Block]) -> Optional[Vote]:
        """Reference: signVote (:2526)."""
        self.wal.flush_and_sync()
        rs = self.rs
        addr = self.priv_validator_pub_key.address()
        val_idx, _ = rs.validators.get_by_address(addr)
        vote = Vote(
            type=msg_type,
            height=rs.height,
            round=rs.round,
            block_id=BlockID(hash=hash_, part_set_header=psh),
            timestamp=self._vote_time(rs.height, msg_type),
            validator_address=addr,
            validator_index=val_idx,
        )
        ext_enabled = self.sm_state.consensus_params.feature \
            .vote_extensions_enabled(vote.height)
        sign_ext = False
        if msg_type == canonical.PRECOMMIT_TYPE and \
                not vote.block_id.is_nil():
            if ext_enabled:
                if block is None:
                    raise ConsensusError(
                        "need block to extend a non-nil precommit")
                ext, non_rp_ext = await self.block_exec.extend_vote(
                    vote, block, self.sm_state)
                vote.extension = ext
                vote.non_rp_extension = non_rp_ext
                sign_ext = True
        try:
            await self._pv_sign_vote(vote, sign_ext)
        except Exception as e:
            self.logger.error("failed signing vote", err=str(e))
            return None
        return vote

    async def _sign_add_vote(self, msg_type: int, hash_: bytes,
                       psh: PartSetHeader,
                       block: Optional[Block] = None) -> None:
        """Reference: signAddVote (:2605)."""
        if self.priv_validator is None or \
                self.priv_validator_pub_key is None:
            return
        if not self.rs.validators.has_address(
                self.priv_validator_pub_key.address()):
            return
        vote = await self._sign_vote(msg_type, hash_, psh, block)
        if vote is None:
            return
        self.metrics.validator_last_signed_height.set(self.rs.height)
        self.send_internal(VoteMessage(vote))
        self._broadcast(VoteMessage(vote))

    # ==================================================================
    def _broadcast(self, msg) -> None:
        for hook in self.broadcast_hooks:
            try:
                hook(msg)
            except Exception:
                self.logger.error("broadcast hook failed", exc_info=True)

