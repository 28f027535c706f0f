"""Consensus reactor: gossips the consensus state over the p2p switch.

Reference: internal/consensus/reactor.go (2022 LoC) — 4 channels
(State/Data/Vote/VoteSetBits), PeerState tracking what each peer has,
and per-peer gossip routines: gossipDataRoutine (:594, proposal block
parts), gossipVotesRoutine (:654), queryMaj23Routine (:718).

The port's copy of cometbft_tpu/consensus/reactor.py: the same four
channels with their priorities and queue capacities, the same features,
the same gossip routines with their yield discipline (a full send queue
falls through to the timed sleep; every sent-vote branch yields), vote
batching, store catch-up, the compact-block relay and its nack arm, the
aggregate-commit catch-up and peer refusal, and the useful-bytes
accounting.  The gossip loops keep the JAX restart policy (3 restarts in
30 s, then the peer is dropped): they touch no device.  The state
machine's own no-fallback rule is untouched: a kernel that raises inside
the receive routine stops that node's consensus (``cs.failure``), and
the reactor neither catches nor restarts it.
"""
from __future__ import annotations

import asyncio
import time
from dataclasses import dataclass, field
from typing import Optional

from ..libs import tracing
from ..libs.bits import BitArray
from ..libs.log import Logger
from ..libs.supervisor import RestartPolicy
from ..p2p.conn import ChannelDescriptor
from ..p2p.switch import Peer, Reactor
from ..types import canonical
from ..types.part_set import PartSetHeader
from ..types.commit import AggregateCommit
from .messages import (
    COMPACT_MIN_TXS, FEATURE_AGG_COMMIT, FEATURE_COMPACT_BLOCKS,
    FEATURE_VOTE_BATCH, AggregateCommitMessage,
    BlockPartMessage, CompactBlockNackMessage,
    CompactBlockPartMessage, HasProposalBlockPartMessage,
    HasVoteMessage, NewRoundStepMessage, NewValidBlockMessage,
    ProposalMessage, ProposalPOLMessage, VoteBatchMessage,
    VoteMessage, VoteSetBitsMessage, VoteSetMaj23Message,
    decode_p2p, encode_p2p, make_compact_block,
)
from .round_state import (
    STEP_COMMIT, STEP_NEW_HEIGHT, STEP_PREVOTE, STEP_PROPOSE, RoundState,
)
from .state import ConsensusState

STATE_CHANNEL = 0x20
DATA_CHANNEL = 0x21
VOTE_CHANNEL = 0x22
VOTE_SET_BITS_CHANNEL = 0x23


@dataclass
class PeerRoundState:
    """What we believe the peer's round state is (reference:
    cstypes.PeerRoundState)."""
    height: int = 0
    round: int = -1
    step: int = 0
    proposal: bool = False
    proposal_block_parts_header: PartSetHeader = field(
        default_factory=PartSetHeader)
    proposal_block_parts: Optional[BitArray] = None
    proposal_pol_round: int = -1
    proposal_pol: Optional[BitArray] = None
    prevotes: Optional[BitArray] = None
    precommits: Optional[BitArray] = None
    last_commit_round: int = -1
    last_commit: Optional[BitArray] = None
    catchup_commit_round: int = -1
    catchup_commit: Optional[BitArray] = None


class PeerState:
    """Reference: internal/consensus/reactor.go PeerState.

    Owner discipline (the RoundState seam, extended here): the
    reactor's receive path and this peer's gossip routines all run on
    the event loop, and every cross-await mutation of ``prs`` (or the
    compact-block protocol state below) goes through these methods —
    each re-validates its height/round precondition at the write, so
    a stale decision computed before a suspension cannot be applied
    to a round the peer has already left.  bftlint's await-atomicity
    rule tracks ``prs.*`` stores the same way it tracks ``self.rs.*``
    (tools/bftlint/checkers/await_atomicity.py)."""

    def __init__(self, peer: Peer):
        self.peer = peer
        self.prs = PeerRoundState()
        # compact-block relay bookkeeping: the (height, round) we last
        # sent this peer the compact form for, and when (monotonic) —
        # full parts are held back for the grace window so the peer
        # gets a chance to reconstruct from its mempool
        self.compact_hr: Optional[tuple] = None
        self.compact_at: float = 0.0
        # the (height, round) the peer sent US the compact form for:
        # it provably holds the complete block, so no routine should
        # push parts at it even before its part bitmap says so
        self.full_block_hr: Optional[tuple] = None
        # aggregate-commit catchup: the height we last shipped this
        # peer an AggregateCommitMessage for, and when (monotonic) —
        # one aggregate replaces the whole per-vote catchup stream,
        # so resends are purely a lost-message safety net
        self.agg_commit_sent_height: int = 0
        self.agg_commit_sent_at: float = 0.0

    # -- compact-block seam (single-writer transition methods) ------
    def mark_compact_sent(self, height: int, round_: int,
                          now: float) -> None:
        self.compact_hr = (height, round_)
        self.compact_at = now

    def clear_compact_grace(self, height: int, round_: int) -> None:
        """The peer nacked our compact form: stop holding parts back
        (the (height, round) check re-validates at the write)."""
        if self.compact_hr == (height, round_):
            self.compact_at = 0.0

    def compact_covers(self, height: int, round_: int, now: float,
                       grace_s: float) -> bool:
        """True while full parts for (height, round) should be held
        back: the compact form went out within the grace window."""
        return self.compact_hr == (height, round_) and \
            (now - self.compact_at) < grace_s

    def mark_peer_has_full_block(self, height: int,
                                 round_: int) -> None:
        self.full_block_hr = (height, round_)

    def peer_has_full_block(self, height: int, round_: int) -> bool:
        return self.full_block_hr == (height, round_)

    def init_catchup_parts(self, height: int,
                           header: PartSetHeader) -> None:
        """Install the stored block's part-set header for catchup
        gossip (re-validating the peer is still on that height)."""
        prs = self.prs
        if prs.height != height:
            return
        prs.proposal_block_parts_header = header
        prs.proposal_block_parts = BitArray(header.total)

    def apply_new_round_step(self, msg: NewRoundStepMessage,
                             num_validators: int) -> None:
        prs = self.prs
        init_height, init_round = prs.height, prs.round
        # snapshot BEFORE resetting: if the peer advanced exactly one
        # height, its old precommits become its new last commit
        # (reference: ApplyNewRoundStepMessage)
        old_precommits = prs.precommits
        if msg.height != prs.height or msg.round != prs.round:
            prs.proposal = False
            prs.proposal_block_parts_header = PartSetHeader()
            prs.proposal_block_parts = None
            prs.proposal_pol_round = -1
            prs.proposal_pol = None
            prs.prevotes = BitArray(num_validators)
            prs.precommits = BitArray(num_validators)
        if prs.height != msg.height:
            if msg.height == init_height + 1 and \
                    msg.last_commit_round == init_round:
                prs.last_commit_round = msg.last_commit_round
                prs.last_commit = old_precommits
            else:
                prs.last_commit_round = msg.last_commit_round
                prs.last_commit = None
            prs.catchup_commit_round = -1
            prs.catchup_commit = None
        prs.height = msg.height
        prs.round = msg.round
        prs.step = msg.step

    def apply_new_valid_block(self, msg: NewValidBlockMessage) -> None:
        prs = self.prs
        if prs.height != msg.height:
            return
        if prs.round != msg.round and not msg.is_commit:
            return
        prs.proposal_block_parts_header = msg.block_part_set_header
        prs.proposal_block_parts = msg.block_parts

    def apply_proposal(self, msg: ProposalMessage) -> None:
        prs = self.prs
        p = msg.proposal
        if prs.height != p.height or prs.round != p.round:
            return
        if prs.proposal:
            return
        prs.proposal = True
        if prs.proposal_block_parts is not None:
            return   # NewValidBlock already set the parts header
        prs.proposal_block_parts_header = p.block_id.part_set_header
        prs.proposal_block_parts = BitArray(
            p.block_id.part_set_header.total)
        prs.proposal_pol_round = p.pol_round
        prs.proposal_pol = None

    def apply_proposal_pol(self, msg: ProposalPOLMessage) -> None:
        prs = self.prs
        if prs.height != msg.height or \
                prs.proposal_pol_round != msg.proposal_pol_round:
            return
        prs.proposal_pol = msg.proposal_pol

    def apply_has_vote(self, msg: HasVoteMessage) -> None:
        if self.prs.height != msg.height:
            return
        self.set_has_vote(msg.height, msg.round, msg.type, msg.index)

    def apply_has_proposal_block_part(
            self, msg: HasProposalBlockPartMessage) -> None:
        prs = self.prs
        if prs.height != msg.height or prs.round != msg.round:
            return
        if prs.proposal_block_parts is not None:
            prs.proposal_block_parts.set_index(msg.index, True)

    def set_has_proposal_block_part(self, height: int, round_: int,
                                    index: int) -> None:
        prs = self.prs
        if prs.height != height or prs.round != round_:
            return
        if prs.proposal_block_parts is not None:
            prs.proposal_block_parts.set_index(index, True)

    def set_has_vote(self, height: int, round_: int, type_: int,
                     index: int) -> None:
        ba = self._votes_bitarray(height, round_, type_)
        if ba is not None:
            ba.set_index(index, True)

    def _votes_bitarray(self, height: int, round_: int,
                        type_: int) -> Optional[BitArray]:
        prs = self.prs
        if prs.height == height:
            if prs.round == round_:
                return prs.prevotes if \
                    type_ == canonical.PREVOTE_TYPE else prs.precommits
            if prs.catchup_commit_round == round_ and \
                    type_ == canonical.PRECOMMIT_TYPE:
                return prs.catchup_commit
            if prs.proposal_pol_round == round_ and \
                    type_ == canonical.PREVOTE_TYPE:
                return prs.proposal_pol
        elif prs.height == height + 1:
            if prs.last_commit_round == round_ and \
                    type_ == canonical.PRECOMMIT_TYPE:
                return prs.last_commit
        return None

    def apply_vote_set_bits(self, msg: VoteSetBitsMessage,
                            our_votes: Optional[BitArray]) -> None:
        """Merge the peer's claimed vote bits (reference:
        ApplyVoteSetBitsMessage — bits we can't verify locally are only
        trusted where they agree with votes we hold)."""
        votes = self._votes_bitarray(msg.height, msg.round, msg.type)
        if votes is None or msg.votes is None:
            return
        if our_votes is None:
            votes.update(msg.votes)
        else:
            other_votes = votes.sub(our_votes)
            has_votes = other_votes.or_(msg.votes)
            votes.update(has_votes)

    def ensure_catchup_commit_round(self, height: int, round_: int,
                                    num_validators: int) -> None:
        prs = self.prs
        if prs.height != height:
            return
        if prs.catchup_commit_round != round_:
            prs.catchup_commit_round = round_
            prs.catchup_commit = BitArray(num_validators)


# per-peer gossip loops: quick bounded restarts; a loop that keeps
# crashing means the peer (or our state for it) is poison, so the
# give-up path drops the peer like the pre-supervisor error handlers
_GOSSIP_RESTART_POLICY = RestartPolicy(
    max_restarts=3, window_s=30.0, backoff_base_s=0.05,
    backoff_max_s=1.0)


class ConsensusReactor(Reactor):
    def __init__(self, cs: ConsensusState,
                 wait_sync: bool = False,
                 logger: Optional[Logger] = None):
        super().__init__("CONSENSUS")
        self.cs = cs
        self.wait_sync = wait_sync   # true while block/state syncing
        if logger is not None:
            self.logger = logger
        self._peer_states: dict[str, PeerState] = {}
        self._gossip_tasks: dict[str, list] = {}   # SupervisedTask
        # one encoded compact proposal per (height, round), shared by
        # every per-peer relay
        self._compact_raw: tuple = (None, b"")
        # wire the state machine's broadcasts through the switch
        cs.broadcast_hooks.append(self._on_cs_broadcast)
        cs.on_new_step.append(self._on_new_step)

    def get_channels(self) -> list[ChannelDescriptor]:
        """Reference: reactor.go StreamDescriptors.  The vote channel
        queue is sized for 100+ validator nets: at 102 signature
        slots per height the old 100-message queue filled inside one
        round (the send_queue_full/send_rate_stall events pinpointed
        it), dropping votes that then cost a maj23 round trip to
        recover."""
        return [
            ChannelDescriptor(id=STATE_CHANNEL, priority=6,
                              send_queue_capacity=200),
            ChannelDescriptor(id=DATA_CHANNEL, priority=10,
                              send_queue_capacity=100),
            ChannelDescriptor(id=VOTE_CHANNEL, priority=7,
                              send_queue_capacity=800),
            ChannelDescriptor(id=VOTE_SET_BITS_CHANNEL, priority=1,
                              send_queue_capacity=2),
        ]

    def get_features(self) -> list[str]:
        feats = []
        if getattr(self.cs.config, "compact_blocks", False):
            feats.append(FEATURE_COMPACT_BLOCKS)
        if getattr(self.cs.config, "vote_batch_max", 0) > 0:
            feats.append(FEATURE_VOTE_BATCH)
        if getattr(self.cs.config, "aggregate_commits_wire", True):
            feats.append(FEATURE_AGG_COMMIT)
        return feats

    def _chain_uses_aggregate_commits(self) -> bool:
        """True once the chain is AT the aggregate-commit activation
        point — the next height's commit will be an AggregateCommit,
        so blocks/catchup from here on carry wire arms a peer without
        aggcommit/1 cannot decode.  An enable height scheduled far in
        the future (param update) does NOT refuse peers early: every
        existing block is still per-signature and fully parseable;
        such peers are re-checked at activation by the gossip loop."""
        sm = self.cs.sm_state
        if sm is None:
            return False
        h = sm.consensus_params.feature.aggregate_commit_enable_height
        return h > 0 and sm.last_block_height + 1 >= h

    def _refuse_no_aggcommit(self, peer: Peer, when: str) -> None:
        """Drop a peer that lacks aggcommit/1 on an active
        aggregate-commit chain (shared by admission-time screening in
        add_peer and the activation re-check in the gossip loop)."""
        self.logger.error(
            "peer lacks aggcommit/1 on an aggregate-commit chain; "
            "dropping", peer=peer.id[:12], when=when)
        if self.switch is not None:
            self.supervisor.spawn(
                lambda: self.switch.stop_peer(
                    peer, "incompatible: no aggcommit/1"),
                name=f"stop_peer:{peer.id[:12]}",
                kind="stop_peer")

    def _peer_compact(self, peer: Peer) -> bool:
        if not getattr(self.cs.config, "compact_blocks", False):
            return False
        has = getattr(peer, "has_feature", None)
        return bool(has and has(FEATURE_COMPACT_BLOCKS))

    def _peer_vote_batch(self, peer: Peer) -> bool:
        if not getattr(self.cs.config, "vote_batch_max", 0):
            return False
        has = getattr(peer, "has_feature", None)
        return bool(has and has(FEATURE_VOTE_BATCH))

    # ------------------------------------------------------------------
    async def add_peer(self, peer: Peer) -> None:
        # once aggregation is ACTIVE a peer that cannot parse
        # AggregateCommit wire arms cannot decode this chain's blocks
        # — refuse it up front rather than let it choke on every
        # block part (capability declared in the handshake like
        # txrecon/compactblocks; ed25519 chains and pre-activation
        # heights admit it, and the gossip loop re-checks at
        # activation)
        if self._chain_uses_aggregate_commits():
            has = getattr(peer, "has_feature", None)
            if not (has and has(FEATURE_AGG_COMMIT)):
                self._refuse_no_aggcommit(peer, when="admission")
                return
        ps = PeerState(peer)
        self._peer_states[peer.id] = ps
        peer.data["consensus_peer_state"] = ps
        # supervisor-owned: a crash in a gossip loop restarts that
        # loop (with a restart metric) instead of silently muting the
        # peer until disconnect
        sup = self.supervisor
        pid = peer.id[:12]

        def _stop_peer_on_giveup(st, exc):
            # restart budget exhausted: the peer is poison — drop it
            # (the pre-supervisor behavior, now after bounded retries);
            # the one-shot teardown is itself supervised so a crash in
            # stop_peer is metered, never silent
            if self.switch is not None:
                sup.spawn(lambda: self.switch.stop_peer(
                    peer, repr(exc)), name=f"stop_peer:{pid}",
                    kind="stop_peer")

        policy = _GOSSIP_RESTART_POLICY
        self._gossip_tasks[peer.id] = [
            sup.spawn(lambda: self._gossip_data_routine(ps),
                      name=f"gossip_data:{pid}",
                      kind="consensus_gossip_data", policy=policy,
                      on_giveup=_stop_peer_on_giveup),
            sup.spawn(lambda: self._gossip_votes_routine(ps),
                      name=f"gossip_votes:{pid}",
                      kind="consensus_gossip_votes", policy=policy,
                      on_giveup=_stop_peer_on_giveup),
            sup.spawn(lambda: self._query_maj23_routine(ps),
                      name=f"query_maj23:{pid}",
                      kind="consensus_query_maj23", policy=policy,
                      on_giveup=_stop_peer_on_giveup),
        ]
        # tell the new peer our current state — but NOT while we're
        # block/state syncing: we drop incoming votes in that mode, and
        # advertising a live round makes peers gossip votes at us and
        # mark them delivered, wedging the round once we join
        # (reference: reactor.go AddPeer gates on !conR.WaitSync();
        # SwitchToConsensus re-announces via the step broadcast)
        if not self.wait_sync:
            peer.send(STATE_CHANNEL,
                      encode_p2p(self._new_round_step_msg()))

    async def remove_peer(self, peer: Peer, reason: str) -> None:
        self._peer_states.pop(peer.id, None)
        for t in self._gossip_tasks.pop(peer.id, []):
            t.cancel()

    # ------------------------------------------------------------------
    async def receive(self, chan_id: int, peer: Peer,
                      msg_bytes: bytes) -> None:
        """Reference: reactor.go Receive (:243)."""
        try:
            msg = decode_p2p(msg_bytes)
        except Exception as e:
            self.logger.error("failed to decode message",
                              peer=peer.id[:12], err=str(e))
            return
        ps = self._peer_states.get(peer.id)
        if ps is None:
            return
        rs = self.cs.rs

        if chan_id == STATE_CHANNEL:
            if isinstance(msg, NewRoundStepMessage):
                ps.apply_new_round_step(
                    msg, self.cs.rs.validators.size()
                    if self.cs.rs.validators else 0)
            elif isinstance(msg, NewValidBlockMessage):
                ps.apply_new_valid_block(msg)
            elif isinstance(msg, HasVoteMessage):
                ps.apply_has_vote(msg)
            elif isinstance(msg, HasProposalBlockPartMessage):
                ps.apply_has_proposal_block_part(msg)
            elif isinstance(msg, VoteSetMaj23Message):
                # record the claim, then reply with our vote bits
                if rs.height != msg.height or rs.votes is None:
                    return
                try:
                    rs.votes.set_peer_maj23(msg.round, msg.type,
                                            peer.id, msg.block_id)
                except Exception as e:
                    self.logger.info("bad VoteSetMaj23",
                                     err=str(e))
                    return
                vs = (rs.votes.prevotes(msg.round)
                      if msg.type == canonical.PREVOTE_TYPE
                      else rs.votes.precommits(msg.round))
                if vs is None:
                    return
                our_votes = vs.bit_array_by_block_id(msg.block_id)
                peer.send(VOTE_SET_BITS_CHANNEL, encode_p2p(
                    VoteSetBitsMessage(
                        height=msg.height, round=msg.round,
                        type=msg.type, block_id=msg.block_id,
                        votes=our_votes or BitArray(0))))
        elif self.wait_sync:
            return   # ignore data/votes while syncing
        elif chan_id == DATA_CHANNEL:
            if isinstance(msg, ProposalMessage):
                # first-seen marker for the fleet critical path: which
                # link delivered the proposal to this node, and when —
                # the state machine's proposal_received instant has no
                # peer attribution (it runs after the input queue)
                tracing.instant(tracing.CONSENSUS, "proposal_recv",
                                height=msg.proposal.height,
                                round=msg.proposal.round,
                                peer=peer.id[:12], chan=chan_id)
                ps.apply_proposal(msg)
                self.cs.send_peer(msg, peer.id)
            elif isinstance(msg, ProposalPOLMessage):
                ps.apply_proposal_pol(msg)
            elif isinstance(msg, BlockPartMessage):
                ps.set_has_proposal_block_part(msg.height, msg.round,
                                               msg.part.index)
                tracing.instant(tracing.CONSENSUS, "block_part_recv",
                                height=msg.height,
                                index=msg.part.index,
                                peer=peer.id[:12], chan=chan_id)
                self._credit_useful_part(chan_id, msg)
                self.cs.send_peer(msg, peer.id)
            elif isinstance(msg, CompactBlockPartMessage):
                # the sender holds the whole block — never push parts
                # back at it; reconstruction itself runs on the state
                # machine's input queue so it is ordered AFTER the
                # ProposalMessage the same peer sent just before it
                ps.mark_peer_has_full_block(msg.height, msg.round)
                tracing.instant(tracing.CONSENSUS,
                                "compact_block_recv",
                                height=msg.height,
                                txs=len(msg.tx_hashes),
                                peer=peer.id[:12], chan=chan_id)
                self.cs.send_peer(msg, peer.id)
            elif isinstance(msg, CompactBlockNackMessage):
                # the peer could not rebuild our compact proposal:
                # cancel its grace window and push every part it
                # lacks right now — the per-peer gossip routine backs
                # this up for anything the queue drops
                ps.clear_compact_grace(msg.height, msg.round)
                tracing.instant(tracing.CONSENSUS,
                                "compact_block_nack",
                                height=msg.height,
                                peer=peer.id[:12], chan=chan_id)
                self._push_parts_now(ps, msg.height, msg.round)
        elif chan_id == VOTE_CHANNEL:
            if isinstance(msg, VoteMessage):
                v = msg.vote
                self._credit_useful_vote(chan_id, ps, v,
                                         len(msg_bytes))
                ps.set_has_vote(v.height, v.round, v.type,
                                v.validator_index)
                tracing.instant(tracing.CONSENSUS, "vote_recv",
                                height=v.height, round=v.round,
                                type=v.type, index=v.validator_index,
                                peer=peer.id[:12], chan=chan_id)
                self.cs.send_peer(msg, peer.id)
            elif isinstance(msg, VoteBatchMessage):
                per = len(msg_bytes) // max(1, len(msg.votes))
                for v in msg.votes:
                    self._credit_useful_vote(chan_id, ps, v, per)
                    ps.set_has_vote(v.height, v.round, v.type,
                                    v.validator_index)
                    tracing.instant(tracing.CONSENSUS, "vote_recv",
                                    height=v.height, round=v.round,
                                    type=v.type,
                                    index=v.validator_index,
                                    peer=peer.id[:12], chan=chan_id)
                # ONE input-queue entry per wire message — expanding
                # the batch here would multiply queue pressure by the
                # batch size and defeat the p2p backpressure (the
                # catchup-storm QueueFull crash the recon nemesis
                # scenario caught); the state machine unpacks it
                self.cs.send_peer(msg, peer.id)
            elif isinstance(msg, AggregateCommitMessage):
                # aggregate-commit catchup: verified (off the event
                # loop) and injected as +2/3 precommit
                # evidence by the state machine.  Provably-stale or
                # forger-peer aggregates shed HERE so the input
                # queue — the backpressure buffer while a verdict
                # barrier is outstanding — only carries messages
                # that can still matter.
                if self.cs.aggregate_commit_relevant(msg.commit,
                                                     peer.id):
                    tracing.instant(tracing.CONSENSUS,
                                    "agg_commit_recv",
                                    height=msg.commit.height,
                                    peer=peer.id[:12], chan=chan_id)
                    self.cs.send_peer(msg, peer.id)
                else:
                    tracing.instant(tracing.CONSENSUS,
                                    "agg_commit_shed",
                                    height=msg.commit.height,
                                    peer=peer.id[:12])
        elif chan_id == VOTE_SET_BITS_CHANNEL:
            if isinstance(msg, VoteSetBitsMessage) and \
                    rs.height == msg.height and msg.votes is not None:
                vs = (rs.votes.prevotes(msg.round)
                      if msg.type == canonical.PREVOTE_TYPE
                      else rs.votes.precommits(msg.round))
                our = vs.bit_array_by_block_id(msg.block_id) \
                    if vs is not None else None
                ps.apply_vote_set_bits(msg, our)

    # ------------------------------------------------------------------
    # bytes-useful accounting (docs/gossip.md): credit payload bytes
    # that carried content this node actually lacked

    def _credit_useful(self, chan_id: int, n: int) -> None:
        if n > 0 and self.switch is not None:
            # chan_id is one of this reactor's four claimed channels
            # — a closed set, same boundedness as touch_channel's
            ch_id = f"{chan_id:#x}"
            self.switch.metrics.message_useful_bytes_total \
                .with_labels(ch_id).add(n)

    def _credit_useful_part(self, chan_id: int,
                            msg: BlockPartMessage) -> None:
        rs = self.cs.rs
        if rs.height == msg.height and \
                rs.proposal_block_parts is not None and \
                not rs.proposal_block_parts.has_part(msg.part.index):
            self._credit_useful(chan_id, len(msg.part.bytes_))

    def _credit_useful_vote(self, chan_id: int, ps: PeerState, v,
                            nbytes: int) -> None:
        rs = self.cs.rs
        if rs.height != v.height or rs.votes is None:
            return
        vs = (rs.votes.prevotes(v.round)
              if v.type == canonical.PREVOTE_TYPE
              else rs.votes.precommits(v.round))
        if vs is not None and 0 <= v.validator_index < \
                vs.bit_array().size() and \
                not vs.bit_array().get_index(v.validator_index):
            self._credit_useful(chan_id, nbytes)

    # ------------------------------------------------------------------
    # compact-block proposal relay (docs/gossip.md)

    def _push_parts_now(self, ps: PeerState, height: int,
                        round_: int) -> None:
        """Immediate full-part push after a nack: send every part the
        peer's bitmap lacks (TrySend semantics — drops are retried by
        the gossip routine)."""
        rs = self.cs.rs
        prs = ps.prs
        if rs.height != height or rs.round != round_ or \
                rs.proposal_block_parts is None:
            return
        theirs = prs.proposal_block_parts \
            if (prs.height, prs.round) == (height, round_) else None
        for i in range(rs.proposal_block_parts.total):
            if not rs.proposal_block_parts.has_part(i):
                continue
            if theirs is not None and theirs.get_index(i):
                continue
            part = rs.proposal_block_parts.get_part(i)
            if not ps.peer.send(DATA_CHANNEL, encode_p2p(
                    BlockPartMessage(height=height, round=round_,
                                     part=part))):
                return
            ps.set_has_proposal_block_part(height, round_, i)

    def _send_compact_block(self, ps: PeerState, height: int,
                            round_: int, raw_msg: bytes) -> bool:
        if ps.peer.send(DATA_CHANNEL, raw_msg):
            ps.mark_compact_sent(height, round_, time.monotonic())
            self.cs.metrics.compact_blocks_sent.add()
            return True
        return False

    @property
    def _compact_grace_s(self) -> float:
        return getattr(self.cs.config, "compact_block_grace_ns",
                       0) / 1e9

    # ------------------------------------------------------------------
    # broadcasts from the state machine

    def _on_cs_broadcast(self, msg) -> None:
        if self.switch is None:
            return
        if isinstance(msg, ProposalMessage):
            self.switch.broadcast(DATA_CHANNEL, encode_p2p(msg))
        elif isinstance(msg, tuple) and msg and \
                msg[0] == "compact_nack":
            # reconstruction failed on OUR side: ask the compact's
            # sender for full parts immediately
            _, height, round_, peer_id = msg
            peer = self.switch.peers.get(peer_id)
            if peer is not None:
                peer.send(DATA_CHANNEL, encode_p2p(
                    CompactBlockNackMessage(height=height,
                                            round=round_)))
        elif isinstance(msg, tuple) and msg and \
                msg[0] == "compact_block":
            # our own proposal just went out: compact-capable peers
            # get skeleton + tx hashes instead of the full parts
            _, height, round_, block, psh = msg
            raw = None
            for peer in list(self.switch.peers.values()):
                if not self._peer_compact(peer):
                    continue
                ps = self._peer_states.get(peer.id)
                if ps is None:
                    continue
                if raw is None:
                    raw = encode_p2p(make_compact_block(
                        height, round_, block, psh))
                self._send_compact_block(ps, height, round_, raw)
        elif isinstance(msg, BlockPartMessage):
            raw = encode_p2p(msg)
            now = time.monotonic()
            grace = self._compact_grace_s
            for peer in list(self.switch.peers.values()):
                ps = self._peer_states.get(peer.id)
                if ps is not None and grace > 0 and \
                        ps.compact_covers(msg.height, msg.round, now,
                                          grace):
                    # the peer is reconstructing from the compact
                    # form; the gossip routine resends any part it
                    # still misses once the grace window expires
                    continue
                peer.send(DATA_CHANNEL, raw)
        elif isinstance(msg, VoteMessage):
            v = msg.vote
            self.switch.broadcast(VOTE_CHANNEL, encode_p2p(msg))
            self.switch.broadcast(STATE_CHANNEL, encode_p2p(
                HasVoteMessage(height=v.height, round=v.round,
                               type=v.type, index=v.validator_index)))
        elif isinstance(msg, tuple) and msg and msg[0] == "has_vote":
            v = msg[1]
            self.switch.broadcast(STATE_CHANNEL, encode_p2p(
                HasVoteMessage(height=v.height, round=v.round,
                               type=v.type, index=v.validator_index)))
        elif isinstance(msg, tuple) and msg and msg[0] == "valid_block":
            self.switch.broadcast(STATE_CHANNEL,
                                  encode_p2p(self._valid_block_msg()))

    def _valid_block_msg(self) -> NewValidBlockMessage:
        """Reference: makeRoundStepMessages' NewValidBlockMessage —
        advertises the part-set header we are collecting and the
        bitmap of parts we ACTUALLY hold, so peers (re)send the rest
        even when their delivery bookkeeping says otherwise."""
        rs = self.cs.rs
        parts = rs.proposal_block_parts
        bits = BitArray(parts.total if parts is not None else 0)
        if parts is not None:
            for i, have in enumerate(parts.bit_array()):
                if have:
                    bits.set_index(i, True)
        return NewValidBlockMessage(
            height=rs.height, round=rs.round,
            block_part_set_header=(parts.header() if parts is not None
                                   else PartSetHeader()),
            block_parts=bits,
            is_commit=rs.step == STEP_COMMIT)

    def _new_round_step_msg(self) -> NewRoundStepMessage:
        rs = self.cs.rs
        # monotonic interval (clock-discipline): wall time here broke
        # under wall-clock steps; start_time stays wall only because
        # it derives from protocol timestamps
        return NewRoundStepMessage(
            height=rs.height, round=rs.round, step=rs.step,
            seconds_since_start_time=max(
                0, self.cs.seconds_since_start()),
            last_commit_round=rs.last_commit.round
            if rs.last_commit is not None else -1)

    def _on_new_step(self, rs: RoundState) -> None:
        if self.switch is not None:
            self.switch.broadcast(STATE_CHANNEL,
                                  encode_p2p(self._new_round_step_msg()))

    # ------------------------------------------------------------------
    # gossip routines (reference: reactor.go:594,654,718)

    @property
    def _sleep_s(self) -> float:
        return self.cs.config.peer_gossip_sleep_duration_ns / 1e9

    async def _gossip_data_routine(self, ps: PeerState) -> None:
        peer = ps.peer
        has = getattr(peer, "has_feature", None)
        peer_agg = bool(has and has(FEATURE_AGG_COMMIT))
        try:
            while True:
                # activation re-check: a peer admitted while the
                # enable height was still in the future becomes
                # incompatible the moment the chain reaches it
                # (add_peer only screens peers arriving afterwards)
                if not peer_agg and self._chain_uses_aggregate_commits():
                    self._refuse_no_aggcommit(peer, when="activation")
                    return
                rs = self.cs.rs
                prs = ps.prs
                # send proposal block parts the peer is missing
                if (rs.proposal_block_parts is not None and
                        rs.height == prs.height and
                        rs.round == prs.round and
                        prs.proposal_block_parts is not None and
                        rs.proposal_block_parts.header() ==
                        prs.proposal_block_parts_header):
                    # the peer sent us the compact form — it holds
                    # the whole block; don't echo parts back
                    if ps.peer_has_full_block(rs.height, rs.round):
                        await asyncio.sleep(self._sleep_s)
                        continue
                    # compact-first relay: a compact-capable peer
                    # with no parts yet gets skeleton + tx hashes
                    # once; full parts are held back for the grace
                    # window while it reconstructs (docs/gossip.md)
                    if self._relay_compact_maybe(ps, rs):
                        await asyncio.sleep(self._sleep_s)
                        continue
                    if ps.compact_covers(rs.height, rs.round,
                                         time.monotonic(),
                                         self._compact_grace_s):
                        await asyncio.sleep(self._sleep_s)
                        continue
                    sent = False
                    for i in range(rs.proposal_block_parts.total):
                        if rs.proposal_block_parts.has_part(i) and \
                                not prs.proposal_block_parts \
                                .get_index(i):
                            part = rs.proposal_block_parts.get_part(i)
                            if peer.send(DATA_CHANNEL, encode_p2p(
                                    BlockPartMessage(
                                        height=rs.height,
                                        round=rs.round, part=part))):
                                # seam: re-validates the peer's
                                # (height, round) at the write — the
                                # send above did not suspend, but the
                                # discipline is uniform
                                ps.set_has_proposal_block_part(
                                    rs.height, rs.round, i)
                                sent = True
                            break
                    if sent:
                        await asyncio.sleep(0)  # keep the loop fair
                        continue
                # peer is on an older height: catch up from block store
                if prs.height and prs.height < rs.height and \
                        prs.height >= self.cs.block_store.base:
                    if await self._gossip_catchup(ps):
                        await asyncio.sleep(0)  # keep the loop fair
                        continue
                # send the proposal if peer lacks it
                if (rs.proposal is not None and rs.height == prs.height
                        and rs.round == prs.round and
                        not prs.proposal):
                    sent_prop = peer.send(
                        DATA_CHANNEL,
                        encode_p2p(ProposalMessage(rs.proposal)))
                    if sent_prop:
                        ps.apply_proposal(ProposalMessage(rs.proposal))
                    if rs.proposal.pol_round >= 0:
                        pv = rs.votes.prevotes(rs.proposal.pol_round)
                        if pv is not None:
                            peer.send(DATA_CHANNEL, encode_p2p(
                                ProposalPOLMessage(
                                    height=rs.height,
                                    proposal_pol_round=rs.proposal
                                    .pol_round,
                                    proposal_pol=pv.bit_array())))
                    if sent_prop:
                        await asyncio.sleep(0)  # keep the loop fair
                        continue
                    # send queue full: prs.proposal stays False, so a
                    # bare continue would spin without ever yielding
                    # (a hard event-loop livelock caught by the
                    # nemesis crash/restart scenario) — fall through
                    # to the timed sleep and let the queue drain
                await asyncio.sleep(self._sleep_s)
        except asyncio.CancelledError:
            raise
        # any other exception propagates to the supervisor, which
        # restarts this loop (bounded) and drops the peer on give-up

    def _relay_compact_maybe(self, ps: PeerState, rs) -> bool:
        """Multi-hop compact relay: we assembled the full block (from
        parts or our own reconstruct) and the peer has none of it —
        send the compact form once instead of 64 KiB parts."""
        prs = ps.prs
        if not self._peer_compact(ps.peer):
            return False
        if rs.round != 0:
            return False           # churn rounds: full parts only
        if rs.proposal_block is None or \
                not rs.proposal_block_parts.is_complete():
            return False
        if len(rs.proposal_block.data.txs) < COMPACT_MIN_TXS:
            return False           # small blocks: parts are cheaper
        if ps.compact_hr == (rs.height, rs.round):
            return False           # already offered for this round
        if prs.proposal_block_parts is not None and \
                not prs.proposal_block_parts.is_empty():
            return False           # mid-download: finish with parts
        key = (rs.height, rs.round)
        if self._compact_raw[0] != key:
            self._compact_raw = (key, encode_p2p(make_compact_block(
                rs.height, rs.round, rs.proposal_block,
                rs.proposal_block_parts.header())))
        return self._send_compact_block(ps, rs.height, rs.round,
                                        self._compact_raw[1])

    async def _gossip_catchup(self, ps: PeerState) -> bool:
        """Send a block part from the store for a lagging peer
        (reference: gossipDataForCatchup)."""
        prs = ps.prs
        if prs.proposal_block_parts is None:
            # init from stored block meta
            meta = self.cs.block_store.load_block_meta(prs.height)
            if meta is None:
                return False
            # seam: installs header + bitmap re-validating the height
            ps.init_catchup_parts(prs.height,
                                  meta.block_id.part_set_header)
            if prs.proposal_block_parts is None:
                return False
        for i in range(prs.proposal_block_parts_header.total):
            if not prs.proposal_block_parts.get_index(i):
                part = self.cs.block_store.load_block_part(
                    prs.height, i)
                if part is None:
                    return False
                if ps.peer.send(DATA_CHANNEL, encode_p2p(
                        BlockPartMessage(height=prs.height,
                                         round=prs.round, part=part))):
                    ps.set_has_proposal_block_part(
                        prs.height, prs.round, i)
                    return True
                # peer's send queue is full — let it drain
                return False
        return False

    async def _gossip_votes_routine(self, ps: PeerState) -> None:
        peer = ps.peer
        try:
            while True:
                rs = self.cs.rs
                prs = ps.prs
                # every sent-a-vote branch yields before continuing:
                # the send helpers never suspend (queue puts), so a
                # peer that keeps accepting votes would otherwise
                # busy-spin this coroutine and starve the loop — a
                # livelock an interprocedural yield-in-loop check finds
                # once it stops crediting the never-awaiting
                # _gossip_votes_for_height await
                if rs.height == prs.height:
                    if await self._gossip_votes_for_height(rs, ps):
                        await asyncio.sleep(0)
                        continue
                # peer is on the previous height: send our last commit
                if (prs.height != 0 and
                        rs.height == prs.height + 1 and
                        rs.last_commit is not None):
                    if self._pick_send_vote(ps, rs.last_commit):
                        await asyncio.sleep(0)
                        continue
                # peer further behind: send precommits from stored
                # commit
                if (prs.height != 0 and
                        rs.height >= prs.height + 2 and
                        prs.height >= self.cs.block_store.base):
                    commit = self.cs.block_store.load_block_commit(
                        prs.height)
                    if isinstance(commit, AggregateCommit):
                        # aggregate chain: individual votes cannot be
                        # reconstructed — ship the aggregate itself
                        # (once per peer height, resent after a
                        # cooldown as a lost-message safety net)
                        if self._send_aggregate_commit(ps, commit):
                            await asyncio.sleep(0)
                            continue
                    elif commit is not None and \
                            self._pick_send_commit_vote(ps, commit):
                        await asyncio.sleep(0)
                        continue
                await asyncio.sleep(self._sleep_s)
        except asyncio.CancelledError:
            raise
        # crashes propagate to the supervisor (restart, then drop the
        # peer on give-up)

    async def _gossip_votes_for_height(self, rs, ps: PeerState) -> bool:
        """Reference: gossipVotesForHeight."""
        prs = ps.prs
        # peer just committed the previous height: our last commit helps
        # it finish (reference: gossipVotesForHeight lastCommit branch)
        if prs.step == STEP_NEW_HEIGHT and rs.last_commit is not None:
            if self._pick_send_vote(ps, rs.last_commit):
                return True
        if prs.proposal_pol_round != -1:
            pv = rs.votes.prevotes(prs.proposal_pol_round)
            if pv is not None and self._pick_send_vote(ps, pv):
                return True
        if prs.step <= STEP_PROPOSE and prs.round != -1 and \
                prs.round <= rs.round:
            pv = rs.votes.prevotes(prs.round)
            if pv is not None and self._pick_send_vote(ps, pv):
                return True
        if prs.step <= STEP_PREVOTE + 1 and prs.round != -1 and \
                prs.round <= rs.round:
            pv = rs.votes.prevotes(prs.round)
            if pv is not None and self._pick_send_vote(ps, pv):
                return True
        if prs.round != -1 and prs.round <= rs.round:
            pc = rs.votes.precommits(prs.round)
            if pc is not None and self._pick_send_vote(ps, pc):
                return True
        if prs.catchup_commit_round != -1:
            pc = rs.votes.precommits(prs.catchup_commit_round)
            if pc is not None and self._pick_send_vote(ps, pc):
                return True
        return False

    def _pick_send_vote(self, ps: PeerState, vote_set) -> bool:
        """Send votes the peer lacks (reference: PickSendVote).  On a
        votebatch/1 link up to ``consensus.vote_batch_max`` missing
        votes coalesce into one wire message — at 100+ validators the
        one-vote-per-message shape paid an envelope, a framing pass
        and a recv wakeup per signature (the same overhead the
        mempool's tx batching removes)."""
        ours = vote_set.bit_array()
        theirs = ps._votes_bitarray(vote_set.height, vote_set.round,
                                    vote_set.signed_msg_type)
        if theirs is None:
            # the peer-state does not track this vote set (reference
            # PickSendVote: nil bitarray -> no pick).  Sending anyway
            # can never be marked delivered — set_has_vote's write
            # drops for untracked sets — so the same votes would
            # re-send every gossip tick forever.  Unbatched that was
            # slow waste; vote batching amplified it 16x into the
            # QA_r08 livelock (315k vote messages across 12 heights
            # saturating the core at rate 50).
            return False
        missing = ours.sub(theirs)
        idx = missing.pick_random()
        if idx is None:
            return False
        batch_max = getattr(self.cs.config, "vote_batch_max", 0) \
            if self._peer_vote_batch(ps.peer) else 1
        if batch_max <= 1:
            vote = vote_set.get_by_index(idx)
            if vote is None:
                return False
            if ps.peer.send(VOTE_CHANNEL,
                            encode_p2p(VoteMessage(vote))):
                ps.set_has_vote(vote.height, vote.round, vote.type,
                                vote.validator_index)
                return True
            return False
        # batched: start at the random pick (keeps the reference's
        # fairness under loss), then sweep the remaining missing bits
        votes = []
        for i in [idx] + [j for j in missing.true_indices()
                          if j != idx]:
            v = vote_set.get_by_index(i)
            if v is not None:
                votes.append(v)
            if len(votes) >= batch_max:
                break
        if not votes:
            return False
        if ps.peer.send(VOTE_CHANNEL,
                        encode_p2p(VoteBatchMessage(votes))):
            self.cs.metrics.vote_batches_sent.add()
            for v in votes:
                ps.set_has_vote(v.height, v.round, v.type,
                                v.validator_index)
            return True
        return False

    _AGG_COMMIT_RESEND_S = 2.0

    def _send_aggregate_commit(self, ps: PeerState, commit) -> bool:
        """Ship the stored AggregateCommit for the peer's height —
        the catchup analogue of _pick_send_commit_vote on aggregate
        chains (one message replaces the per-vote stream)."""
        prs = ps.prs
        now = time.monotonic()
        if ps.agg_commit_sent_height == prs.height and \
                now - ps.agg_commit_sent_at < self._AGG_COMMIT_RESEND_S:
            return False
        if ps.peer.send(VOTE_CHANNEL, encode_p2p(
                AggregateCommitMessage(commit))):
            ps.agg_commit_sent_height = prs.height
            ps.agg_commit_sent_at = now
            return True
        return False

    def _pick_send_commit_vote(self, ps: PeerState, commit) -> bool:
        prs = ps.prs
        ps.ensure_catchup_commit_round(
            prs.height, commit.round,
            len(commit.signatures))
        theirs = prs.catchup_commit
        if theirs is None:
            return False
        for i, sig in enumerate(commit.signatures):
            if sig.absent_flag() or theirs.get_index(i):
                continue
            vote = commit.get_vote(i)
            if ps.peer.send(VOTE_CHANNEL,
                            encode_p2p(VoteMessage(vote))):
                theirs.set_index(i, True)
                return True
        return False

    async def _query_maj23_routine(self, ps: PeerState) -> None:
        """Periodically ask the peer for votes we might be missing
        (reference: queryMaj23Routine)."""
        peer = ps.peer
        sleep_s = self.cs.config \
            .peer_query_maj23_sleep_duration_ns / 1e9
        try:
            while True:
                await asyncio.sleep(sleep_s)
                rs = self.cs.rs
                prs = ps.prs
                # wedge guard: while we sit in the commit step with an
                # incomplete block, periodically re-advertise the part
                # bitmap we ACTUALLY hold.  A part lost on a lossy
                # link after the one-shot commit-entry announcement
                # would otherwise never be re-sent (the sender's
                # bookkeeping says delivered) and this node would stay
                # wedged forever — found by the nemesis faulty-links
                # scenario.
                if rs.step == STEP_COMMIT and \
                        rs.proposal_block_parts is not None and \
                        not rs.proposal_block_parts.is_complete():
                    peer.send(STATE_CHANNEL,
                              encode_p2p(self._valid_block_msg()))
                if rs.height != prs.height or rs.votes is None:
                    continue
                for type_, vs in ((canonical.PREVOTE_TYPE,
                                   rs.votes.prevotes(prs.round)),
                                  (canonical.PRECOMMIT_TYPE,
                                   rs.votes.precommits(prs.round))):
                    if vs is None:
                        continue
                    bid, ok = vs.two_thirds_majority()
                    if ok:
                        peer.send(STATE_CHANNEL, encode_p2p(
                            VoteSetMaj23Message(
                                height=prs.height, round=prs.round,
                                type=type_, block_id=bid)))
        except asyncio.CancelledError:
            raise
        # crashes propagate to the supervisor (restart, then drop the
        # peer on give-up)
