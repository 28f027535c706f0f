"""RoundState: the public snapshot of the consensus internal state.

Reference: internal/consensus/types/round_state.go:67 and the
RoundStepType enum, through cometbft_tpu/consensus/round_state.py.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from ..types.block import Block
from ..types.block_id import BlockID
from ..types.part_set import PartSet
from ..types.proposal import Proposal
from ..types.timestamp import Timestamp
from ..types.validator_set import ValidatorSet

# RoundStepType (reference: round_state.go:12-40)
STEP_NEW_HEIGHT = 1
STEP_NEW_ROUND = 2
STEP_PROPOSE = 3
STEP_PREVOTE = 4
STEP_PREVOTE_WAIT = 5
STEP_PRECOMMIT = 6
STEP_PRECOMMIT_WAIT = 7
STEP_COMMIT = 8

STEP_NAMES = {
    STEP_NEW_HEIGHT: "NewHeight",
    STEP_NEW_ROUND: "NewRound",
    STEP_PROPOSE: "Propose",
    STEP_PREVOTE: "Prevote",
    STEP_PREVOTE_WAIT: "PrevoteWait",
    STEP_PRECOMMIT: "Precommit",
    STEP_PRECOMMIT_WAIT: "PrecommitWait",
    STEP_COMMIT: "Commit",
}


@dataclass
class RoundState:
    height: int = 0
    round: int = 0
    step: int = STEP_NEW_HEIGHT
    start_time: Timestamp = field(default_factory=Timestamp.zero)
    commit_time: Timestamp = field(default_factory=Timestamp.zero)

    validators: Optional[ValidatorSet] = None
    proposal: Optional[Proposal] = None
    proposal_receive_time: Timestamp = field(
        default_factory=Timestamp.zero)
    proposal_block: Optional[Block] = None
    proposal_block_parts: Optional[PartSet] = None

    locked_round: int = -1
    locked_block: Optional[Block] = None
    locked_block_parts: Optional[PartSet] = None

    # Last known round with POL for non-nil valid block
    valid_round: int = -1
    valid_block: Optional[Block] = None
    valid_block_parts: Optional[PartSet] = None

    votes: Optional[object] = None    # HeightVoteSet
    commit_round: int = -1
    last_commit: Optional[object] = None  # VoteSet of last height precommits
    last_validators: Optional[ValidatorSet] = None
    triggered_timeout_precommit: bool = False

    # ------------------------------------------------------------------
    # state-transition seam (single-writer discipline, ROADMAP item 4)
    #
    # Every RoundState mutation the consensus machine performs after an
    # await point goes through one of these methods instead of ad-hoc
    # attribute stores.  Each transition re-validates its own
    # preconditions at the moment of the write — the re-check the
    # bftlint await-atomicity rule demands at a cross-await store —
    # so a decision computed before a suspension can never be applied
    # to a round the machine has already left.  With the commit
    # pipeline two heights can be in flight; the receive routine stays
    # the only caller, and these methods make that ownership (and its
    # monotonicity) structural rather than an informal argument.

    class TransitionError(Exception):
        """A transition that would move the round state backwards."""

    def advance(self, round_: int, step: int) -> None:
        """Advance (round, step) within the current height.

        Monotonic: refuses to move backwards — the re-validation at
        the store site that the informal single-writer argument used
        to stand in for."""
        if (round_, step) < (self.round, self.step):
            raise RoundState.TransitionError(
                f"advance({round_}/{STEP_NAMES.get(step)}) would move "
                f"{self} backwards")
        self.round = round_
        self.step = step

    def begin_round(self, round_: int, validators) -> None:
        """enterNewRound mutations: bump the round, install the
        round's proposer-rotated validator set, clear the previous
        round's proposal (rounds > 0), and track the next round's
        votes."""
        if round_ < self.round:
            raise RoundState.TransitionError(
                f"begin_round({round_}) would move {self} backwards")
        self.round = round_
        self.step = STEP_NEW_ROUND
        self.validators = validators
        if round_ != 0:
            self.proposal = None
            self.proposal_receive_time = Timestamp.zero()
            self.proposal_block = None
            self.proposal_block_parts = None
        self.votes.set_round(round_ + 1)   # track next round too
        self.triggered_timeout_precommit = False

    def lock(self, round_: int, block, parts) -> None:
        """Lock on a block (enterPrecommit +2/3-prevotes branch)."""
        if round_ < self.locked_round:
            raise RoundState.TransitionError(
                f"lock({round_}) below locked_round "
                f"{self.locked_round}")
        self.locked_round = round_
        self.locked_block = block
        self.locked_block_parts = parts

    def relock(self, round_: int) -> None:
        """Re-lock the already-locked block at a later round."""
        if self.locked_block is None or round_ < self.locked_round:
            raise RoundState.TransitionError(
                f"relock({round_}) without a valid earlier lock")
        self.locked_round = round_

    def set_valid(self, round_: int, block, parts) -> None:
        """Record the POL (valid) block for round_."""
        if round_ < self.valid_round:
            raise RoundState.TransitionError(
                f"set_valid({round_}) below valid_round "
                f"{self.valid_round}")
        self.valid_round = round_
        self.valid_block = block
        self.valid_block_parts = parts

    def reset_proposal_parts(self, psh) -> None:
        """Forget the (wrong or missing) proposal block and start
        collecting parts for the part-set header peers committed
        to."""
        self.proposal_block = None
        self.proposal_block_parts = PartSet(psh)

    def drop_proposal_block(self) -> None:
        """Forget an assembled proposal block (a quorum formed on a
        different one) while keeping the part collection state."""
        self.proposal_block = None

    def begin_height(self, height: int, start_time, validators,
                     votes, last_validators) -> None:
        """updateToState's reset: a fresh height at round 0 with every
        per-height field cleared."""
        self.height = height
        self.round = 0
        self.step = STEP_NEW_HEIGHT
        self.start_time = start_time
        self.validators = validators
        self.proposal = None
        self.proposal_receive_time = Timestamp.zero()
        self.proposal_block = None
        self.proposal_block_parts = None
        self.locked_round = -1
        self.locked_block = None
        self.locked_block_parts = None
        self.valid_round = -1
        self.valid_block = None
        self.valid_block_parts = None
        self.votes = votes
        self.commit_round = -1
        self.last_validators = last_validators
        self.triggered_timeout_precommit = False

    def adopt_block(self, block, parts) -> None:
        """Adopt a fully-known block (e.g. the locked block on commit
        entry) as the proposal block."""
        self.proposal_block = block
        self.proposal_block_parts = parts

    def set_last_commit(self, vote_set) -> None:
        """Install the previous height's precommits (updateToState /
        WAL-replay reconstruction).  None is legal only before the
        initial block; a VoteSet must actually hold a +2/3 majority —
        the property every later consumer (proposals, last_commit
        gossip) assumes."""
        if vote_set is not None and \
                hasattr(vote_set, "has_two_thirds_majority") and \
                not vote_set.has_two_thirds_majority():
            raise RoundState.TransitionError(
                "set_last_commit: vote set lacks a +2/3 majority")
        self.last_commit = vote_set

    def apply_proposal(self, proposal, recv_time) -> None:
        """Adopt the round's signed proposal (setProposal): at most
        once per round, and only for the CURRENT (height, round) —
        the re-check that a proposal validated before a suspension
        cannot land on a round the machine has already left.  Starts
        part collection when the part-set header isn't known yet."""
        if self.proposal is not None:
            raise RoundState.TransitionError(
                f"apply_proposal: {self} already has a proposal")
        if proposal.height != self.height or \
                proposal.round != self.round:
            raise RoundState.TransitionError(
                f"apply_proposal({proposal.height}/{proposal.round}) "
                f"does not match {self}")
        self.proposal = proposal
        self.proposal_receive_time = recv_time
        if self.proposal_block_parts is None:
            self.proposal_block_parts = PartSet(
                proposal.block_id.part_set_header)

    def complete_proposal_block(self, block) -> None:
        """Install the block assembled from the completed part set."""
        if self.proposal_block_parts is None or \
                not self.proposal_block_parts.is_complete():
            raise RoundState.TransitionError(
                "complete_proposal_block without a complete part set")
        self.proposal_block = block

    def mark_timeout_precommit(self, round_: int) -> None:
        """Record that the precommit-wait timeout was scheduled for
        round_ (enterPrecommitWait), exactly once per round."""
        if round_ < self.round or \
                (round_ == self.round and
                 self.triggered_timeout_precommit):
            raise RoundState.TransitionError(
                f"mark_timeout_precommit({round_}) already triggered "
                f"or behind {self}")
        self.triggered_timeout_precommit = True

    def rebuild_votes(self, validators, votes) -> None:
        """Pipeline reconcile: swap in the rebuilt validator set and
        height vote set after a pipelined apply landed with changed
        consensus params, keeping next-round vote tracking."""
        self.validators = validators
        self.votes = votes
        self.votes.set_round(self.round + 1)

    def enter_commit(self, commit_round: int, commit_time) -> None:
        """Enter the commit step for commit_round."""
        if self.step >= STEP_COMMIT:
            raise RoundState.TransitionError(
                f"enter_commit: {self} already committing")
        self.step = STEP_COMMIT
        self.commit_round = commit_round
        self.commit_time = commit_time

    def step_name(self) -> str:
        return STEP_NAMES.get(self.step, "Unknown")

    def proposal_block_id(self) -> Optional[BlockID]:
        if self.proposal_block is None or \
                self.proposal_block_parts is None:
            return None
        return BlockID(hash=self.proposal_block.hash(),
                       part_set_header=self.proposal_block_parts.header())

    def event_summary(self) -> dict:
        return {
            "height": self.height, "round": self.round,
            "step": self.step_name(),
        }

    def __str__(self) -> str:
        return (f"RoundState{{{self.height}/{self.round}/"
                f"{self.step_name()}}}")


@dataclass
class TimeoutInfo:
    duration_ns: int
    height: int
    round: int
    step: int

    def __str__(self) -> str:
        return (f"{self.duration_ns / 1e6:.0f}ms@{self.height}/"
                f"{self.round}/{STEP_NAMES.get(self.step)}")
