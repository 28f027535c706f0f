"""VoteSet: per-(height, round, type) vote tally with conflict tracking.

Reference: types/vote_set.go — two storage areas (.votes canonical,
.votesByBlock per-block with peer-maj23 tracking), 2/3 majority detection,
MakeExtendedCommit — through cometbft_tpu/types/vote_set.py (:1-384),
with the same error texts.  Memory is bounded: conflicting votes are only
tracked for blocks a peer claims have 2/3 (each peer gets one claim).

``add_vote`` verifies each vote serially (Vote.verify ->
vote.checked_verify); what a burst pre-verification put in the memo is
served from there, and only a miss verifies on the host.
"""
from __future__ import annotations

from typing import Optional

from ..libs.bits import BitArray
from . import canonical
from .block_id import BlockID
from .commit import ExtendedCommit, ExtendedCommitSig
from .validator_set import ValidatorSet
from .vote import (
    BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, BLOCK_ID_FLAG_NIL,
    InvalidSignatureError, Vote,
)
from .timestamp import Timestamp

MAX_VOTES_COUNT = 10000  # DoS bound; reference: vote_set.go:14


class VoteSetError(Exception):
    pass


class ConflictingVoteError(VoteSetError):
    """Equivocation detected: same validator, same step, different blocks."""

    def __init__(self, vote_a: Vote, vote_b: Vote):
        super().__init__(f"conflicting votes from validator "
                         f"{vote_a.validator_address.hex().upper()}")
        self.vote_a = vote_a
        self.vote_b = vote_b


class _BlockVotes:
    """Votes for one particular block (reference: blockVotes)."""

    __slots__ = ("peer_maj23", "bit_array", "votes", "sum")

    def __init__(self, peer_maj23: bool, num_validators: int):
        self.peer_maj23 = peer_maj23
        self.bit_array = BitArray(num_validators)
        self.votes: list[Optional[Vote]] = [None] * num_validators
        self.sum = 0

    def add_verified_vote(self, vote: Vote, voting_power: int) -> None:
        idx = vote.validator_index
        if self.votes[idx] is None:
            self.bit_array.set_index(idx, True)
            self.votes[idx] = vote
            self.sum += voting_power

    def get_by_index(self, idx: int) -> Optional[Vote]:
        return self.votes[idx]


class VoteSet:
    def __init__(self, chain_id: str, height: int, round_: int,
                 signed_msg_type: int, val_set: ValidatorSet,
                 extensions_enabled: bool = False):
        if height == 0:
            raise VoteSetError("cannot make VoteSet for height == 0")
        self.chain_id = chain_id
        self.height = height
        self.round = round_
        self.signed_msg_type = signed_msg_type
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self.votes_bit_array = BitArray(val_set.size())
        self.votes: list[Optional[Vote]] = [None] * val_set.size()
        self.sum = 0
        self.maj23: Optional[BlockID] = None
        self.votes_by_block: dict[bytes, _BlockVotes] = {}
        self.peer_maj23s: dict[str, BlockID] = {}
        # set only by from_aggregate_commit (restart without per-vote
        # signatures); the proposal path prefers it when present
        self.stored_aggregate_commit = None

    @classmethod
    def extended(cls, chain_id: str, height: int, round_: int,
                 signed_msg_type: int, val_set: ValidatorSet) -> "VoteSet":
        """NewExtendedVoteSet: verifies extension data on every vote."""
        return cls(chain_id, height, round_, signed_msg_type, val_set,
                   extensions_enabled=True)

    @classmethod
    def from_aggregate_commit(cls, chain_id: str, agg_commit,
                              val_set: ValidatorSet) -> "VoteSet":
        """LastCommit restored from an AggregateCommit (blocksync /
        statesync restart — no per-vote signatures exist on disk, so
        individual votes cannot be reconstructed).

        The set reports the 2/3 majority (maj23) the verified
        aggregate proves, holds the aggregate for re-proposal
        (make_extended_commit yields all-absent signatures; a proposer
        embeds stored_aggregate_commit instead), and still accepts late
        precommits via add_vote — sum starts at zero so live votes
        tally normally."""
        vs = cls(chain_id, agg_commit.height, agg_commit.round,
                 canonical.PRECOMMIT_TYPE, val_set)
        vs.maj23 = agg_commit.block_id
        vs.stored_aggregate_commit = agg_commit
        return vs

    # ------------------------------------------------------------------
    def size(self) -> int:
        return self.val_set.size()

    def get_height(self) -> int:
        return self.height

    def get_round(self) -> int:
        return self.round

    def type(self) -> int:
        return self.signed_msg_type

    # ------------------------------------------------------------------
    def add_vote(self, vote: Optional[Vote]) -> bool:
        """Add a vote; returns True if added (False for exact duplicates).

        Raises VoteSetError/ConflictingVoteError (reference: addVote)."""
        if vote is None:
            raise VoteSetError("nil vote")
        val_index = vote.validator_index
        val_addr = vote.validator_address
        block_key = vote.block_id.key()

        if val_index < 0:
            raise VoteSetError("validator index < 0")
        if not val_addr:
            raise VoteSetError("empty validator address")
        if (vote.height != self.height or vote.round != self.round or
                vote.type != self.signed_msg_type):
            raise VoteSetError(
                f"expected {self.height}/{self.round}/"
                f"{self.signed_msg_type}, got {vote.height}/"
                f"{vote.round}/{vote.type}")

        lookup_addr, val = self.val_set.get_by_index(val_index)
        if val is None:
            raise VoteSetError(
                f"cannot find validator {val_index} in valSet of size "
                f"{self.val_set.size()}")
        if val_addr != lookup_addr:
            raise VoteSetError(
                "vote validator address does not match index; ensure the "
                "genesis file is correct across all validators")

        existing = self._get_vote(val_index, block_key, vote.block_id)
        if existing is not None:
            if existing.signature == vote.signature:
                return False  # exact duplicate
            raise VoteSetError("non-deterministic signature")

        # verify signature (and extensions when enabled)
        try:
            if self.extensions_enabled:
                vote.verify_vote_and_extension(self.chain_id, val.pub_key)
            else:
                vote.verify(self.chain_id, val.pub_key)
                if (vote.extension or vote.extension_signature or
                        vote.non_rp_extension or
                        vote.non_rp_extension_signature):
                    raise VoteSetError(
                        "unexpected vote extension data present in vote")
        except InvalidSignatureError as e:
            raise VoteSetError(f"failed to verify vote: {e}") from e

        added, conflicting = self._add_verified_vote(
            vote, block_key, val.voting_power)
        if conflicting is not None:
            raise ConflictingVoteError(conflicting, vote)
        if not added:
            raise VoteSetError("expected to add non-conflicting vote")
        return True

    def _get_vote(self, val_index: int, block_key: bytes,
                  block_id: BlockID) -> Optional[Vote]:
        existing = self.votes[val_index]
        if existing is not None and existing.block_id == block_id:
            return existing
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            return bv.get_by_index(val_index)
        return None

    def _add_verified_vote(self, vote: Vote, block_key: bytes,
                           voting_power: int):
        """Reference: addVerifiedVote — returns (added, conflicting)."""
        val_index = vote.validator_index
        conflicting: Optional[Vote] = None

        existing = self.votes[val_index]
        if existing is not None:
            if existing.block_id == vote.block_id:
                raise VoteSetError(
                    "add_verified_vote does not expect duplicate votes")
            conflicting = existing
            # replace canonical vote only if it matches a known maj23
            if self.maj23 is not None and self.maj23 == vote.block_id:
                self.votes[val_index] = vote
                self.votes_bit_array.set_index(val_index, True)
        else:
            self.votes[val_index] = vote
            self.votes_bit_array.set_index(val_index, True)
            self.sum += voting_power

        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            if conflicting is not None and not bv.peer_maj23:
                # conflict and no peer claims this block is special
                return False, conflicting
        else:
            if conflicting is not None:
                # not tracking this block — forget it
                return False, conflicting
            bv = _BlockVotes(False, self.val_set.size())
            self.votes_by_block[block_key] = bv

        orig_sum = bv.sum
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        bv.add_verified_vote(vote, voting_power)

        if orig_sum < quorum <= bv.sum and self.maj23 is None:
            self.maj23 = vote.block_id
            # copy this block's votes over to the canonical list
            for i, v in enumerate(bv.votes):
                if v is not None:
                    self.votes[i] = v
        return True, conflicting

    # ------------------------------------------------------------------
    def set_peer_maj23(self, peer_id: str, block_id: BlockID) -> None:
        """A peer claims 2/3 majority for block_id (reference:
        SetPeerMaj23)."""
        block_key = block_id.key()
        existing = self.peer_maj23s.get(peer_id)
        if existing is not None:
            if existing == block_id:
                return
            raise VoteSetError(
                f"conflicting blockID from peer {peer_id}")
        self.peer_maj23s[peer_id] = block_id
        bv = self.votes_by_block.get(block_key)
        if bv is not None:
            bv.peer_maj23 = True
        else:
            self.votes_by_block[block_key] = _BlockVotes(
                True, self.val_set.size())

    # ------------------------------------------------------------------
    def bit_array(self) -> BitArray:
        return self.votes_bit_array.copy()

    def bit_array_by_block_id(self, block_id: BlockID) -> Optional[BitArray]:
        bv = self.votes_by_block.get(block_id.key())
        return bv.bit_array.copy() if bv is not None else None

    def get_by_index(self, val_index: int) -> Optional[Vote]:
        return self.votes[val_index]

    def get_by_address(self, address: bytes) -> Optional[Vote]:
        idx, val = self.val_set.get_by_address(address)
        if val is None:
            raise VoteSetError("address not in validator set")
        return self.votes[idx]

    def list(self) -> list[Vote]:
        return [v for v in self.votes if v is not None]

    def has_two_thirds_majority(self) -> bool:
        return self.maj23 is not None

    def has_two_thirds_votes_for_maj23(self) -> bool:
        """True when the INDIVIDUAL votes held for maj23 reach quorum
        — distinguishes a live vote set from one whose majority is
        proven only by an injected/restored aggregate commit (the
        latter has maj23 set but few or no votes)."""
        if self.maj23 is None:
            return False
        bv = self.votes_by_block.get(self.maj23.key())
        quorum = self.val_set.total_voting_power() * 2 // 3 + 1
        return bv is not None and bv.sum >= quorum

    def inject_aggregate_majority(self, agg_commit) -> bool:
        """Record a VERIFIED aggregate commit as this round's +2/3
        precommit evidence (catchup on aggregate-commit chains — the
        caller MUST have verified it against the height's validator
        set first).  Keeps any live majority already found; refuses a
        conflicting one (two verified majorities for different blocks
        at one height/round is a safety violation upstream, not
        something to paper over here)."""
        if self.signed_msg_type != canonical.PRECOMMIT_TYPE or \
                agg_commit.height != self.height or \
                agg_commit.round != self.round:
            return False
        if self.maj23 is not None and self.maj23 != agg_commit.block_id:
            return False
        self.maj23 = agg_commit.block_id
        self.stored_aggregate_commit = agg_commit
        return True

    def is_commit(self) -> bool:
        return (self.signed_msg_type == canonical.PRECOMMIT_TYPE and
                self.maj23 is not None)

    def has_two_thirds_any(self) -> bool:
        return self.sum > self.val_set.total_voting_power() * 2 // 3

    def has_all(self) -> bool:
        return self.sum == self.val_set.total_voting_power()

    def two_thirds_majority(self) -> tuple[BlockID, bool]:
        if self.maj23 is not None:
            return self.maj23, True
        return BlockID(), False

    # ------------------------------------------------------------------
    def make_extended_commit(self, extensions_enabled_height: int = 0
                             ) -> ExtendedCommit:
        """Build the ExtendedCommit once 2/3 precommitted a block.

        Reference: vote_set.go MakeExtendedCommit (:638)."""
        if self.signed_msg_type != canonical.PRECOMMIT_TYPE:
            raise VoteSetError(
                "cannot make_extended_commit unless type is Precommit")
        if self.maj23 is None:
            raise VoteSetError(
                "cannot make_extended_commit unless a block has +2/3")
        sigs = []
        for v in self.votes:
            sig = _extended_commit_sig(v)
            # if block ID exists but doesn't match maj23, exclude sig
            if sig.block_id_flag == BLOCK_ID_FLAG_COMMIT and \
                    v.block_id != self.maj23:
                sig = _absent_extended_commit_sig()
            sigs.append(sig)
        ec = ExtendedCommit(
            height=self.height, round=self.round, block_id=self.maj23,
            extended_signatures=sigs)
        ext_enabled = (extensions_enabled_height > 0 and
                       ec.height >= extensions_enabled_height)
        ec.ensure_extensions(ext_enabled)
        return ec

    def log_string(self) -> str:
        total = self.val_set.total_voting_power()
        frac = self.sum / total if total else 0.0
        return f"Votes:{self.sum}/{total}({frac:.3f})"

    def __str__(self) -> str:
        return (f"VoteSet{{H:{self.height} R:{self.round} "
                f"T:{self.signed_msg_type} +2/3:{self.maj23} "
                f"{self.votes_bit_array}}}")


def _absent_extended_commit_sig() -> ExtendedCommitSig:
    return ExtendedCommitSig(block_id_flag=BLOCK_ID_FLAG_ABSENT,
                             timestamp=Timestamp.zero())


def _extended_commit_sig(v: Optional[Vote]) -> ExtendedCommitSig:
    """Reference: vote.go ExtendedCommitSig — absent for nil vote."""
    if v is None:
        return _absent_extended_commit_sig()
    flag = BLOCK_ID_FLAG_NIL if v.block_id.is_nil() else \
        BLOCK_ID_FLAG_COMMIT
    return ExtendedCommitSig(
        block_id_flag=flag,
        validator_address=v.validator_address,
        timestamp=v.timestamp,
        signature=v.signature,
        extension=v.extension,
        extension_signature=v.extension_signature,
        non_rp_extension=v.non_rp_extension,
        non_rp_extension_signature=v.non_rp_extension_signature,
    )
