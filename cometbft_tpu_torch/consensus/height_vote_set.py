"""HeightVoteSet: all VoteSets for one height, keyed by round.

Reference: internal/consensus/types/height_vote_set.go — prevotes and
precommits per round, plus peer catch-up rounds (each peer may make us
track one extra round via SetPeerMaj23) — through
cometbft_tpu/consensus/height_vote_set.py (:1-127).
"""
from __future__ import annotations

from typing import Optional

from ..types import canonical
from ..types.validator_set import ValidatorSet
from ..types.vote import Vote
from ..types.vote_set import VoteSet


class HeightVoteSetError(Exception):
    pass


class HeightVoteSet:
    def __init__(self, chain_id: str, height: int,
                 val_set: ValidatorSet,
                 extensions_enabled: bool = False):
        self.chain_id = chain_id
        self.height = height
        self.val_set = val_set
        self.extensions_enabled = extensions_enabled
        self.round = 0
        self._round_vote_sets: dict[int, tuple[VoteSet, VoteSet]] = {}
        self._peer_catchup_rounds: dict[str, list[int]] = {}
        self._add_round(0)
        self.set_round(0)

    def reset(self, height: int, val_set: ValidatorSet) -> None:
        self.height = height
        self.val_set = val_set
        self.round = 0
        self._round_vote_sets = {}
        self._peer_catchup_rounds = {}
        self._add_round(0)
        self.set_round(0)

    def _add_round(self, round_: int) -> None:
        if round_ in self._round_vote_sets:
            raise HeightVoteSetError(f"add_round for existing {round_}")
        mk = VoteSet.extended if self.extensions_enabled else VoteSet
        prevotes = VoteSet(self.chain_id, self.height, round_,
                           canonical.PREVOTE_TYPE, self.val_set)
        precommits = mk(self.chain_id, self.height, round_,
                        canonical.PRECOMMIT_TYPE, self.val_set)
        self._round_vote_sets[round_] = (prevotes, precommits)

    def set_round(self, round_: int) -> None:
        """Track rounds 0..round+1 (reference: SetRound — round+1 allows
        round-skipping)."""
        new_round = self.round - 1 if self.round > 0 else 0
        if round_ < new_round and self.round != 0:
            raise HeightVoteSetError("set_round must increment round")
        for r in range(new_round, round_ + 2):
            if r not in self._round_vote_sets:
                self._add_round(r)
        self.round = round_

    def ensure_round_tracked(self, round_: int) -> None:
        """Track one specific round without advancing the round
        cursor.  Aggregate-commit catchup injects VERIFIED +2/3
        evidence for a commit round this node may never have reached
        locally (the chain decided at round 3 while we churned at 0)
        — allocation is bounded because callers verify the aggregate
        signature first."""
        if round_ >= 0 and round_ not in self._round_vote_sets:
            self._add_round(round_)

    # ------------------------------------------------------------------
    def add_vote(self, vote: Vote, peer_id: str = "") -> bool:
        """Returns True if added.  Unwanted rounds (beyond round+1) are
        only tracked as peer catch-up (one per peer)."""
        if not canonical.is_vote_type_valid(vote.type):
            raise HeightVoteSetError(f"invalid vote type {vote.type}")
        vote_set = self._get_vote_set(vote.round, vote.type)
        if vote_set is None:
            rounds = self._peer_catchup_rounds.setdefault(peer_id, [])
            if len(rounds) < 2:
                self._add_round(vote.round)
                vote_set = self._get_vote_set(vote.round, vote.type)
                rounds.append(vote.round)
            else:
                raise HeightVoteSetError(
                    "peer has sent a vote that does not match our round "
                    "for more than one round")
        return vote_set.add_vote(vote)

    def prevotes(self, round_: int) -> Optional[VoteSet]:
        return self._get_vote_set(round_, canonical.PREVOTE_TYPE)

    def precommits(self, round_: int) -> Optional[VoteSet]:
        return self._get_vote_set(round_, canonical.PRECOMMIT_TYPE)

    def _get_vote_set(self, round_: int,
                      type_: int) -> Optional[VoteSet]:
        rvs = self._round_vote_sets.get(round_)
        if rvs is None:
            return None
        return rvs[0] if type_ == canonical.PREVOTE_TYPE else rvs[1]

    # ------------------------------------------------------------------
    def pol_info(self) -> tuple[int, Optional[object]]:
        """Highest round with a 2/3 prevote majority (POL), or -1.

        Reference: POLInfo."""
        for r in range(self.round, -1, -1):
            pv = self.prevotes(r)
            if pv is not None:
                bid, ok = pv.two_thirds_majority()
                if ok:
                    return r, bid
        return -1, None

    def set_peer_maj23(self, round_: int, type_: int, peer_id: str,
                       block_id) -> None:
        if not canonical.is_vote_type_valid(type_):
            raise HeightVoteSetError(f"invalid vote type {type_}")
        vote_set = self._get_vote_set(round_, type_)
        if vote_set is None:
            return
        vote_set.set_peer_maj23(peer_id, block_id)
