"""Evidence pool: pending misbehaviour evidence kept in a db.

Reference: internal/evidence/pool.go — pending evidence keyed by
(height, hash), committed markers, expiry by age (blocks AND duration),
ReportConflictingVotes from consensus, verification (verify.go) —
through cometbft_tpu/evidence/pool.py, whose db rows (byte-equal),
verdicts and error texts this copy keeps.

``EvidencePool(..., device=None)`` resolves its device at construction
(the card; it raises where CUDA is absent).  A light-client attack is
verified on B1: ``verify_commit_light_trusting`` (a lunatic attack: a
third of the common set signed) and ``verify_commit_light`` (two thirds
of the conflicting set signed).  A duplicate vote is verified by
``Vote.verify``, the host ed25519.  A commit that does not verify is an
``EvidenceError``; a kernel that does not build or launch raises as it
is.  ``EvidenceError`` is a kind of ``types.evidence.EvidenceError``, so
the block executor can tell an invalid piece of evidence (an invalid
block) from a failing device.  A light-client attack that lacks its
conflicting block, signed header or validator set is refused with an
``EvidenceError`` before anything reads them (``_check_shape``), in
``add_evidence`` and ``check_evidence`` alike: the reference's
``LightBlockFromProto`` and ``ValidateBasic`` refuse it at decode.
"""
from __future__ import annotations

import struct
from typing import Optional

from ..db import DB
from ..device import resolve
from ..libs.log import Logger, new_logger
from ..state.state import State as SMState
from ..state.store import StateStoreError
from ..types import evidence as ev_types
from ..types.block import SignedHeader
from ..types.evidence import (
    DuplicateVoteEvidence, Evidence, LightClientAttackEvidence,
    evidence_from_proto_wrapped,
)
from ..types.timestamp import Timestamp
from ..types.validation import (
    Fraction, VerificationError, verify_commit_light,
    verify_commit_light_trusting,
)
from ..types.vote import Vote
from ..wire import decode, encode, pb

_PENDING = b"\x00"
_COMMITTED = b"\x01"


def _key(prefix: bytes, height: int, ev_hash: bytes) -> bytes:
    return prefix + struct.pack(">q", height) + ev_hash


class EvidenceError(ev_types.EvidenceError):
    pass


def _check_shape(ev: Evidence) -> None:
    """Refuse a light-client attack whose conflicting block is not whole,
    with LightClientAttackEvidence.validate_basic's texts."""
    if not isinstance(ev, LightClientAttackEvidence):
        return
    cb = ev.conflicting_block
    if cb is None or cb.signed_header is None or \
            cb.signed_header.header is None or \
            cb.signed_header.commit is None:
        raise EvidenceError("conflicting block missing header")
    if cb.validator_set is None:
        raise EvidenceError("conflicting block missing validator set")


class EvidencePool:
    def __init__(self, db: DB, state_store, block_store,
                 logger: Optional[Logger] = None, device=None):
        self.device = resolve(device)   # the card unless the caller names one
        self._db = db
        self.state_store = state_store
        self.block_store = block_store
        self.logger = logger if logger is not None else \
            new_logger("evidence")
        self.state: Optional[SMState] = state_store.load()
        # bumped whenever the pending set changes, so the reactor skips
        # rescans when nothing moved
        self.version = 0
        # our own conflicting-vote reports, waiting for a block time
        self._consensus_buffer: list[tuple[Vote, Vote]] = []

    # ------------------------------------------------------------------
    def report_conflicting_votes(self, vote_a: Vote,
                                 vote_b: Vote) -> None:
        """Called by consensus on an equivocation (reference:
        pool.ReportConflictingVotes; turned into evidence at the next
        update)."""
        self._consensus_buffer.append((vote_a, vote_b))

    def add_evidence(self, ev: Evidence) -> None:
        """Verify and keep gossiped or submitted evidence (reference:
        AddEvidence)."""
        _check_shape(ev)
        if self._is_pending(ev) or self._is_committed(ev):
            return
        self.verify(ev)
        self._add_pending(ev)
        self.logger.info("Verified new evidence of byzantine behavior",
                         evidence=ev.hash().hex().upper()[:12])

    # ------------------------------------------------------------------
    def verify(self, ev: Evidence) -> None:
        """Reference: internal/evidence/verify.go."""
        state = self.state or self.state_store.load()
        if state is None:
            raise EvidenceError("no state to verify evidence against")
        height = state.last_block_height
        ev_params = state.consensus_params.evidence

        block_meta = self.block_store.load_block_meta(ev.height)
        if block_meta is None:
            raise EvidenceError(
                f"don't have header at height {ev.height}")
        ev_time = block_meta.header.time

        # expired only when BOTH ages are past their limits
        age_blocks = height - ev.height
        age_ns = Timestamp.now().unix_ns() - ev_time.unix_ns()
        if age_blocks > ev_params.max_age_num_blocks and \
                age_ns > ev_params.max_age_duration_ns:
            raise EvidenceError(
                f"evidence from height {ev.height} is too old")

        if isinstance(ev, DuplicateVoteEvidence):
            self._verify_duplicate_vote(ev, state, ev_time)
        elif isinstance(ev, LightClientAttackEvidence):
            self._verify_light_client_attack(ev, state)
        else:
            raise EvidenceError(f"unknown evidence type {type(ev)}")

    def _signed_header(self, height: int) -> SignedHeader:
        meta = self.block_store.load_block_meta(height)
        commit = self.block_store.load_block_commit(height)
        if commit is None:
            commit = self.block_store.load_seen_commit(height)
        if meta is None or commit is None:
            raise EvidenceError(f"no header/commit at height {height}")
        return SignedHeader(header=meta.header, commit=commit)

    def _verify_light_client_attack(self, ev: LightClientAttackEvidence,
                                    state: SMState) -> None:
        """Rebuild and verify the attack against OUR chain (reference:
        verify.go VerifyLightClientAttack :105 and the common / trusted
        header plumbing of verify :55-84)."""
        common_header = self._signed_header(ev.height)
        common_vals = self.state_store.load_validators(ev.height)
        conflicting = ev.conflicting_block
        conf_height = conflicting.height
        trusted_header = common_header
        if ev.height != conf_height:
            try:
                trusted_header = self._signed_header(conf_height)
            except EvidenceError:
                # a forward lunatic attack: no block of ours there yet —
                # judge it against our latest (reference: verify.go
                # :71-83)
                trusted_header = self._signed_header(
                    self.block_store.height)
                if trusted_header.header.time.unix_ns() < \
                        conflicting.signed_header.header.time.unix_ns():
                    raise EvidenceError(
                        "latest block is before conflicting block — "
                        "cannot judge forward lunatic attack")

        chain_id = state.chain_id
        try:
            if common_header.header.height != conf_height:
                # lunatic: a third of the COMMON set must have signed it
                verify_commit_light_trusting(
                    chain_id, common_vals,
                    conflicting.signed_header.commit,
                    Fraction(1, 3), count_all_signatures=True,
                    signer_vals=conflicting.validator_set,
                    device=self.device)
            elif ev.conflicting_header_is_invalid(trusted_header.header):
                raise EvidenceError(
                    "common height equals conflicting height so the "
                    "conflicting header must be correctly derived")
            # two thirds of the conflicting set signed the conflicting
            # block
            verify_commit_light(
                chain_id, conflicting.validator_set,
                conflicting.signed_header.commit.block_id,
                conf_height, conflicting.signed_header.commit,
                count_all_signatures=True, device=self.device)
        except VerificationError as e:
            raise EvidenceError(
                f"invalid conflicting block commit: {e}") from None

        if ev.total_voting_power != common_vals.total_voting_power():
            raise EvidenceError(
                f"evidence voting power {ev.total_voting_power} != "
                f"common set power {common_vals.total_voting_power()}")

        conf_time = conflicting.signed_header.header.time
        if conf_height > trusted_header.header.height:
            if conf_time.unix_ns() > trusted_header.header.time.unix_ns():
                raise EvidenceError(
                    "conflicting block does not violate monotonic time")
        elif trusted_header.header.hash() == \
                conflicting.signed_header.header.hash():
            raise EvidenceError(
                "trusted header hash matches the conflicting header")

        # the ABCI-facing fields must be what WE derive (reference:
        # validateABCIEvidence :218)
        expect = ev.get_byzantine_validators(common_vals, trusted_header)
        if len(expect) != len(ev.byzantine_validators):
            raise EvidenceError(
                f"expected {len(expect)} byzantine validators, "
                f"got {len(ev.byzantine_validators)}")
        for want, got in zip(expect, ev.byzantine_validators):
            if want.address != got.address:
                raise EvidenceError(
                    "unexpected byzantine validator address")
        if ev.timestamp != common_header.header.time:
            raise EvidenceError(
                "evidence timestamp != common header time")

    def _verify_duplicate_vote(self, ev: DuplicateVoteEvidence,
                               state: SMState,
                               ev_time: Timestamp) -> None:
        """Reference: verify.go VerifyDuplicateVote."""
        val_set = self.state_store.load_validators(ev.height)
        _, val = val_set.get_by_address(ev.vote_a.validator_address)
        if val is None:
            raise EvidenceError(
                "address not a validator at evidence height")
        ev.validate_basic()
        ev.validate_abci()
        if ev.total_voting_power != val_set.total_voting_power():
            raise EvidenceError(
                f"total voting power mismatch: "
                f"{ev.total_voting_power} vs "
                f"{val_set.total_voting_power()}")
        if ev.validator_power != val.voting_power:
            raise EvidenceError("validator power mismatch")
        if ev.timestamp != ev_time:
            raise EvidenceError("evidence time mismatch")
        ev.vote_a.verify(state.chain_id, val.pub_key)
        ev.vote_b.verify(state.chain_id, val.pub_key)

    # ------------------------------------------------------------------
    def pending_evidence(self, max_bytes: int
                         ) -> tuple[list[Evidence], int]:
        """Reference: PendingEvidence — for a block proposal."""
        out, size = [], 0
        for _, raw in self._db.iterator(_PENDING, _PENDING + b"\xff" * 9):
            ev = evidence_from_proto_wrapped(decode(pb.EVIDENCE, raw))
            n = len(raw)
            if max_bytes >= 0 and size + n > max_bytes:
                break
            out.append(ev)
            size += n
        return out, size

    def check_evidence(self, evidence: list) -> None:
        """Validate a proposed block's evidence list (reference:
        CheckEvidence)."""
        seen = set()
        for ev in evidence:
            _check_shape(ev)
            h = ev.hash()
            if h in seen:
                raise EvidenceError("duplicate evidence in block")
            seen.add(h)
            if self._is_committed(ev):
                raise EvidenceError("evidence was already committed")
            if not self._is_pending(ev):
                self.verify(ev)

    def update(self, state: SMState, evidence: list) -> None:
        """After a commit: mark committed, prune the expired, turn the
        consensus reports into evidence (reference: pool.Update)."""
        self.state = state
        for ev in evidence:
            self._mark_committed(ev)
        self._process_consensus_buffer(state)
        self._prune_expired(state)

    def _process_consensus_buffer(self, state: SMState) -> None:
        buf, self._consensus_buffer = self._consensus_buffer, []
        for vote_a, vote_b in buf:
            try:
                block_meta = self.block_store.load_block_meta(vote_a.height)
                if block_meta is None:
                    continue
                val_set = self.state_store.load_validators(vote_a.height)
                ev = DuplicateVoteEvidence.new(
                    vote_a, vote_b, block_meta.header.time, val_set)
                if not self._is_pending(ev) and \
                        not self._is_committed(ev):
                    self._add_pending(ev)
                    self.logger.info("Generated duplicate-vote evidence",
                                     height=vote_a.height)
            except (ev_types.EvidenceError, StateStoreError) as e:
                self.logger.error(
                    "failed to generate evidence from conflicting votes",
                    err=str(e))

    # ------------------------------------------------------------------
    def _bump_version(self) -> None:
        self.version += 1

    def _add_pending(self, ev: Evidence) -> None:
        raw = encode(pb.EVIDENCE, ev.to_proto_wrapped())
        self._db.set(_key(_PENDING, ev.height, ev.hash()), raw)
        self._bump_version()

    def _is_pending(self, ev: Evidence) -> bool:
        return self._db.has(_key(_PENDING, ev.height, ev.hash()))

    def _is_committed(self, ev: Evidence) -> bool:
        return self._db.has(_key(_COMMITTED, ev.height, ev.hash()))

    def _mark_committed(self, ev: Evidence) -> None:
        self._db.set(_key(_COMMITTED, ev.height, ev.hash()), b"\x01")
        self._db.delete(_key(_PENDING, ev.height, ev.hash()))
        self._bump_version()

    def _prune_expired(self, state: SMState) -> None:
        """Expired only when BOTH ages are past their limits, as in
        verify (reference: isExpired)."""
        params = state.consensus_params.evidence
        height = state.last_block_height
        now_ns = Timestamp.now().unix_ns()
        for k, raw in list(self._db.iterator(
                _PENDING, _PENDING + b"\xff" * 9)):
            ev_height = struct.unpack(">q", k[1:9])[0]
            if height - ev_height <= params.max_age_num_blocks:
                continue
            meta = self.block_store.load_block_meta(ev_height)
            ev_time_ns = meta.header.time.unix_ns() \
                if meta is not None else 0
            if now_ns - ev_time_ns > params.max_age_duration_ns:
                self._db.delete(k)
                self._bump_version()

    def all_pending(self) -> list[Evidence]:
        out, _ = self.pending_evidence(-1)
        return out
