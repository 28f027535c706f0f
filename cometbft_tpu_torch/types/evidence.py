"""Evidence of validator misbehaviour: what a light client reports.

Reference: types/evidence.go — DuplicateVoteEvidence (equivocation) and
LightClientAttackEvidence (a conflicting light block), their bytes and
hashes and the attribution of a light-client attack, through
cometbft_tpu/types/evidence.py:38-306.  Verifying evidence against the
chain's state belongs to the evidence pool (ROADMAP A.7e).
"""
from __future__ import annotations

from dataclasses import dataclass, field

from ..crypto import merkle, tmhash
from ..wire import encode, pb
from .block import LightBlock
from .commit import AggregateCommit
from .timestamp import Timestamp
from .validator import Validator
from .vote import BLOCK_ID_FLAG_COMMIT, Vote


class EvidenceError(Exception):
    pass


def _varint_bytes(n: int) -> bytes:
    """Go binary.PutVarint — zigzag varint."""
    zz = (n << 1) ^ (n >> 63) if n < 0 else n << 1
    out = bytearray()
    while True:
        b = zz & 0x7F
        zz >>= 7
        if zz:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


@dataclass
class DuplicateVoteEvidence:
    vote_a: Vote
    vote_b: Vote
    total_voting_power: int = 0
    validator_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp.zero)

    @classmethod
    def new(cls, vote1: Vote, vote2: Vote, block_time: Timestamp,
            val_set) -> "DuplicateVoteEvidence":
        """Orders the votes by BlockID key (reference: evidence.go
        NewDuplicateVoteEvidence)."""
        if vote1 is None or vote2 is None:
            raise EvidenceError("missing vote")
        _, val = val_set.get_by_address(vote1.validator_address)
        if val is None:
            raise EvidenceError("validator not in validator set")
        if vote1.block_id.key() < vote2.block_id.key():
            vote_a, vote_b = vote1, vote2
        else:
            vote_a, vote_b = vote2, vote1
        return cls(
            vote_a=vote_a, vote_b=vote_b,
            total_voting_power=val_set.total_voting_power(),
            validator_power=val.voting_power,
            timestamp=block_time,
        )

    def bytes(self) -> bytes:
        return encode(pb.DUPLICATE_VOTE_EVIDENCE, self.to_proto())

    def hash(self) -> bytes:
        return tmhash.sum(self.bytes())

    def validate_basic(self) -> None:
        if self.vote_a is None or self.vote_b is None:
            raise EvidenceError("empty duplicate vote evidence")
        self.vote_a.validate_basic()
        self.vote_b.validate_basic()
        if self.vote_a.block_id.key() >= self.vote_b.block_id.key():
            raise EvidenceError(
                "duplicate votes in invalid order (or the same block id)")

    def to_proto(self) -> dict:
        d: dict = {
            "vote_a": self.vote_a.to_proto(),
            "vote_b": self.vote_b.to_proto(),
            "timestamp": self.timestamp.to_proto(),
        }
        if self.total_voting_power:
            d["total_voting_power"] = self.total_voting_power
        if self.validator_power:
            d["validator_power"] = self.validator_power
        return d

    def to_proto_wrapped(self) -> dict:
        return {"duplicate_vote_evidence": self.to_proto()}

    @classmethod
    def from_proto(cls, d: dict) -> "DuplicateVoteEvidence":
        return cls(
            vote_a=Vote.from_proto(d.get("vote_a") or {}),
            vote_b=Vote.from_proto(d.get("vote_b") or {}),
            total_voting_power=d.get("total_voting_power", 0),
            validator_power=d.get("validator_power", 0),
            timestamp=Timestamp.from_proto(d.get("timestamp") or {}),
        )


def _signer_addrs(commit, vals) -> list[bytes]:
    """Addresses that signed FOR the commit's block: the signer bitmap
    resolved through ``vals`` for an aggregate commit, the COMMIT-flag
    CommitSigs otherwise."""
    if isinstance(commit, AggregateCommit):
        return [vals.validators[i].address
                for i in commit.signed_indices() if i < vals.size()]
    return [cs.validator_address for cs in commit.signatures
            if cs.block_id_flag == BLOCK_ID_FLAG_COMMIT]


@dataclass
class LightClientAttackEvidence:
    conflicting_block: LightBlock
    common_height: int
    byzantine_validators: list[Validator] = field(default_factory=list)
    total_voting_power: int = 0
    timestamp: Timestamp = field(default_factory=Timestamp.zero)

    def conflicting_header_is_invalid(self, trusted_header) -> bool:
        """Lunatic attack: a state-derived header field differs
        (reference: evidence.go ConflictingHeaderIsInvalid :313)."""
        ch = self.conflicting_block.signed_header.header
        return (trusted_header.validators_hash != ch.validators_hash or
                trusted_header.next_validators_hash !=
                ch.next_validators_hash or
                trusted_header.consensus_hash != ch.consensus_hash or
                trusted_header.app_hash != ch.app_hash or
                trusted_header.last_results_hash != ch.last_results_hash)

    def get_byzantine_validators(self, common_vals,
                                 trusted_signed_header
                                 ) -> list[Validator]:
        """Attribute the attack (reference: evidence.go
        GetByzantineValidators :260): lunatic -> the common set's
        validators who signed the conflicting header; equivocation (the
        same round) -> validators who signed both; amnesia (different
        rounds) -> unattributable, empty."""
        out: list[Validator] = []
        conflicting = self.conflicting_block
        conf_commit = conflicting.signed_header.commit
        trusted_commit = trusted_signed_header.commit
        if self.conflicting_header_is_invalid(
                trusted_signed_header.header):
            for addr in _signer_addrs(conf_commit,
                                      conflicting.validator_set):
                _, val = common_vals.get_by_address(addr)
                if val is not None:
                    out.append(val)
        elif trusted_commit.round == conf_commit.round:
            if isinstance(conf_commit, AggregateCommit) or \
                    isinstance(trusted_commit, AggregateCommit):
                # both signer sets, each resolved through its own
                # structure, intersected by address; the trusted
                # header's bitmap indexes the set at that height, which
                # common_vals stands for
                conf_addrs = set(_signer_addrs(
                    conf_commit, conflicting.validator_set))
                trusted_addrs = set(_signer_addrs(trusted_commit,
                                                  common_vals))
                for addr in conf_addrs & trusted_addrs:
                    _, val = conflicting.validator_set.get_by_address(addr)
                    if val is not None:
                        out.append(val)
            else:
                trusted_sigs = trusted_commit.signatures
                for i, sig_a in enumerate(conf_commit.signatures):
                    if sig_a.block_id_flag != BLOCK_ID_FLAG_COMMIT:
                        continue
                    if i >= len(trusted_sigs) or \
                            trusted_sigs[i].block_id_flag != \
                            BLOCK_ID_FLAG_COMMIT:
                        continue
                    _, val = conflicting.validator_set.get_by_address(
                        sig_a.validator_address)
                    if val is not None:
                        out.append(val)
        out.sort(key=lambda v: (-v.voting_power, v.address))
        return out

    def bytes(self) -> bytes:
        return encode(pb.LIGHT_CLIENT_ATTACK_EVIDENCE, self.to_proto())

    def hash(self) -> bytes:
        """sha256(conflicting block hash[:31] || varint common height)
        — reference: evidence.go:329-336, including its off-by-one
        truncation of the block hash."""
        buf = _varint_bytes(self.common_height)
        bz = bytearray(tmhash.SIZE + len(buf))
        bh = self.conflicting_block.hash()
        bz[:tmhash.SIZE - 1] = bh[:tmhash.SIZE - 1]
        bz[tmhash.SIZE:] = buf
        return tmhash.sum(bytes(bz))

    def validate_basic(self) -> None:
        if self.conflicting_block is None or \
                self.conflicting_block.signed_header is None:
            raise EvidenceError("conflicting block missing header")
        if self.common_height <= 0:
            raise EvidenceError("negative or zero common height")
        if self.conflicting_block.validator_set is None:
            raise EvidenceError("conflicting block missing validator set")
        self.conflicting_block.validate_basic(
            self.conflicting_block.signed_header.header.chain_id)

    def to_proto(self) -> dict:
        d: dict = {
            "conflicting_block": self.conflicting_block.to_proto(),
            "timestamp": self.timestamp.to_proto(),
        }
        if self.common_height:
            d["common_height"] = self.common_height
        if self.byzantine_validators:
            d["byzantine_validators"] = [
                v.to_proto() for v in self.byzantine_validators]
        if self.total_voting_power:
            d["total_voting_power"] = self.total_voting_power
        return d

    def to_proto_wrapped(self) -> dict:
        return {"light_client_attack_evidence": self.to_proto()}

    @classmethod
    def from_proto(cls, d: dict) -> "LightClientAttackEvidence":
        return cls(
            conflicting_block=LightBlock.from_proto(
                d.get("conflicting_block") or {}),
            common_height=d.get("common_height", 0),
            byzantine_validators=[
                Validator.from_proto(v)
                for v in d.get("byzantine_validators", [])],
            total_voting_power=d.get("total_voting_power", 0),
            timestamp=Timestamp.from_proto(d.get("timestamp") or {}),
        )


Evidence = DuplicateVoteEvidence | LightClientAttackEvidence


def evidence_from_proto_wrapped(d: dict) -> Evidence:
    if "duplicate_vote_evidence" in d:
        return DuplicateVoteEvidence.from_proto(d["duplicate_vote_evidence"])
    if "light_client_attack_evidence" in d:
        return LightClientAttackEvidence.from_proto(
            d["light_client_attack_evidence"])
    raise EvidenceError(f"unknown evidence oneof {sorted(d)}")


def evidence_list_hash(evidence: list[Evidence]) -> bytes:
    """Reference: evidence.go EvidenceList.Hash — merkle over proto bytes."""
    return merkle.hash_from_byte_slices([ev.bytes() for ev in evidence])
