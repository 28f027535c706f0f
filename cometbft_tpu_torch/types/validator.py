"""Validator: address, pubkey, voting power, proposer priority.

Reference: types/validator.go.
"""
from __future__ import annotations

from dataclasses import dataclass, replace

from ..crypto import encoding
from ..crypto.keys import PubKey
from ..wire import encode, pb

INT64_MAX = (1 << 63) - 1
INT64_MIN = -(1 << 63)

# MaxTotalVotingPower — reference: types/validator_set.go (MaxInt64 / 8)
MAX_TOTAL_VOTING_POWER = INT64_MAX // 8
# PriorityWindowSizeFactor — reference: types/validator_set.go
PRIORITY_WINDOW_SIZE_FACTOR = 2


def safe_add_clip(a: int, b: int) -> int:
    c = a + b
    return min(max(c, INT64_MIN), INT64_MAX)


def safe_sub_clip(a: int, b: int) -> int:
    c = a - b
    return min(max(c, INT64_MIN), INT64_MAX)


class ValidatorError(Exception):
    pass


def pub_key_from_type_and_bytes(key_type: str, raw: bytes) -> PubKey:
    """Reference: crypto/encoding codec — ed25519, secp256k1,
    secp256k1eth and bls12_381 (crypto/encoding.py)."""
    return encoding.pub_key_from_type_and_bytes(key_type, raw)


@dataclass
class Validator:
    address: bytes
    pub_key: PubKey
    voting_power: int
    proposer_priority: int = 0

    @classmethod
    def new(cls, pub_key: PubKey, voting_power: int) -> "Validator":
        return cls(address=pub_key.address(), pub_key=pub_key,
                   voting_power=voting_power, proposer_priority=0)

    def validate_basic(self) -> None:
        if self.pub_key is None:
            raise ValidatorError("validator does not have a public key")
        if self.voting_power < 0:
            raise ValidatorError("validator has negative voting power")
        if len(self.address) != 20:
            raise ValidatorError("wrong validator address size")

    def copy(self) -> "Validator":
        return replace(self)

    def compare_proposer_priority(self, other: "Validator") -> "Validator":
        """Higher priority wins; ties break toward the lower address.

        Reference: validator.go CompareProposerPriority."""
        if self.proposer_priority > other.proposer_priority:
            return self
        if self.proposer_priority < other.proposer_priority:
            return other
        if self.address < other.address:
            return self
        if self.address > other.address:
            return other
        raise ValidatorError("cannot compare identical validators")

    def bytes(self) -> bytes:
        """SimpleValidator proto bytes — merkle leaf for ValidatorSet.Hash.

        Reference: validator.go Bytes (:142-158)."""
        return encode(pb.SIMPLE_VALIDATOR, {
            "pub_key": encoding.pub_key_to_proto(self.pub_key),
            "voting_power": self.voting_power,
        })

    def to_proto(self) -> dict:
        d: dict = {}
        if self.address:
            d["address"] = self.address
        if self.voting_power:
            d["voting_power"] = self.voting_power
        if self.proposer_priority:
            d["proposer_priority"] = self.proposer_priority
        d["pub_key_bytes"] = self.pub_key.bytes()
        d["pub_key_type"] = self.pub_key.type()
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "Validator":
        if d.get("pub_key_bytes"):
            pk = encoding.pub_key_from_type_and_bytes(
                d.get("pub_key_type", "ed25519"), d["pub_key_bytes"])
        else:
            pk = encoding.pub_key_from_proto(d.get("pub_key") or {})
        return cls(
            address=d.get("address", b"") or pk.address(),
            pub_key=pk,
            voting_power=d.get("voting_power", 0),
            proposer_priority=d.get("proposer_priority", 0),
        )

    def __str__(self) -> str:
        return (f"Validator{{{self.address.hex().upper()[:12]} "
                f"VP:{self.voting_power} A:{self.proposer_priority}}}")
