"""ValidatorSet: sorted validator list with proposer-priority round-robin.

Reference: types/validator_set.go — deterministic proposer selection
(:122-250), the initial change set of NewValidatorSet (:430-717), the
set's hash (merkle root over SimpleValidator bytes) and the by-address
index, through cometbft_tpu/types/validator_set.py.  Trimmed to a set
built from scratch: updates and deletions of a live set
(``update_with_change_set``) are not ported yet, so the memoised hash
and address index are never invalidated.  The priority arithmetic
(int64 clipping, floor-average centering) matches the reference
bit for bit.
"""
from __future__ import annotations

from typing import Iterable, Optional

from ..crypto import merkle
from .validator import (
    MAX_TOTAL_VOTING_POWER, PRIORITY_WINDOW_SIZE_FACTOR, Validator,
    safe_add_clip, safe_sub_clip,
)


class ValidatorSetError(Exception):
    pass


class TotalVotingPowerOverflowError(ValidatorSetError):
    pass


def _by_voting_power_key(v: Validator):
    # descending voting power, then ascending address
    return (-v.voting_power, v.address)


class ValidatorSet:
    def __init__(self, validators: Optional[Iterable[Validator]] = None):
        """NewValidatorSet: apply the initial change set, then rotate
        the proposer once.  Raises on invalid input (reference panics)."""
        self.validators: list[Validator] = []
        self.proposer: Optional[Validator] = None
        self._total_voting_power = 0
        self._all_keys_same_type = True
        self._hash_memo: Optional[bytes] = None
        self._addr_index_memo: Optional[dict[bytes, int]] = None
        vals = [v.copy() for v in (validators or [])]
        if vals:
            self._init_from(vals)
            self.increment_proposer_priority(1)

    def _init_from(self, vals: list[Validator]) -> None:
        vals.sort(key=lambda v: v.address)
        prev_addr = None
        for v in vals:
            if v.address == prev_addr:
                raise ValidatorSetError(f"duplicate entry {v}")
            if v.voting_power < 0:
                raise ValidatorSetError("voting power can't be negative")
            if v.voting_power > MAX_TOTAL_VOTING_POWER:
                raise ValidatorSetError(
                    f"voting power can't exceed {MAX_TOTAL_VOTING_POWER}")
            prev_addr = v.address
        if any(v.voting_power == 0 for v in vals):
            raise ValidatorSetError(
                "cannot process validators with voting power 0")
        tvp = 0
        for v in sorted(vals, key=lambda v: v.voting_power):
            tvp += v.voting_power
            if tvp > MAX_TOTAL_VOTING_POWER:
                raise TotalVotingPowerOverflowError(
                    "total voting power overflow")
        # a new validator starts at -1.125*totalVotingPower
        for v in vals:
            v.proposer_priority = -(tvp + (tvp >> 3))
        self.validators = vals
        self._check_all_keys_same_type()
        self._update_total_voting_power()
        self.rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        self.validators.sort(key=_by_voting_power_key)

    # ------------------------------------------------------------------
    def is_nil_or_empty(self) -> bool:
        return len(self.validators) == 0

    def size(self) -> int:
        return len(self.validators)

    def get_by_address(self, address: bytes) -> tuple[int, Optional[Validator]]:
        for i, v in enumerate(self.validators):
            if v.address == address:
                return i, v.copy()
        return -1, None

    def index_by_address(self, address: bytes) -> int:
        """Index of the validator with ``address``, or -1; O(1) after
        the first call (reference: validator_set.py:77-88)."""
        memo = self._addr_index_memo
        if memo is None:
            memo = {v.address: i for i, v in enumerate(self.validators)}
            self._addr_index_memo = memo
        return memo.get(address, -1)

    def get_by_index(self, index: int) -> tuple[bytes, Optional[Validator]]:
        if index < 0 or index >= len(self.validators):
            return b"", None
        v = self.validators[index]
        return v.address, v.copy()

    def all_keys_have_same_type(self) -> bool:
        return self._all_keys_same_type

    def _check_all_keys_same_type(self) -> None:
        types = {v.pub_key.type() for v in self.validators
                 if v.pub_key is not None}
        self._all_keys_same_type = len(types) <= 1

    # ------------------------------------------------------------------
    def total_voting_power(self) -> int:
        if self._total_voting_power == 0 and self.validators:
            self._update_total_voting_power()
        return self._total_voting_power

    def _update_total_voting_power(self) -> None:
        total = 0
        for v in self.validators:
            total = safe_add_clip(total, v.voting_power)
            if total > MAX_TOTAL_VOTING_POWER:
                raise TotalVotingPowerOverflowError(
                    f"total voting power exceeds {MAX_TOTAL_VOTING_POWER}")
        self._total_voting_power = total

    # ------------------------------------------------------------------
    # Proposer selection (reference: validator_set.go:122-250)

    def get_proposer(self) -> Validator:
        if not self.validators:
            raise ValidatorSetError("empty validator set")
        if self.proposer is None:
            self.proposer = self._find_proposer()
        return self.proposer.copy()

    def _find_proposer(self) -> Validator:
        proposer = None
        for v in self.validators:
            proposer = v if proposer is None else \
                proposer.compare_proposer_priority(v)
        return proposer

    def increment_proposer_priority(self, times: int) -> None:
        if self.is_nil_or_empty():
            raise ValidatorSetError("empty validator set")
        if times <= 0:
            raise ValidatorSetError(
                "cannot call increment_proposer_priority with "
                "non-positive times")
        diff_max = PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power()
        self.rescale_priorities(diff_max)
        self._shift_by_avg_proposer_priority()
        proposer = None
        for _ in range(times):
            proposer = self._increment_proposer_priority()
        self.proposer = proposer

    def _increment_proposer_priority(self) -> Validator:
        for v in self.validators:
            v.proposer_priority = safe_add_clip(
                v.proposer_priority, v.voting_power)
        mostest = self._find_proposer()
        mostest.proposer_priority = safe_sub_clip(
            mostest.proposer_priority, self.total_voting_power())
        return mostest

    def rescale_priorities(self, diff_max: int) -> None:
        if self.is_nil_or_empty():
            raise ValidatorSetError("empty validator set")
        if diff_max <= 0:
            return
        diff = self._max_min_priority_diff()
        ratio = (diff + diff_max - 1) // diff_max
        if diff > diff_max:
            for v in self.validators:
                # Go int64 division truncates toward zero
                p = v.proposer_priority
                v.proposer_priority = -(-p // ratio) if p < 0 else p // ratio

    def _max_min_priority_diff(self) -> int:
        mx = max(v.proposer_priority for v in self.validators)
        mn = min(v.proposer_priority for v in self.validators)
        return abs(mx - mn)

    def _compute_avg_proposer_priority(self) -> int:
        # big-int sum then floor division (Go big.Int.Div is Euclidean,
        # equal to floor for positive divisor)
        n = len(self.validators)
        total = sum(v.proposer_priority for v in self.validators)
        return total // n

    def _shift_by_avg_proposer_priority(self) -> None:
        avg = self._compute_avg_proposer_priority()
        for v in self.validators:
            v.proposer_priority = safe_sub_clip(v.proposer_priority, avg)

    # ------------------------------------------------------------------
    def hash(self) -> bytes:
        """Merkle root over SimpleValidator bytes (reference:
        validator_set.go Hash), memoised: it covers (pubkey, power)
        only, which proposer-priority rotation does not touch."""
        if self._hash_memo is None:
            self._hash_memo = merkle.hash_from_byte_slices(
                [v.bytes() for v in self.validators])
        return self._hash_memo

    # ------------------------------------------------------------------
    def to_proto(self) -> dict:
        d: dict = {
            "validators": [v.to_proto() for v in self.validators],
            "total_voting_power": self.total_voting_power(),
        }
        if self.proposer is not None:
            d["proposer"] = self.proposer.to_proto()
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "ValidatorSet":
        vs = cls()
        vs.validators = [Validator.from_proto(v)
                         for v in d.get("validators", [])]
        if d.get("proposer") is not None:
            vs.proposer = Validator.from_proto(d["proposer"])
        vs._check_all_keys_same_type()
        if vs.validators:
            vs._update_total_voting_power()
        return vs
