"""ValidatorSet: sorted validator list with proposer-priority round-robin.

Reference: types/validator_set.go — deterministic proposer selection
(:122-250), change-set updates with priority rescaling (:430-717), the
set's hash (merkle root over SimpleValidator bytes) and the by-address
index, through cometbft_tpu/types/validator_set.py.  The priority
arithmetic (int64 clipping, floor-average centering) matches the
reference bit for bit.

The hash and the address index are memoised; every change set drops
both memos, before it starts and again when it has reordered the set.
Lookups by address inside a change set go through one dict of the set
(the reference scans the list for each change, which is quadratic at
10,000 validators); the order of the checks and every error text are
the reference's.
"""
from __future__ import annotations

from typing import Iterable, Optional, Sequence

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
            self._update_with_change_set(vals, allow_deletes=False)
            self.increment_proposer_priority(1)

    # ------------------------------------------------------------------
    def is_nil_or_empty(self) -> bool:
        return len(self.validators) == 0

    def size(self) -> int:
        return len(self.validators)

    def copy(self) -> "ValidatorSet":
        cp = ValidatorSet()
        cp.validators = [v.copy() for v in self.validators]
        cp.proposer = self.proposer.copy() if self.proposer else None
        cp._total_voting_power = self._total_voting_power
        cp._all_keys_same_type = self._all_keys_same_type
        cp._hash_memo = self._hash_memo
        # _addr_index_memo stays None: rebuilt on first use
        return cp

    def has_address(self, address: bytes) -> bool:
        return self.index_by_address(address) >= 0

    def get_by_address(self, address: bytes) -> tuple[int, Optional[Validator]]:
        i = self.index_by_address(address)
        if i < 0:
            return -1, None
        return i, self.validators[i].copy()

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

    def copy_increment_proposer_priority(self, times: int) -> "ValidatorSet":
        cp = self.copy()
        cp.increment_proposer_priority(times)
        return cp

    def advance_proposer_priority_step(self) -> None:
        """One raw increment step without the rescale+shift prologue:
        the k-th loop iteration of increment_proposer_priority(k).  The
        state store's roll-forward cache uses it to stay bit-equal to
        the cold LoadValidators path."""
        self.proposer = self._increment_proposer_priority()

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
    # Change-set updates (reference: validator_set.go:430-717)

    def update_with_change_set(self, changes: Sequence[Validator]) -> None:
        self._update_with_change_set(
            [v.copy() for v in changes], allow_deletes=True)

    def _drop_memos(self) -> None:
        self._hash_memo = None
        self._addr_index_memo = None

    def _update_with_change_set(self, changes: list[Validator],
                                allow_deletes: bool) -> None:
        if not changes:
            return
        self._drop_memos()
        updates, deletes = self._process_changes(changes)
        if not allow_deletes and deletes:
            raise ValidatorSetError(
                "cannot process validators with voting power 0")
        current = {v.address: v for v in self.validators}
        new_count = sum(1 for u in updates if u.address not in current)
        if new_count == 0 and len(self.validators) == len(deletes):
            raise ValidatorSetError(
                "applying the validator changes would result in empty set")
        removed_power = self._verify_removals(deletes, current)
        tvp_after_updates = self._verify_updates(updates, removed_power,
                                                 current)
        self._compute_new_priorities(updates, tvp_after_updates, current)
        self._apply_updates(updates)
        self._apply_removals(deletes)
        self._check_all_keys_same_type()
        self._update_total_voting_power()
        self.rescale_priorities(
            PRIORITY_WINDOW_SIZE_FACTOR * self.total_voting_power())
        self._shift_by_avg_proposer_priority()
        self.validators.sort(key=_by_voting_power_key)
        self._drop_memos()

    @staticmethod
    def _process_changes(changes: list[Validator]):
        changes = sorted(changes, key=lambda v: v.address)
        updates: list[Validator] = []
        deletes: list[Validator] = []
        prev_addr = None
        for v in changes:
            if v.address == prev_addr:
                raise ValidatorSetError(f"duplicate entry {v}")
            if v.voting_power < 0:
                raise ValidatorSetError("voting power can't be negative")
            if v.voting_power > MAX_TOTAL_VOTING_POWER:
                raise ValidatorSetError(
                    f"voting power can't exceed {MAX_TOTAL_VOTING_POWER}")
            if v.voting_power == 0:
                deletes.append(v)
            else:
                updates.append(v)
            prev_addr = v.address
        return updates, deletes

    def _verify_updates(self, updates: list[Validator], removed_power: int,
                        current: dict[bytes, Validator]) -> int:
        def delta(u: Validator) -> int:
            val = current.get(u.address)
            return u.voting_power - val.voting_power if val else \
                u.voting_power

        tvp_after_removals = self.total_voting_power() - removed_power
        for u in sorted(updates, key=delta):
            tvp_after_removals += delta(u)
            if tvp_after_removals > MAX_TOTAL_VOTING_POWER:
                raise TotalVotingPowerOverflowError(
                    "total voting power overflow")
        return tvp_after_removals + removed_power

    def _verify_removals(self, deletes: list[Validator],
                         current: dict[bytes, Validator]) -> int:
        removed = 0
        for d in deletes:
            val = current.get(d.address)
            if val is None:
                raise ValidatorSetError(
                    f"failed to find validator {d.address.hex()} to remove")
            removed += val.voting_power
        if len(deletes) > len(self.validators):
            raise ValidatorSetError("more deletes than validators")
        return removed

    @staticmethod
    def _compute_new_priorities(updates: list[Validator], updated_tvp: int,
                                current: dict[bytes, Validator]) -> None:
        for u in updates:
            val = current.get(u.address)
            if val is None:
                # a new validator starts at -1.125*totalVotingPower so
                # unbond/re-bond can't reset a negative priority
                u.proposer_priority = -(updated_tvp + (updated_tvp >> 3))
            else:
                u.proposer_priority = val.proposer_priority

    def _apply_updates(self, updates: list[Validator]) -> None:
        existing = sorted(self.validators, key=lambda v: v.address)
        merged: list[Validator] = []
        i = j = 0
        while i < len(existing) and j < len(updates):
            if existing[i].address < updates[j].address:
                merged.append(existing[i])
                i += 1
            else:
                merged.append(updates[j])
                if existing[i].address == updates[j].address:
                    i += 1
                j += 1
        merged.extend(existing[i:])
        merged.extend(updates[j:])
        self.validators = merged

    def _apply_removals(self, deletes: list[Validator]) -> None:
        if not deletes:
            return
        gone = {d.address for d in deletes}
        self.validators = [v for v in self.validators
                           if v.address not in gone]

    # ------------------------------------------------------------------
    def hash(self) -> bytes:
        """Merkle root over SimpleValidator bytes (reference:
        validator_set.go Hash), memoised: it covers (pubkey, power)
        only, which proposer-priority rotation does not touch."""
        if self._hash_memo is None:
            self._hash_memo = merkle.hash_from_byte_slices(
                [v.bytes() for v in self.validators])
        return self._hash_memo

    def validate_basic(self) -> None:
        if self.is_nil_or_empty():
            raise ValidatorSetError("validator set is nil or empty")
        for v in self.validators:
            v.validate_basic()
        if self.proposer is None:
            raise ValidatorSetError("proposer failed validate basic")
        self.proposer.validate_basic()
        if not self.has_address(self.proposer.address):
            raise ValidatorSetError("proposer not in validator set")

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
