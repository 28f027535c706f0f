"""State store: persistence of sm.State and per-height lookback records.

Reference: state/store.go:157 (Store interface, dbStore impl) — state
record, validator sets and consensus params by height (with lookback
pointers so unchanged heights store only a reference), finalize-block
responses, pruning and the state-sync bootstrap — through
cometbft_tpu/state/store.py, whose rows this copy writes byte for byte.
"""
from __future__ import annotations

import struct
import threading
from typing import Optional

from ..abci import types as abci_types
from ..abci.pb import fbr_from_proto as _fbr_from_proto
from ..abci.pb import fbr_to_proto as _fbr_to_proto
from ..db import DB
from ..types.params import ConsensusParams
from ..types.validator_set import ValidatorSet
from ..wire import state_pb, encode, decode
from .state import State

_STATE_KEY = b"stateKey"
_VALIDATORS = b"\x10"       # height -> ValidatorsInfo
_CONSENSUS_PARAMS = b"\x11"  # height -> ConsensusParamsInfo
_ABCI_RESPONSES = b"\x12"   # height -> ABCIResponsesInfo

# how far ahead validator sets are known (nextValSet delay)
VAL_SET_CHECKPOINT_INTERVAL = 100000


def _h(height: int) -> bytes:
    return struct.pack(">q", height)


def _validators_key(height: int) -> bytes:
    return _VALIDATORS + _h(height)


def _params_key(height: int) -> bytes:
    return _CONSENSUS_PARAMS + _h(height)


def _abci_responses_key(height: int) -> bytes:
    return _ABCI_RESPONSES + _h(height)


class StateStoreError(Exception):
    pass


class Store:
    def __init__(self, db: DB):
        self._db = db
        self._lock = threading.RLock()
        # height -> (last_height_changed, set AS OF height, rolled).
        # The sparse storage scheme (full set only at change/checkpoint
        # heights) makes a cold load_validators(h) roll proposer
        # priorities forward O(h - stored) steps; block application
        # loads h-1 every height, which is O(h^2) over a run and
        # starves the event loop on long-lived chains.  Caching the
        # last few rolled-forward sets makes the sequential pattern
        # one increment step per height.
        #
        # Bit-equality with the cold path: increment(k) applies
        # rescale+shift ONCE, then k raw steps — so advancing a cached
        # set by one height must apply rescale+shift only when the
        # entry is the as-stored base (rolled=False); an already-rolled
        # entry advances by one RAW step.  Chaining any other way
        # diverges from the reference's one-shot LoadValidators when
        # the stored priority spread exceeds the rescale window.
        self._val_cache: dict[
            int, tuple[int, ValidatorSet, bool]] = {}

    # ------------------------------------------------------------------
    def load(self) -> Optional[State]:
        raw = self._db.get(_STATE_KEY)
        if raw is None:
            return None
        return State.from_bytes(raw)

    def save(self, state: State) -> None:
        """Persist state + the next validator set + params records.

        Reference: store.go save — writes validators at
        LastBlockHeight+2 (the nextValSet delay) and params at +1."""
        with self._lock:
            next_height = state.last_block_height + 1
            if state.last_block_height == 0:   # genesis bootstrap
                # reference: save uses InitialHeight when nextHeight == 1
                next_height = state.initial_height
                self._save_validators(next_height, state.validators,
                                      state.last_height_validators_changed)
            self._save_validators(next_height + 1, state.next_validators,
                                  state.last_height_validators_changed)
            self._save_params(next_height, state.consensus_params,
                              state.last_height_consensus_params_changed)
            self._db.set_sync(_STATE_KEY, state.bytes())

    def bootstrap(self, state: State) -> None:
        """Reference: store.go Bootstrap — used by state sync."""
        with self._lock:
            self._val_cache.clear()
            height = state.last_block_height + 1
            if height > 1 and state.last_validators is not None and \
                    state.last_validators.size() > 0:
                self._save_validators(
                    height - 1, state.last_validators, height - 1)
            self._save_validators(height, state.validators, height)
            self._save_validators(height + 1, state.next_validators,
                                  height + 1)
            self._save_params(
                height, state.consensus_params,
                state.last_height_consensus_params_changed or height)
            self._db.set_sync(_STATE_KEY, state.bytes())

    # ------------------------------------------------------------------
    def _save_validators(self, height: int, vals: ValidatorSet,
                         last_changed: int) -> None:
        # store the full set at change/checkpoint heights, else a pointer
        d: dict = {"last_height_changed": last_changed}
        if height == last_changed or \
                height % VAL_SET_CHECKPOINT_INTERVAL == 0:
            d["validator_set"] = vals.to_proto()
        self._val_cache.pop(height, None)   # record is being rewritten
        self._db.set(_validators_key(height),
                     encode(state_pb.VALIDATORS_INFO, d))

    @staticmethod
    def _last_stored_height_for(height: int, last_changed: int) -> int:
        """Reference: store.go lastStoredHeightFor — the nearest height
        at which a FULL validator set exists: the later of the last
        change height and the last checkpoint."""
        checkpoint = height - height % VAL_SET_CHECKPOINT_INTERVAL
        return max(checkpoint, last_changed)

    def load_validators(self, height: int) -> ValidatorSet:
        """Reference: store.go LoadValidators with checkpoint-aware
        lookback (plus the incremental roll-forward cache above)."""
        with self._lock:
            hit = self._val_cache.get(height)
            if hit is not None:
                return hit[1].copy()
            raw = self._db.get(_validators_key(height))
            if raw is None:
                raise StateStoreError(
                    f"no validator set found for height {height}")
            info = decode(state_pb.VALIDATORS_INFO, raw)
            if info.get("validator_set") is not None:
                vals = ValidatorSet.from_proto(info["validator_set"])
                self._cache_validators(
                    height, info.get("last_height_changed", height),
                    vals, rolled=False)
                return vals
            last_changed = info.get("last_height_changed", 0)
            prev = self._val_cache.get(height - 1)
            if prev is not None and prev[0] == last_changed:
                # same lineage: one priority step from height-1
                prev_lc, prev_vals, prev_rolled = prev
                if prev_rolled:
                    # already past rescale+shift: raw step only
                    vals = prev_vals.copy()
                    vals.advance_proposer_priority_step()
                else:
                    vals = prev_vals.copy_increment_proposer_priority(1)
                self._cache_validators(height, last_changed, vals,
                                       rolled=True)
                return vals
            stored_height = self._last_stored_height_for(
                height, last_changed)
            raw2 = self._db.get(_validators_key(stored_height))
            if raw2 is None:
                raise StateStoreError(
                    f"validator lookback to {stored_height} failed "
                    f"for height {height}")
            info2 = decode(state_pb.VALIDATORS_INFO, raw2)
            if info2.get("validator_set") is None:
                raise StateStoreError(
                    f"validator set at lookback height {stored_height} "
                    f"is empty")
            vals = ValidatorSet.from_proto(info2["validator_set"])
            # roll priorities forward to the requested height
            rolled = height > stored_height
            if rolled:
                vals.increment_proposer_priority(height - stored_height)
            self._cache_validators(height, last_changed, vals,
                                   rolled=rolled)
            return vals

    def _cache_validators(self, height: int, last_changed: int,
                          vals: ValidatorSet, *,
                          rolled: bool) -> None:
        """Remember the set (own copy); keep the cache to a handful of
        recent heights — the sequential block-apply pattern only ever
        needs height-1.  `rolled` records whether increment's
        rescale+shift prologue has run (see the cache comment)."""
        self._val_cache[height] = (last_changed, vals.copy(), rolled)
        if len(self._val_cache) > 8:
            for h in sorted(self._val_cache)[:-4]:
                del self._val_cache[h]

    # ------------------------------------------------------------------
    def _save_params(self, height: int, params: ConsensusParams,
                     last_changed: int) -> None:
        d: dict = {"last_height_changed": last_changed}
        if height == last_changed or \
                height % VAL_SET_CHECKPOINT_INTERVAL == 0:
            d["consensus_params"] = params.to_proto()
        else:
            d["consensus_params"] = {}
        self._db.set(_params_key(height),
                     encode(state_pb.CONSENSUS_PARAMS_INFO, d))

    def load_consensus_params(self, height: int) -> ConsensusParams:
        raw = self._db.get(_params_key(height))
        if raw is None:
            raise StateStoreError(
                f"no consensus params found for height {height}")
        info = decode(state_pb.CONSENSUS_PARAMS_INFO, raw)
        params_d = info.get("consensus_params") or {}
        if params_d:
            return ConsensusParams.from_proto(params_d)
        last_changed = info.get("last_height_changed", 0)
        raw2 = self._db.get(_params_key(last_changed))
        if raw2 is None:
            raise StateStoreError(
                f"params lookback to {last_changed} failed")
        info2 = decode(state_pb.CONSENSUS_PARAMS_INFO, raw2)
        if not info2.get("consensus_params"):
            raise StateStoreError(
                f"params at change-height {last_changed} are empty")
        return ConsensusParams.from_proto(info2["consensus_params"])

    # ------------------------------------------------------------------
    def save_finalize_block_response(self, height: int, resp) -> None:
        """Persist the FinalizeBlockResponse BEFORE app Commit so crash
        recovery can reconstruct results (reference: store.go
        SaveFinalizeBlockResponse)."""
        d = _fbr_to_proto(resp)
        self._db.set_sync(
            _abci_responses_key(height),
            encode(state_pb.ABCI_RESPONSES_INFO,
                   {"height": height, "finalize_block": d}))

    def load_finalize_block_response(self, height: int):
        raw = self._db.get(_abci_responses_key(height))
        if raw is None:
            return None
        info = decode(state_pb.ABCI_RESPONSES_INFO, raw)
        fb = info.get("finalize_block")
        return _fbr_from_proto(fb) if fb is not None else None

    # ------------------------------------------------------------------
    def prune_abci_responses(self, from_height: int,
                             to_height: int) -> int:
        """Delete stored FinalizeBlockResponses in [from, to) — the
        data-companion artifact class, pruned by the pruner's companion
        pass (reference: store.go PruneABCIResponses).  Returns number
        deleted."""
        if from_height <= 0 or to_height <= from_height:
            return 0
        batch = self._db.new_batch()
        pruned = 0
        for k, _ in list(self._db.iterator(
                _abci_responses_key(from_height),
                _abci_responses_key(to_height))):
            batch.delete(k)
            pruned += 1
        batch.write()
        return pruned

    # ------------------------------------------------------------------
    def prune_states(self, from_height: int, to_height: int,
                     evidence_threshold_height: int) -> int:
        """Delete state records in [from, to) (reference: store.go
        PruneStates — kept heights are materialized in full BEFORE their
        lookback targets are deleted); returns number pruned."""
        if from_height <= 0 or to_height <= from_height:
            return 0
        self._val_cache.clear()
        # heights whose FULL validator records must survive: the lookback
        # targets of to_height and of the evidence threshold (reference:
        # store.go PruneStates keepVals)
        keep_val_heights: set[int] = set()
        for keep in {to_height, evidence_threshold_height}:
            if keep <= 0:
                continue
            raw = self._db.get(_validators_key(keep))
            if raw is None:
                continue
            info = decode(state_pb.VALIDATORS_INFO, raw)
            if info.get("validator_set") is None:
                keep_val_heights.add(self._last_stored_height_for(
                    keep, info.get("last_height_changed", 0)))
        # materialize params at to_height so its pointer cannot dangle
        try:
            params = self.load_consensus_params(to_height)
            self._db.set(
                _params_key(to_height),
                encode(state_pb.CONSENSUS_PARAMS_INFO,
                       {"last_height_changed": to_height,
                        "consensus_params": params.to_proto()}))
        except StateStoreError:
            pass
        pruned = 0
        batch = self._db.new_batch()
        for h in range(from_height, to_height):
            batch.delete(_abci_responses_key(h))
            if h < evidence_threshold_height and \
                    h not in keep_val_heights:
                batch.delete(_validators_key(h))
            batch.delete(_params_key(h))
            pruned += 1
        batch.write()
        return pruned

