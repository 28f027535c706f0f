"""State rollback: rewind one height after an app upgrade gone wrong.

Reference: state/rollback.go (:126) — reconstruct the previous state
from stored validators/params + the rolled-back block's header; a copy of
cometbft_tpu/state/rollback.py, with the same rows and texts.  Where the
reference turns any error of the last validator set's load into an empty
set, this copy does so only for the store's own ``StateStoreError`` (a
missing or pruned row) and raises anything else.
"""
from __future__ import annotations

from ..types.block_id import BlockID
from ..types.validator_set import ValidatorSet
from .state import State
from .store import StateStoreError, Store


class RollbackError(Exception):
    pass


def rollback_state(state_store: Store, block_store,
                   remove_block: bool = False) -> tuple[int, bytes]:
    """Roll state back one height; optionally delete the latest block
    too.  Returns (new_height, app_hash)."""
    invalid_state = state_store.load()
    if invalid_state is None:
        raise RollbackError("no state found")
    height = block_store.height

    # the block at `height` is the one being discarded; its header
    # carries the app hash AFTER height-1
    rollback_height = invalid_state.last_block_height
    if rollback_height != height and rollback_height != height - 1:
        raise RollbackError(
            f"statestore height ({rollback_height}) is not one off "
            f"from blockstore height ({height})")

    rolled_back_block = block_store.load_block_meta(rollback_height)
    if rolled_back_block is None:
        raise RollbackError(f"block at height {rollback_height} "
                            f"not found")
    prev_height = rollback_height - 1
    prev_meta = block_store.load_block_meta(prev_height)
    if prev_meta is None:
        raise RollbackError(f"block at height {prev_height} not found")

    # state with last_block_height = H-1 holds: LastValidators = set at
    # H-1, Validators = set at H, NextValidators = set at H+1
    params = state_store.load_consensus_params(rollback_height)
    validators = state_store.load_validators(rollback_height)
    next_validators = state_store.load_validators(rollback_height + 1)
    try:
        last_validators = state_store.load_validators(prev_height)
    except StateStoreError:
        last_validators = ValidatorSet()

    new_state = State(
        version=invalid_state.version,
        chain_id=invalid_state.chain_id,
        initial_height=invalid_state.initial_height,
        last_block_height=prev_meta.header.height,
        last_block_id=BlockID(
            hash=prev_meta.block_id.hash,
            part_set_header=prev_meta.block_id.part_set_header),
        last_block_time=prev_meta.header.time,
        next_validators=next_validators,
        validators=validators,
        last_validators=last_validators,
        last_height_validators_changed=(
            invalid_state.last_height_validators_changed),
        consensus_params=params,
        last_height_consensus_params_changed=(
            invalid_state.last_height_consensus_params_changed),
        last_results_hash=rolled_back_block.header.last_results_hash,
        app_hash=rolled_back_block.header.app_hash,
    )
    state_store.save(new_state)
    if remove_block and height == rollback_height:
        block_store.delete_latest_block()
    return new_state.last_block_height, new_state.app_hash
