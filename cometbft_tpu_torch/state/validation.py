"""Block validation against state.

Reference: state/validation.go — validateBlock: header wiring checks,
LastCommit verification through state.LastValidators.VerifyCommit,
block time and evidence size checks — through
cometbft_tpu/state/validation.py, whose error texts this copy keeps.

Every block's LastCommit goes through ``types/validation.verify_commit``
on ``device``: on the card (``device=None``) one B1 batch a height.
Only a ``VerificationError`` becomes a ``BlockValidationError``; a
kernel that fails to build or launch raises out of ``validate_block`` as
itself.
"""
from __future__ import annotations

from ..types import validation as types_validation
from ..types.block import Block
from ..types.commit import AggregateCommit
from ..wire import encode, pb
from .state import State


class BlockValidationError(Exception):
    pass


def validate_block(state: State, block: Block, device=None) -> None:
    """Reference: state/validation.go validateBlock.  ``device`` is where
    the LastCommit's signatures are verified (None: the card)."""
    try:
        block.validate_basic()
    except Exception as e:  # BlockError and friends -> one error type,
        # so every caller's "invalid block" handling sees it
        raise BlockValidationError(f"invalid block: {e}") from e

    h = block.header
    # header wiring to state
    if h.version.block != state.version.consensus.block or \
            h.version.app != state.version.consensus.app:
        raise BlockValidationError(
            f"wrong Block.Header.Version: {h.version}")
    if h.chain_id != state.chain_id:
        raise BlockValidationError(
            f"wrong Block.Header.ChainID: {h.chain_id!r}")
    if state.last_block_height == 0:
        if h.height != state.initial_height:
            raise BlockValidationError(
                f"wrong Block.Header.Height: want "
                f"{state.initial_height} (initial), got {h.height}")
    elif h.height != state.last_block_height + 1:
        raise BlockValidationError(
            f"wrong Block.Header.Height: want "
            f"{state.last_block_height + 1}, got {h.height}")
    if h.last_block_id != state.last_block_id:
        raise BlockValidationError(
            f"wrong Block.Header.LastBlockID: want "
            f"{state.last_block_id}, got {h.last_block_id}")

    if h.app_hash != state.app_hash:
        raise BlockValidationError(
            f"wrong Block.Header.AppHash: want "
            f"{state.app_hash.hex().upper()}, got "
            f"{h.app_hash.hex().upper()}")
    if h.consensus_hash != state.consensus_params.hash():
        raise BlockValidationError("wrong Block.Header.ConsensusHash")
    if h.last_results_hash != state.last_results_hash:
        raise BlockValidationError("wrong Block.Header.LastResultsHash")
    if h.validators_hash != state.validators.hash():
        raise BlockValidationError("wrong Block.Header.ValidatorsHash")
    if h.next_validators_hash != state.next_validators.hash():
        raise BlockValidationError(
            "wrong Block.Header.NextValidatorsHash")

    # LastCommit verification — the batch-verify hot path (B1)
    if state.last_block_height == 0:
        if block.last_commit is not None and \
                block.last_commit.size() != 0:
            raise BlockValidationError(
                "initial block can't have LastCommit signatures")
    else:
        if block.last_commit is None:
            raise BlockValidationError("nil LastCommit")
        # commit-form discipline: past the aggregate enable height the
        # chain's blocks must carry the aggregate form (and never
        # before it), so the commit encoding is deterministic per
        # height — a proposer cannot downgrade to per-signature
        # commits and reintroduce O(n) verification
        expect_agg = state.consensus_params.feature \
            .aggregate_commits_enabled(h.height - 1)
        is_agg = isinstance(block.last_commit, AggregateCommit)
        if expect_agg and not is_agg:
            raise BlockValidationError(
                "per-signature LastCommit on an aggregate-commit "
                "chain")
        if is_agg and not expect_agg:
            raise BlockValidationError(
                "aggregate LastCommit before the enable height")
        if block.last_commit.size() != state.last_validators.size():
            raise BlockValidationError(
                f"invalid block commit size: want "
                f"{state.last_validators.size()}, got "
                f"{block.last_commit.size()}")
        try:
            types_validation.verify_commit(
                state.chain_id, state.last_validators,
                state.last_block_id, h.height - 1, block.last_commit,
                device=device)
        except types_validation.VerificationError as e:
            raise BlockValidationError(
                f"invalid LastCommit: {e}") from e

    # block time rules (reference: validation.go — BFT time requires the
    # exact weighted median of LastCommit; PBTS requires monotonicity,
    # with timeliness checked at prevote time)
    validate_block_time(
        state, block,
        state.consensus_params.feature.pbts_enabled(h.height))

    # evidence size cap (reference: validation.go:137 ErrEvidenceOverflow)
    max_ev_bytes = state.consensus_params.evidence.max_bytes
    ev_bytes = _evidence_byte_size(block.evidence)
    if ev_bytes > max_ev_bytes:
        raise BlockValidationError(
            f"evidence overflow: max {max_ev_bytes} bytes, "
            f"got {ev_bytes} bytes")

    # proposer must be in the current validator set
    if not state.validators.has_address(h.proposer_address):
        raise BlockValidationError(
            f"block proposer {h.proposer_address.hex().upper()} is not "
            f"a validator")


def _evidence_byte_size(evidence: list) -> int:
    """Proto-encoded EvidenceList size (reference: types/evidence.go
    EvidenceList ByteSize via EvidenceData)."""
    if not evidence:
        return 0
    return len(encode(pb.EVIDENCE_LIST, {
        "evidence": [ev.to_proto_wrapped() for ev in evidence]}))


def validate_block_time(state: State, block: Block,
                        pbts_enabled: bool) -> None:
    """BFT-time / PBTS monotonicity checks (reference:
    validation.go time checks)."""
    h = block.header
    if h.height == state.initial_height:
        genesis_time = state.last_block_time
        if pbts_enabled:
            if h.time.unix_ns() < genesis_time.unix_ns():
                raise BlockValidationError(
                    "block time before genesis time")
        elif h.time != genesis_time:
            raise BlockValidationError(
                f"block time {h.time} != genesis time {genesis_time}")
    else:
        if not pbts_enabled:
            # BFT time: must equal MedianTime of LastCommit
            med = block.last_commit.median_time(state.last_validators)
            if h.time != med:
                raise BlockValidationError(
                    f"invalid block time: want {med}, got {h.time}")
        elif h.time.unix_ns() <= state.last_block_time.unix_ns():
            raise BlockValidationError("block time not monotonic")
