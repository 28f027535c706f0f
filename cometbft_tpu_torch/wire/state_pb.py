"""Wire descriptors of cometbft.state.v2, the state store's records.

The port's copy of cometbft_tpu/wire/state_pb.py (reference:
proto/cometbft/state/v2/types.proto).  ``State`` is what
``State.bytes()`` encodes, so its field numbers and nullability decide
the bytes the state store writes at every height.
"""
from .proto import F, Msg
from .pb import (
    BLOCK_ID, CONSENSUS_PARAMS, CONSENSUS_VERSION, DURATION, TIMESTAMP,
    VALIDATOR_SET,
)
from .abci_pb import FINALIZE_BLOCK_RESPONSE

STATE_VERSION = Msg(
    "cometbft.state.v2.Version",
    F(1, "consensus", "msg", msg=CONSENSUS_VERSION, always=True),
    F(2, "software", "string"),
)

STATE = Msg(
    "cometbft.state.v2.State",
    F(1, "version", "msg", msg=STATE_VERSION, always=True),
    F(2, "chain_id", "string"),
    F(3, "last_block_height", "int64"),
    F(4, "last_block_id", "msg", msg=BLOCK_ID, always=True),
    F(5, "last_block_time", "msg", msg=TIMESTAMP, always=True),
    F(6, "next_validators", "msg", msg=VALIDATOR_SET),
    F(7, "validators", "msg", msg=VALIDATOR_SET),
    F(8, "last_validators", "msg", msg=VALIDATOR_SET),
    F(9, "last_height_validators_changed", "int64"),
    F(10, "consensus_params", "msg", msg=CONSENSUS_PARAMS, always=True),
    F(11, "last_height_consensus_params_changed", "int64"),
    F(12, "last_results_hash", "bytes"),
    F(13, "app_hash", "bytes"),
    F(14, "initial_height", "int64"),
    F(15, "next_block_delay", "msg", msg=DURATION, always=True),
)

VALIDATORS_INFO = Msg(
    "cometbft.state.v2.ValidatorsInfo",
    F(1, "validator_set", "msg", msg=VALIDATOR_SET),
    F(2, "last_height_changed", "int64"),
)

CONSENSUS_PARAMS_INFO = Msg(
    "cometbft.state.v2.ConsensusParamsInfo",
    F(1, "consensus_params", "msg", msg=CONSENSUS_PARAMS, always=True),
    F(2, "last_height_changed", "int64"),
)

ABCI_RESPONSES_INFO = Msg(
    "cometbft.state.v2.ABCIResponsesInfo",
    F(2, "height", "int64"),
    F(3, "finalize_block", "msg", msg=FINALIZE_BLOCK_RESPONSE),
)
