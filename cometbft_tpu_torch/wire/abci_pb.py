"""Wire descriptors of the ABCI messages the state store keeps on disk
and the results hash covers.

The port's trimmed copy of cometbft_tpu/wire/abci_pb.py (which mirrors
the reference's proto/cometbft/abci/v2/types.proto): ``ExecTxResult``
(the leaves of LastResultsHash) and ``FinalizeBlockResponse`` with what
it nests.  The socket protocol's Request/Response envelope waits for the
socket client (ROADMAP A.7e).
"""
from .proto import F, Msg
from .pb import CONSENSUS_PARAMS, DURATION

EVENT_ATTRIBUTE = Msg(
    "cometbft.abci.v2.EventAttribute",
    F(1, "key", "string"),
    F(2, "value", "string"),
    F(3, "index", "bool"),
)

EVENT = Msg(
    "cometbft.abci.v2.Event",
    F(1, "type", "string"),
    F(2, "attributes", "msg", msg=EVENT_ATTRIBUTE, repeated=True),
)

EXEC_TX_RESULT = Msg(
    "cometbft.abci.v2.ExecTxResult",
    F(1, "code", "uint32"),
    F(2, "data", "bytes"),
    F(3, "log", "string"),
    F(4, "info", "string"),
    F(5, "gas_wanted", "int64"),
    F(6, "gas_used", "int64"),
    F(7, "events", "msg", msg=EVENT, repeated=True),
    F(8, "codespace", "string"),
    # the reference package's local extension (high tag, clear of
    # upstream fields): app-reported state keys for the mempool's
    # incremental recheck; outside the results hash like log and events
    F(100, "recheck_keys", "bytes", repeated=True),
)

VALIDATOR_UPDATE = Msg(
    "cometbft.abci.v2.ValidatorUpdate",
    F(2, "power", "int64"),
    F(3, "pub_key_bytes", "bytes"),
    F(4, "pub_key_type", "string"),
)

FINALIZE_BLOCK_RESPONSE = Msg(
    "cometbft.abci.v2.FinalizeBlockResponse",
    F(1, "events", "msg", msg=EVENT, repeated=True),
    F(2, "tx_results", "msg", msg=EXEC_TX_RESULT, repeated=True),
    F(3, "validator_updates", "msg", msg=VALIDATOR_UPDATE, repeated=True),
    F(4, "consensus_param_updates", "msg", msg=CONSENSUS_PARAMS),
    F(5, "app_hash", "bytes"),
    F(6, "next_block_delay", "msg", msg=DURATION, always=True),
)
