"""Message descriptors for the data-companion gRPC services.

Reference: proto/cometbft/services/{block,block_results,pruning,
version}/v1/*.proto — field numbers and wire kinds mirror those
schemas exactly.  A copy of cometbft_tpu/rpc/grpc/pb.py; it imports no
``grpc``, so the servicers (services.py) load without it.
"""
from ...wire.proto import F, Msg
from ...wire.pb import BLOCK, BLOCK_ID, CONSENSUS_PARAMS
from ...wire.abci_pb import EVENT, EXEC_TX_RESULT, VALIDATOR_UPDATE

# -- cometbft.services.version.v1 -------------------------------------------

GET_VERSION_REQUEST = Msg("cometbft.services.version.v1.GetVersionRequest")
GET_VERSION_RESPONSE = Msg(
    "cometbft.services.version.v1.GetVersionResponse",
    F(1, "node", "string"),
    F(2, "abci", "string"),
    F(3, "p2p", "uint64"),
    F(4, "block", "uint64"),
)

# -- cometbft.services.block.v1 ---------------------------------------------

GET_BY_HEIGHT_REQUEST = Msg(
    "cometbft.services.block.v1.GetByHeightRequest",
    F(1, "height", "int64"),
)
GET_BY_HEIGHT_RESPONSE = Msg(
    "cometbft.services.block.v1.GetByHeightResponse",
    F(1, "block_id", "msg", msg=BLOCK_ID),
    F(2, "block", "msg", msg=BLOCK),
)
GET_LATEST_HEIGHT_REQUEST = Msg(
    "cometbft.services.block.v1.GetLatestHeightRequest")
GET_LATEST_HEIGHT_RESPONSE = Msg(
    "cometbft.services.block.v1.GetLatestHeightResponse",
    F(1, "height", "int64"),
)

# -- cometbft.services.block_results.v1 -------------------------------------

GET_BLOCK_RESULTS_REQUEST = Msg(
    "cometbft.services.block_results.v1.GetBlockResultsRequest",
    F(1, "height", "int64"),
)
GET_BLOCK_RESULTS_RESPONSE = Msg(
    "cometbft.services.block_results.v1.GetBlockResultsResponse",
    F(1, "height", "int64"),
    F(2, "tx_results", "msg", msg=EXEC_TX_RESULT, repeated=True),
    F(3, "finalize_block_events", "msg", msg=EVENT, repeated=True),
    F(4, "validator_updates", "msg", msg=VALIDATOR_UPDATE,
      repeated=True),
    F(5, "consensus_param_updates", "msg", msg=CONSENSUS_PARAMS),
    F(6, "app_hash", "bytes"),
)

# -- cometbft.services.pruning.v1 -------------------------------------------


def _set_req(name: str) -> Msg:
    return Msg(f"cometbft.services.pruning.v1.{name}",
               F(1, "height", "uint64"))


def _empty(name: str) -> Msg:
    return Msg(f"cometbft.services.pruning.v1.{name}")


SET_BLOCK_RETAIN_HEIGHT_REQUEST = _set_req("SetBlockRetainHeightRequest")
SET_BLOCK_RETAIN_HEIGHT_RESPONSE = _empty("SetBlockRetainHeightResponse")
GET_BLOCK_RETAIN_HEIGHT_REQUEST = _empty("GetBlockRetainHeightRequest")
GET_BLOCK_RETAIN_HEIGHT_RESPONSE = Msg(
    "cometbft.services.pruning.v1.GetBlockRetainHeightResponse",
    F(1, "app_retain_height", "uint64"),
    F(2, "pruning_service_retain_height", "uint64"),
)
SET_BLOCK_RESULTS_RETAIN_HEIGHT_REQUEST = \
    _set_req("SetBlockResultsRetainHeightRequest")
SET_BLOCK_RESULTS_RETAIN_HEIGHT_RESPONSE = \
    _empty("SetBlockResultsRetainHeightResponse")
GET_BLOCK_RESULTS_RETAIN_HEIGHT_REQUEST = \
    _empty("GetBlockResultsRetainHeightRequest")
GET_BLOCK_RESULTS_RETAIN_HEIGHT_RESPONSE = Msg(
    "cometbft.services.pruning.v1.GetBlockResultsRetainHeightResponse",
    F(1, "pruning_service_retain_height", "uint64"),
)
SET_TX_INDEXER_RETAIN_HEIGHT_REQUEST = \
    _set_req("SetTxIndexerRetainHeightRequest")
SET_TX_INDEXER_RETAIN_HEIGHT_RESPONSE = \
    _empty("SetTxIndexerRetainHeightResponse")
GET_TX_INDEXER_RETAIN_HEIGHT_REQUEST = \
    _empty("GetTxIndexerRetainHeightRequest")
GET_TX_INDEXER_RETAIN_HEIGHT_RESPONSE = Msg(
    "cometbft.services.pruning.v1.GetTxIndexerRetainHeightResponse",
    F(1, "height", "uint64"),
)
SET_BLOCK_INDEXER_RETAIN_HEIGHT_REQUEST = \
    _set_req("SetBlockIndexerRetainHeightRequest")
SET_BLOCK_INDEXER_RETAIN_HEIGHT_RESPONSE = \
    _empty("SetBlockIndexerRetainHeightResponse")
GET_BLOCK_INDEXER_RETAIN_HEIGHT_REQUEST = \
    _empty("GetBlockIndexerRetainHeightRequest")
GET_BLOCK_INDEXER_RETAIN_HEIGHT_RESPONSE = Msg(
    "cometbft.services.pruning.v1.GetBlockIndexerRetainHeightResponse",
    F(1, "height", "uint64"),
)

# -- full gRPC method names --------------------------------------------------

VERSION_SERVICE = "cometbft.services.version.v1.VersionService"
BLOCK_SERVICE = "cometbft.services.block.v1.BlockService"
BLOCK_RESULTS_SERVICE = \
    "cometbft.services.block_results.v1.BlockResultsService"
PRUNING_SERVICE = "cometbft.services.pruning.v1.PruningService"
