"""Wire descriptors for cometbft.abci.v2: the messages the state store
keeps on disk, the results hash covers, and the socket protocol's
Request/Response envelope carries.

A copy of cometbft_tpu/wire/abci_pb.py (which mirrors the reference's
proto/cometbft/abci/v2/types.proto): the same names, field numbers and
kinds, so the frames are byte-equal.
"""
from .proto import F, Msg
from .pb import CONSENSUS_PARAMS, PROOF_OPS, TIMESTAMP, DURATION

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

TX_RESULT = Msg(
    "cometbft.abci.v2.TxResult",
    F(1, "height", "int64"),
    F(2, "index", "uint32"),
    F(3, "tx", "bytes"),
    F(4, "result", "msg", msg=EXEC_TX_RESULT, always=True),
)

ABCI_VALIDATOR = Msg(
    "cometbft.abci.v2.Validator",
    F(1, "address", "bytes"),
    F(3, "power", "int64"),
)

VALIDATOR_UPDATE = Msg(
    "cometbft.abci.v2.ValidatorUpdate",
    F(2, "power", "int64"),
    F(3, "pub_key_bytes", "bytes"),
    F(4, "pub_key_type", "string"),
)

VOTE_INFO = Msg(
    "cometbft.abci.v2.VoteInfo",
    F(1, "validator", "msg", msg=ABCI_VALIDATOR, always=True),
    F(3, "block_id_flag", "enum"),
)

EXTENDED_VOTE_INFO = Msg(
    "cometbft.abci.v2.ExtendedVoteInfo",
    F(1, "validator", "msg", msg=ABCI_VALIDATOR, always=True),
    F(3, "vote_extension", "bytes"),
    F(4, "extension_signature", "bytes"),
    F(5, "block_id_flag", "enum"),
    F(6, "non_rp_vote_extension", "bytes"),
    F(7, "non_rp_extension_signature", "bytes"),
)

COMMIT_INFO = Msg(
    "cometbft.abci.v2.CommitInfo",
    F(1, "round", "int32"),
    F(2, "votes", "msg", msg=VOTE_INFO, repeated=True),
)

EXTENDED_COMMIT_INFO = Msg(
    "cometbft.abci.v2.ExtendedCommitInfo",
    F(1, "round", "int32"),
    F(2, "votes", "msg", msg=EXTENDED_VOTE_INFO, repeated=True),
)

MISBEHAVIOR = Msg(
    "cometbft.abci.v2.Misbehavior",
    F(1, "type", "enum"),
    F(2, "validator", "msg", msg=ABCI_VALIDATOR, always=True),
    F(3, "height", "int64"),
    F(4, "time", "msg", msg=TIMESTAMP, always=True),
    F(5, "total_voting_power", "int64"),
)

SNAPSHOT = Msg(
    "cometbft.abci.v2.Snapshot",
    F(1, "height", "uint64"),
    F(2, "format", "uint32"),
    F(3, "chunks", "uint32"),
    F(4, "hash", "bytes"),
    F(5, "metadata", "bytes"),
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


# ---------------------------------------------------------------------------
# Socket-protocol envelope: Request/Response oneofs and every method message.
# Reference: proto/cometbft/abci/v2/types.proto (Request :18-36,
# Response :222-244) and abci/client/socket_client.go's length-delimited
# framing.

ECHO_REQUEST = Msg("cometbft.abci.v2.EchoRequest", F(1, "message", "string"))
FLUSH_REQUEST = Msg("cometbft.abci.v2.FlushRequest")
INFO_REQUEST = Msg(
    "cometbft.abci.v2.InfoRequest",
    F(1, "version", "string"),
    F(2, "block_version", "uint64"),
    F(3, "p2p_version", "uint64"),
    F(4, "abci_version", "string"),
)
INIT_CHAIN_REQUEST = Msg(
    "cometbft.abci.v2.InitChainRequest",
    F(1, "time", "msg", msg=TIMESTAMP, always=True),
    F(2, "chain_id", "string"),
    F(3, "consensus_params", "msg", msg=CONSENSUS_PARAMS),
    F(4, "validators", "msg", msg=VALIDATOR_UPDATE, repeated=True),
    F(5, "app_state_bytes", "bytes"),
    F(6, "initial_height", "int64"),
)
QUERY_REQUEST = Msg(
    "cometbft.abci.v2.QueryRequest",
    F(1, "data", "bytes"),
    F(2, "path", "string"),
    F(3, "height", "int64"),
    F(4, "prove", "bool"),
)
CHECK_TX_REQUEST = Msg(
    "cometbft.abci.v2.CheckTxRequest",
    F(1, "tx", "bytes"),
    F(3, "type", "enum"),
)
COMMIT_REQUEST = Msg("cometbft.abci.v2.CommitRequest")
LIST_SNAPSHOTS_REQUEST = Msg("cometbft.abci.v2.ListSnapshotsRequest")
OFFER_SNAPSHOT_REQUEST = Msg(
    "cometbft.abci.v2.OfferSnapshotRequest",
    F(1, "snapshot", "msg", msg=SNAPSHOT),
    F(2, "app_hash", "bytes"),
)
LOAD_SNAPSHOT_CHUNK_REQUEST = Msg(
    "cometbft.abci.v2.LoadSnapshotChunkRequest",
    F(1, "height", "uint64"),
    F(2, "format", "uint32"),
    F(3, "chunk", "uint32"),
)
APPLY_SNAPSHOT_CHUNK_REQUEST = Msg(
    "cometbft.abci.v2.ApplySnapshotChunkRequest",
    F(1, "index", "uint32"),
    F(2, "chunk", "bytes"),
    F(3, "sender", "string"),
)
PREPARE_PROPOSAL_REQUEST = Msg(
    "cometbft.abci.v2.PrepareProposalRequest",
    F(1, "max_tx_bytes", "int64"),
    F(2, "txs", "bytes", repeated=True),
    F(3, "local_last_commit", "msg", msg=EXTENDED_COMMIT_INFO, always=True),
    F(4, "misbehavior", "msg", msg=MISBEHAVIOR, repeated=True),
    F(5, "height", "int64"),
    F(6, "time", "msg", msg=TIMESTAMP, always=True),
    F(7, "next_validators_hash", "bytes"),
    F(8, "proposer_address", "bytes"),
)
PROCESS_PROPOSAL_REQUEST = Msg(
    "cometbft.abci.v2.ProcessProposalRequest",
    F(1, "txs", "bytes", repeated=True),
    F(2, "proposed_last_commit", "msg", msg=COMMIT_INFO, always=True),
    F(3, "misbehavior", "msg", msg=MISBEHAVIOR, repeated=True),
    F(4, "hash", "bytes"),
    F(5, "height", "int64"),
    F(6, "time", "msg", msg=TIMESTAMP, always=True),
    F(7, "next_validators_hash", "bytes"),
    F(8, "proposer_address", "bytes"),
)
EXTEND_VOTE_REQUEST = Msg(
    "cometbft.abci.v2.ExtendVoteRequest",
    F(1, "hash", "bytes"),
    F(2, "height", "int64"),
    F(3, "time", "msg", msg=TIMESTAMP, always=True),
    F(4, "txs", "bytes", repeated=True),
    F(5, "proposed_last_commit", "msg", msg=COMMIT_INFO, always=True),
    F(6, "misbehavior", "msg", msg=MISBEHAVIOR, repeated=True),
    F(7, "next_validators_hash", "bytes"),
    F(8, "proposer_address", "bytes"),
)
VERIFY_VOTE_EXTENSION_REQUEST = Msg(
    "cometbft.abci.v2.VerifyVoteExtensionRequest",
    F(1, "hash", "bytes"),
    F(2, "validator_address", "bytes"),
    F(3, "height", "int64"),
    F(4, "vote_extension", "bytes"),
    F(5, "non_rp_vote_extension", "bytes"),
)
FINALIZE_BLOCK_REQUEST = Msg(
    "cometbft.abci.v2.FinalizeBlockRequest",
    F(1, "txs", "bytes", repeated=True),
    F(2, "decided_last_commit", "msg", msg=COMMIT_INFO, always=True),
    F(3, "misbehavior", "msg", msg=MISBEHAVIOR, repeated=True),
    F(4, "hash", "bytes"),
    F(5, "height", "int64"),
    F(6, "time", "msg", msg=TIMESTAMP, always=True),
    F(7, "next_validators_hash", "bytes"),
    F(8, "proposer_address", "bytes"),
    F(9, "syncing_to_height", "int64"),
)

REQUEST = Msg(
    "cometbft.abci.v2.Request",
    F(1, "echo", "msg", msg=ECHO_REQUEST),
    F(2, "flush", "msg", msg=FLUSH_REQUEST),
    F(3, "info", "msg", msg=INFO_REQUEST),
    F(5, "init_chain", "msg", msg=INIT_CHAIN_REQUEST),
    F(6, "query", "msg", msg=QUERY_REQUEST),
    F(8, "check_tx", "msg", msg=CHECK_TX_REQUEST),
    F(11, "commit", "msg", msg=COMMIT_REQUEST),
    F(12, "list_snapshots", "msg", msg=LIST_SNAPSHOTS_REQUEST),
    F(13, "offer_snapshot", "msg", msg=OFFER_SNAPSHOT_REQUEST),
    F(14, "load_snapshot_chunk", "msg", msg=LOAD_SNAPSHOT_CHUNK_REQUEST),
    F(15, "apply_snapshot_chunk", "msg", msg=APPLY_SNAPSHOT_CHUNK_REQUEST),
    F(16, "prepare_proposal", "msg", msg=PREPARE_PROPOSAL_REQUEST),
    F(17, "process_proposal", "msg", msg=PROCESS_PROPOSAL_REQUEST),
    F(18, "extend_vote", "msg", msg=EXTEND_VOTE_REQUEST),
    F(19, "verify_vote_extension", "msg", msg=VERIFY_VOTE_EXTENSION_REQUEST),
    F(20, "finalize_block", "msg", msg=FINALIZE_BLOCK_REQUEST),
)

EXCEPTION_RESPONSE = Msg(
    "cometbft.abci.v2.ExceptionResponse", F(1, "error", "string"))
ECHO_RESPONSE = Msg("cometbft.abci.v2.EchoResponse",
                    F(1, "message", "string"))
FLUSH_RESPONSE = Msg("cometbft.abci.v2.FlushResponse")
LANE_PRIORITY_ENTRY = Msg(
    "cometbft.abci.v2.InfoResponse.LanePrioritiesEntry",
    F(1, "key", "string"),
    F(2, "value", "uint32"),
)
INFO_RESPONSE = Msg(
    "cometbft.abci.v2.InfoResponse",
    F(1, "data", "string"),
    F(2, "version", "string"),
    F(3, "app_version", "uint64"),
    F(4, "last_block_height", "int64"),
    F(5, "last_block_app_hash", "bytes"),
    F(6, "lane_priorities", "msg", msg=LANE_PRIORITY_ENTRY, repeated=True),
    F(7, "default_lane", "string"),
)
INIT_CHAIN_RESPONSE = Msg(
    "cometbft.abci.v2.InitChainResponse",
    F(1, "consensus_params", "msg", msg=CONSENSUS_PARAMS),
    F(2, "validators", "msg", msg=VALIDATOR_UPDATE, repeated=True),
    F(3, "app_hash", "bytes"),
)
QUERY_RESPONSE = Msg(
    "cometbft.abci.v2.QueryResponse",
    F(1, "code", "uint32"),
    F(3, "log", "string"),
    F(4, "info", "string"),
    F(5, "index", "int64"),
    F(6, "key", "bytes"),
    F(7, "value", "bytes"),
    F(8, "proof_ops", "msg", msg=PROOF_OPS),
    F(9, "height", "int64"),
    F(10, "codespace", "string"),
)
CHECK_TX_RESPONSE = Msg(
    "cometbft.abci.v2.CheckTxResponse",
    F(1, "code", "uint32"),
    F(2, "data", "bytes"),
    F(3, "log", "string"),
    F(4, "info", "string"),
    F(5, "gas_wanted", "int64"),
    F(6, "gas_used", "int64"),
    F(7, "events", "msg", msg=EVENT, repeated=True),
    F(8, "codespace", "string"),
    F(12, "lane_id", "string"),
    # local extension: state keys the tx's validity depends on
    # (incremental mempool recheck)
    F(100, "recheck_keys", "bytes", repeated=True),
)
COMMIT_RESPONSE = Msg(
    "cometbft.abci.v2.CommitResponse",
    F(3, "retain_height", "int64"),
)
LIST_SNAPSHOTS_RESPONSE = Msg(
    "cometbft.abci.v2.ListSnapshotsResponse",
    F(1, "snapshots", "msg", msg=SNAPSHOT, repeated=True),
)
OFFER_SNAPSHOT_RESPONSE = Msg(
    "cometbft.abci.v2.OfferSnapshotResponse", F(1, "result", "enum"))
LOAD_SNAPSHOT_CHUNK_RESPONSE = Msg(
    "cometbft.abci.v2.LoadSnapshotChunkResponse", F(1, "chunk", "bytes"))
APPLY_SNAPSHOT_CHUNK_RESPONSE = Msg(
    "cometbft.abci.v2.ApplySnapshotChunkResponse",
    F(1, "result", "enum"),
    F(2, "refetch_chunks", "uint32", repeated=True),
    F(3, "reject_senders", "string", repeated=True),
)
PREPARE_PROPOSAL_RESPONSE = Msg(
    "cometbft.abci.v2.PrepareProposalResponse",
    F(1, "txs", "bytes", repeated=True),
)
PROCESS_PROPOSAL_RESPONSE = Msg(
    "cometbft.abci.v2.ProcessProposalResponse", F(1, "status", "enum"))
EXTEND_VOTE_RESPONSE = Msg(
    "cometbft.abci.v2.ExtendVoteResponse",
    F(1, "vote_extension", "bytes"),
    F(2, "non_rp_extension", "bytes"),
)
VERIFY_VOTE_EXTENSION_RESPONSE = Msg(
    "cometbft.abci.v2.VerifyVoteExtensionResponse", F(1, "status", "enum"))

RESPONSE = Msg(
    "cometbft.abci.v2.Response",
    F(1, "exception", "msg", msg=EXCEPTION_RESPONSE),
    F(2, "echo", "msg", msg=ECHO_RESPONSE),
    F(3, "flush", "msg", msg=FLUSH_RESPONSE),
    F(4, "info", "msg", msg=INFO_RESPONSE),
    F(6, "init_chain", "msg", msg=INIT_CHAIN_RESPONSE),
    F(7, "query", "msg", msg=QUERY_RESPONSE),
    F(9, "check_tx", "msg", msg=CHECK_TX_RESPONSE),
    F(12, "commit", "msg", msg=COMMIT_RESPONSE),
    F(13, "list_snapshots", "msg", msg=LIST_SNAPSHOTS_RESPONSE),
    F(14, "offer_snapshot", "msg", msg=OFFER_SNAPSHOT_RESPONSE),
    F(15, "load_snapshot_chunk", "msg", msg=LOAD_SNAPSHOT_CHUNK_RESPONSE),
    F(16, "apply_snapshot_chunk", "msg", msg=APPLY_SNAPSHOT_CHUNK_RESPONSE),
    F(17, "prepare_proposal", "msg", msg=PREPARE_PROPOSAL_RESPONSE),
    F(18, "process_proposal", "msg", msg=PROCESS_PROPOSAL_RESPONSE),
    F(19, "extend_vote", "msg", msg=EXTEND_VOTE_RESPONSE),
    F(20, "verify_vote_extension", "msg", msg=VERIFY_VOTE_EXTENSION_RESPONSE),
    F(21, "finalize_block", "msg", msg=FINALIZE_BLOCK_RESPONSE),
)
