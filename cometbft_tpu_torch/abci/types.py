"""ABCI request/response types and the Application interface.

Reference: abci/types/application.go:11-41 (the 15-method interface) and
proto/cometbft/abci/v2/types.proto (message shapes), through
cometbft_tpu/abci/types.py.  Python-native dataclasses; the socket
protocol's wire conversion waits for the socket client (ROADMAP A.7e).
"""
from __future__ import annotations

import abc
from dataclasses import dataclass, field
from typing import Optional

from ..types.timestamp import Timestamp

CODE_TYPE_OK = 0

# CheckTxType
CHECK_TX_TYPE_UNKNOWN = 0
CHECK_TX_TYPE_RECHECK = 1
CHECK_TX_TYPE_CHECK = 2

# ProcessProposalStatus
PROCESS_PROPOSAL_STATUS_UNKNOWN = 0
PROCESS_PROPOSAL_STATUS_ACCEPT = 1
PROCESS_PROPOSAL_STATUS_REJECT = 2

# VerifyVoteExtensionStatus
VERIFY_VOTE_EXTENSION_STATUS_UNKNOWN = 0
VERIFY_VOTE_EXTENSION_STATUS_ACCEPT = 1
VERIFY_VOTE_EXTENSION_STATUS_REJECT = 2

# OfferSnapshotResult
OFFER_SNAPSHOT_RESULT_UNKNOWN = 0
OFFER_SNAPSHOT_RESULT_ACCEPT = 1
OFFER_SNAPSHOT_RESULT_ABORT = 2
OFFER_SNAPSHOT_RESULT_REJECT = 3
OFFER_SNAPSHOT_RESULT_REJECT_FORMAT = 4
OFFER_SNAPSHOT_RESULT_REJECT_SENDER = 5

# ApplySnapshotChunkResult
APPLY_SNAPSHOT_CHUNK_RESULT_UNKNOWN = 0
APPLY_SNAPSHOT_CHUNK_RESULT_ACCEPT = 1
APPLY_SNAPSHOT_CHUNK_RESULT_ABORT = 2
APPLY_SNAPSHOT_CHUNK_RESULT_RETRY = 3
APPLY_SNAPSHOT_CHUNK_RESULT_RETRY_SNAPSHOT = 4
APPLY_SNAPSHOT_CHUNK_RESULT_REJECT_SNAPSHOT = 5

# MisbehaviorType
MISBEHAVIOR_TYPE_UNKNOWN = 0
MISBEHAVIOR_TYPE_DUPLICATE_VOTE = 1
MISBEHAVIOR_TYPE_LIGHT_CLIENT_ATTACK = 2


@dataclass
class EventAttribute:
    key: str = ""
    value: str = ""
    index: bool = False


@dataclass
class Event:
    type: str = ""
    attributes: list[EventAttribute] = field(default_factory=list)


@dataclass
class ABCIValidator:
    """abci.Validator: 20-byte address + power."""
    address: bytes = b""
    power: int = 0


@dataclass
class ValidatorUpdate:
    power: int = 0
    pub_key_bytes: bytes = b""
    pub_key_type: str = ""


@dataclass
class VoteInfo:
    validator: ABCIValidator = field(default_factory=ABCIValidator)
    block_id_flag: int = 0


@dataclass
class ExtendedVoteInfo:
    validator: ABCIValidator = field(default_factory=ABCIValidator)
    vote_extension: bytes = b""
    extension_signature: bytes = b""
    block_id_flag: int = 0
    non_rp_vote_extension: bytes = b""
    non_rp_extension_signature: bytes = b""


@dataclass
class CommitInfo:
    round: int = 0
    votes: list[VoteInfo] = field(default_factory=list)


@dataclass
class ExtendedCommitInfo:
    round: int = 0
    votes: list[ExtendedVoteInfo] = field(default_factory=list)


@dataclass
class Misbehavior:
    type: int = MISBEHAVIOR_TYPE_UNKNOWN
    validator: ABCIValidator = field(default_factory=ABCIValidator)
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    total_voting_power: int = 0


@dataclass
class Snapshot:
    height: int = 0
    format: int = 0
    chunks: int = 0
    hash: bytes = b""
    metadata: bytes = b""


@dataclass
class ExecTxResult:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""
    # state keys this tx read/wrote, reported by the app for the
    # mempool's incremental recheck.  Not part of the results hash
    # (like log/info/events, it is local metadata).
    recheck_keys: list[bytes] = field(default_factory=list)

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class TxResult:
    height: int = 0
    index: int = 0
    tx: bytes = b""
    result: ExecTxResult = field(default_factory=ExecTxResult)


# ---------------------------------------------------------------------------
# Requests


@dataclass
class EchoRequest:
    message: str = ""


@dataclass
class FlushRequest:
    pass


@dataclass
class InfoRequest:
    version: str = ""
    block_version: int = 0
    p2p_version: int = 0
    abci_version: str = ""


@dataclass
class InitChainRequest:
    time: Timestamp = field(default_factory=Timestamp.zero)
    chain_id: str = ""
    consensus_params: Optional[object] = None   # types.ConsensusParams
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_state_bytes: bytes = b""
    initial_height: int = 0


@dataclass
class QueryRequest:
    data: bytes = b""
    path: str = ""
    height: int = 0
    prove: bool = False


@dataclass
class CheckTxRequest:
    tx: bytes = b""
    type: int = CHECK_TX_TYPE_CHECK


@dataclass
class CommitRequest:
    pass


@dataclass
class ListSnapshotsRequest:
    pass


@dataclass
class OfferSnapshotRequest:
    snapshot: Optional[Snapshot] = None
    app_hash: bytes = b""


@dataclass
class LoadSnapshotChunkRequest:
    height: int = 0
    format: int = 0
    chunk: int = 0


@dataclass
class ApplySnapshotChunkRequest:
    index: int = 0
    chunk: bytes = b""
    sender: str = ""


@dataclass
class PrepareProposalRequest:
    max_tx_bytes: int = 0
    txs: list[bytes] = field(default_factory=list)
    local_last_commit: ExtendedCommitInfo = field(
        default_factory=ExtendedCommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ProcessProposalRequest:
    txs: list[bytes] = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class ExtendVoteRequest:
    hash: bytes = b""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    txs: list[bytes] = field(default_factory=list)
    proposed_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""


@dataclass
class VerifyVoteExtensionRequest:
    hash: bytes = b""
    validator_address: bytes = b""
    height: int = 0
    vote_extension: bytes = b""
    non_rp_vote_extension: bytes = b""


@dataclass
class FinalizeBlockRequest:
    txs: list[bytes] = field(default_factory=list)
    decided_last_commit: CommitInfo = field(default_factory=CommitInfo)
    misbehavior: list[Misbehavior] = field(default_factory=list)
    hash: bytes = b""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    next_validators_hash: bytes = b""
    proposer_address: bytes = b""
    syncing_to_height: int = 0


# ---------------------------------------------------------------------------
# Responses


@dataclass
class ExceptionResponse:
    error: str = ""


@dataclass
class EchoResponse:
    message: str = ""


@dataclass
class FlushResponse:
    pass


@dataclass
class InfoResponse:
    data: str = ""
    version: str = ""
    app_version: int = 0
    last_block_height: int = 0
    last_block_app_hash: bytes = b""
    lane_priorities: dict[str, int] = field(default_factory=dict)
    default_lane: str = ""


@dataclass
class InitChainResponse:
    consensus_params: Optional[object] = None   # types.ConsensusParams
    validators: list[ValidatorUpdate] = field(default_factory=list)
    app_hash: bytes = b""


@dataclass
class QueryResponse:
    code: int = CODE_TYPE_OK
    log: str = ""
    info: str = ""
    index: int = 0
    key: bytes = b""
    value: bytes = b""
    proof_ops: Optional[object] = None
    height: int = 0
    codespace: str = ""

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class CheckTxResponse:
    code: int = CODE_TYPE_OK
    data: bytes = b""
    log: str = ""
    info: str = ""
    gas_wanted: int = 0
    gas_used: int = 0
    events: list[Event] = field(default_factory=list)
    codespace: str = ""
    lane_id: str = ""
    # state keys the tx's validity depends on, for incremental
    # recheck: after a commit the mempool re-runs CheckTx only for
    # pooled txs whose keys overlap the committed block's
    # ExecTxResult.recheck_keys (plus the bounded-age watermark).
    # Empty = unattributed; such a tx is revalidated on the watermark
    # schedule only.
    recheck_keys: list[bytes] = field(default_factory=list)

    def is_ok(self) -> bool:
        return self.code == CODE_TYPE_OK


@dataclass
class CommitResponse:
    retain_height: int = 0


@dataclass
class ListSnapshotsResponse:
    snapshots: list[Snapshot] = field(default_factory=list)


@dataclass
class OfferSnapshotResponse:
    result: int = OFFER_SNAPSHOT_RESULT_UNKNOWN


@dataclass
class LoadSnapshotChunkResponse:
    chunk: bytes = b""


@dataclass
class ApplySnapshotChunkResponse:
    result: int = APPLY_SNAPSHOT_CHUNK_RESULT_UNKNOWN
    refetch_chunks: list[int] = field(default_factory=list)
    reject_senders: list[str] = field(default_factory=list)


@dataclass
class PrepareProposalResponse:
    txs: list[bytes] = field(default_factory=list)


@dataclass
class ProcessProposalResponse:
    status: int = PROCESS_PROPOSAL_STATUS_UNKNOWN

    def is_accepted(self) -> bool:
        return self.status == PROCESS_PROPOSAL_STATUS_ACCEPT


@dataclass
class ExtendVoteResponse:
    vote_extension: bytes = b""
    non_rp_extension: bytes = b""


@dataclass
class VerifyVoteExtensionResponse:
    status: int = VERIFY_VOTE_EXTENSION_STATUS_UNKNOWN

    def is_accepted(self) -> bool:
        return self.status == VERIFY_VOTE_EXTENSION_STATUS_ACCEPT


@dataclass
class FinalizeBlockResponse:
    events: list[Event] = field(default_factory=list)
    tx_results: list[ExecTxResult] = field(default_factory=list)
    validator_updates: list[ValidatorUpdate] = field(default_factory=list)
    consensus_param_updates: Optional[object] = None
    app_hash: bytes = b""
    next_block_delay_ns: int = 0


# ---------------------------------------------------------------------------


class Application(abc.ABC):
    """The 15-method deterministic state machine interface.

    Reference: abci/types/application.go:11-41.  Async so that socket/
    remote clients and in-process apps share one calling convention.
    """

    # Info/Query connection
    async def info(self, req: InfoRequest) -> InfoResponse:
        return InfoResponse()

    async def query(self, req: QueryRequest) -> QueryResponse:
        return QueryResponse(code=CODE_TYPE_OK)

    async def echo(self, req: EchoRequest) -> EchoResponse:
        return EchoResponse(message=req.message)

    # Mempool connection
    async def check_tx(self, req: CheckTxRequest) -> CheckTxResponse:
        return CheckTxResponse(code=CODE_TYPE_OK)

    # Consensus connection
    async def init_chain(self, req: InitChainRequest) -> InitChainResponse:
        return InitChainResponse()

    async def prepare_proposal(self, req: PrepareProposalRequest
                               ) -> PrepareProposalResponse:
        """Default: include txs up to max_tx_bytes (reference:
        BaseApplication.PrepareProposal)."""
        txs, total = [], 0
        for tx in req.txs:
            total += len(tx)
            if req.max_tx_bytes >= 0 and total > req.max_tx_bytes:
                break
            txs.append(tx)
        return PrepareProposalResponse(txs=txs)

    async def process_proposal(self, req: ProcessProposalRequest
                               ) -> ProcessProposalResponse:
        return ProcessProposalResponse(
            status=PROCESS_PROPOSAL_STATUS_ACCEPT)

    async def finalize_block(self, req: FinalizeBlockRequest
                             ) -> FinalizeBlockResponse:
        return FinalizeBlockResponse(
            tx_results=[ExecTxResult() for _ in req.txs])

    async def extend_vote(self, req: ExtendVoteRequest
                          ) -> ExtendVoteResponse:
        return ExtendVoteResponse()

    async def verify_vote_extension(self, req: VerifyVoteExtensionRequest
                                    ) -> VerifyVoteExtensionResponse:
        return VerifyVoteExtensionResponse(
            status=VERIFY_VOTE_EXTENSION_STATUS_ACCEPT)

    async def commit(self, req: CommitRequest) -> CommitResponse:
        return CommitResponse()

    # Snapshot connection
    async def list_snapshots(self, req: ListSnapshotsRequest
                             ) -> ListSnapshotsResponse:
        return ListSnapshotsResponse()

    async def offer_snapshot(self, req: OfferSnapshotRequest
                             ) -> OfferSnapshotResponse:
        return OfferSnapshotResponse()

    async def load_snapshot_chunk(self, req: LoadSnapshotChunkRequest
                                  ) -> LoadSnapshotChunkResponse:
        return LoadSnapshotChunkResponse()

    async def apply_snapshot_chunk(self, req: ApplySnapshotChunkRequest
                                   ) -> ApplySnapshotChunkResponse:
        return ApplySnapshotChunkResponse()


class BaseApplication(Application):
    """Concrete no-op application (reference: BaseApplication)."""
