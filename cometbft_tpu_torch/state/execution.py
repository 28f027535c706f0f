"""BlockExecutor: the consensus <-> ABCI bridge.

Reference: state/execution.go:55 — CreateProposalBlock (:113),
ProcessProposal (:173), ApplyBlock (:224) -> FinalizeBlock -> save
results -> updateState -> app Commit + mempool update -> events;
ExtendVote / VerifyVoteExtension (:339, :369) — through
cometbft_tpu/state/execution.py, whose error texts this copy keeps.

``BlockExecutor(..., device=None)`` resolves its device at construction
(the card; it raises where CUDA is absent) and validates every block on
it: ``apply_block`` verifies the block's LastCommit on B1 before the app
sees the block.  The mempool and the evidence pool are the caller's
(mempool/mempool.CListMempool, evidence/pool.EvidencePool), or no-op
ones that reap nothing, resolve no tx hash and hold no evidence.  On an
aggregate-commit chain the proposer aggregates the last commit as the
JAX package's does.

One departure (ROADMAP.md §C): the JAX ``validate_block`` turns every
exception of ``check_evidence`` into an invalid block; the port turns
only the evidence's own protocol errors (``EvidenceError``,
``VoteError``) into one, and lets a kernel that does not build or launch
raise as it is.
"""
from __future__ import annotations

from typing import Optional

from ..abci import types as abci
from ..crypto import encoding as crypto_encoding, merkle
from ..device import resolve
from ..libs import fail
from ..libs.log import Logger, new_logger
from ..types.block import MAX_HEADER_BYTES, MAX_OVERHEAD_FOR_BLOCK, Block
from ..types.block_id import BlockID
from ..types.commit import AggregateCommit, Commit, ExtendedCommit
from ..types.evidence import (
    DuplicateVoteEvidence, EvidenceError, LightClientAttackEvidence,
)
from ..types.events import NopEventBus
from ..types.params import MAX_BLOCK_SIZE_BYTES, ParamsError
from ..types.tx import compute_proto_size_overhead
from ..types.validator import Validator
from ..types.vote import (
    BLOCK_ID_FLAG_ABSENT, BLOCK_ID_FLAG_COMMIT, Vote, VoteError,
)
from ..wire import abci_pb, encode
from .metrics import Metrics
from .state import State, StateVersion
from .store import Store
from .validation import BlockValidationError, validate_block

_MAX_COMMIT_SIG_BYTES = 109 + 2  # CommitSig proto + repeated overhead


class ExecutionError(Exception):
    pass


class InvalidBlockError(ExecutionError):
    pass


def max_data_bytes(max_bytes: int, ev_size: int, n_vals: int) -> int:
    """Reference: types/block.go MaxDataBytes (panics when negative)."""
    commit_bytes = 4 + 10 + 76 + n_vals * _MAX_COMMIT_SIG_BYTES
    cap_ = (max_bytes - MAX_OVERHEAD_FOR_BLOCK - MAX_HEADER_BYTES -
            commit_bytes - ev_size)
    if cap_ < 0:
        raise ExecutionError(
            f"negative MaxDataBytes: block.MaxBytes={max_bytes} is too "
            f"small to fit a header plus a {n_vals}-validator commit")
    return cap_


def tx_results_hash(tx_results: list[abci.ExecTxResult]) -> bytes:
    """Merkle root over deterministic ExecTxResult proto bytes.

    Reference: state/store.go TxResultsHash + types/results.go
    (log/info/events stripped)."""
    leaves = []
    for r in tx_results:
        d: dict = {}
        if r.code:
            d["code"] = r.code
        if r.data:
            d["data"] = r.data
        if r.gas_wanted:
            d["gas_wanted"] = r.gas_wanted
        if r.gas_used:
            d["gas_used"] = r.gas_used
        if r.codespace:
            d["codespace"] = r.codespace
        leaves.append(encode(abci_pb.EXEC_TX_RESULT, d))
    return merkle.hash_from_byte_slices(leaves)


def build_last_commit_info(block: Block, last_val_set,
                           initial_height: int) -> abci.CommitInfo:
    """Reference: state/execution.go BuildLastCommitInfo.

    An AggregateCommit reports COMMIT for every signer bit and ABSENT
    otherwise (the aggregate form cannot distinguish nil votes from
    absence — both are excluded from the bitmap)."""
    if block.header.height == initial_height:
        return abci.CommitInfo()
    commit = block.last_commit
    if last_val_set.size() != commit.size():
        raise ExecutionError(
            f"commit size {commit.size()} doesn't match valset length "
            f"{last_val_set.size()} at height {block.header.height}")
    votes = []
    if isinstance(commit, AggregateCommit):
        for i, val in enumerate(last_val_set.validators):
            votes.append(abci.VoteInfo(
                validator=abci.ABCIValidator(address=val.address,
                                             power=val.voting_power),
                block_id_flag=(BLOCK_ID_FLAG_COMMIT
                               if commit.signers.get_index(i)
                               else BLOCK_ID_FLAG_ABSENT)))
        return abci.CommitInfo(round=commit.round, votes=votes)
    for i, cs in enumerate(commit.signatures):
        val = last_val_set.validators[i]
        votes.append(abci.VoteInfo(
            validator=abci.ABCIValidator(address=val.address,
                                         power=val.voting_power),
            block_id_flag=cs.block_id_flag))
    return abci.CommitInfo(round=commit.round, votes=votes)


def build_extended_commit_info(ext_commit: ExtendedCommit, val_set,
                               initial_height: int,
                               feature_params) -> abci.ExtendedCommitInfo:
    """Reference: state/execution.go buildExtendedCommitInfo."""
    if ext_commit.height < initial_height:
        return abci.ExtendedCommitInfo()
    if val_set.size() != ext_commit.size():
        raise ExecutionError(
            f"extended commit size {ext_commit.size()} does not match "
            f"validator set length {val_set.size()} at height "
            f"{ext_commit.height}")
    ext_enabled = feature_params.vote_extensions_enabled(
        ext_commit.height)
    votes = []
    for i, ecs in enumerate(ext_commit.extended_signatures):
        val = val_set.validators[i]
        if ext_enabled and ecs.block_id_flag == BLOCK_ID_FLAG_COMMIT \
                and (not ecs.extension_signature or
                     not ecs.non_rp_extension_signature):
            raise ExecutionError(
                f"commit at height {ext_commit.height} received with "
                f"missing vote extension signature")
        votes.append(abci.ExtendedVoteInfo(
            validator=abci.ABCIValidator(address=val.address,
                                         power=val.voting_power),
            vote_extension=ecs.extension,
            extension_signature=ecs.extension_signature,
            block_id_flag=ecs.block_id_flag,
            non_rp_vote_extension=ecs.non_rp_extension,
            non_rp_extension_signature=ecs.non_rp_extension_signature))
    return abci.ExtendedCommitInfo(round=ext_commit.round, votes=votes)


def validate_validator_updates(updates: list[abci.ValidatorUpdate],
                               validator_params) -> list[Validator]:
    """Reference: execution.go validateValidatorUpdates + PB2TM."""
    out = []
    for vu in updates:
        if vu.power < 0:
            raise ExecutionError(
                f"voting power can't be negative: {vu.power}")
        if vu.power == 0:
            # deletions are ok
            pass
        if not validator_params.is_valid_pub_key_type(vu.pub_key_type):
            raise ExecutionError(
                f"validator {vu.pub_key_bytes.hex()[:16]} is using "
                f"pubkey type {vu.pub_key_type!r}, which is unsupported "
                f"for consensus")
        pk = crypto_encoding.pub_key_from_type_and_bytes(
            vu.pub_key_type, vu.pub_key_bytes)
        out.append(Validator.new(pk, vu.power))
    return out


class _NopEvidencePool:
    """Reference: sm.EmptyEvidencePool."""

    def pending_evidence(self, max_bytes: int):
        return [], 0

    def check_evidence(self, evidence: list) -> None:
        pass

    def update(self, state: State, evidence: list) -> None:
        pass


class _NopMempool:
    """What the executor calls of a mempool when it is given none."""

    def lock(self):
        pass

    def unlock(self):
        pass

    def pre_update(self):
        pass

    async def flush_app_conn(self):
        pass

    def reap_max_bytes_max_gas(self, max_bytes: int, max_gas: int
                               ) -> list[bytes]:
        return []

    def size(self) -> int:
        return 0

    def get_tx_by_hash(self, tx_hash: bytes):
        return None

    async def update(self, height, txs, tx_results, pre_check=None,
                     post_check=None):
        pass


class BlockExecutor:
    def __init__(self, state_store: Store, proxy_app,
                 mempool=None, evpool=None,
                 event_bus=None,
                 block_store=None,
                 logger: Optional[Logger] = None,
                 metrics=None, device=None):
        self.device = resolve(device)   # the card unless the caller names one
        self.metrics = metrics if metrics is not None else Metrics()
        self.store = state_store
        self.proxy_app = proxy_app   # ABCI consensus connection
        self.mempool = mempool if mempool is not None else _NopMempool()
        self.evpool = evpool if evpool is not None else _NopEvidencePool()
        self.event_bus = event_bus if event_bus is not None \
            else NopEventBus()
        self.block_store = block_store
        self.logger = logger if logger is not None else \
            new_logger("state")
        self._last_validated_hash: bytes = b""
        self.last_retain_height = 0
        self.pruner = None          # attached by the node (state/pruner.py)

    # ------------------------------------------------------------------
    async def create_proposal_block(
            self, height: int, state: State,
            last_ext_commit: ExtendedCommit,
            proposer_addr: bytes,
            last_aggregate_commit: Optional[AggregateCommit] = None
            ) -> Block:
        """Reference: execution.go CreateProposalBlock (:113).

        On an aggregate-commit chain the block embeds the aggregate
        form: normally aggregated here from the extended commit's
        per-vote signatures; a node restored from an aggregate seen
        commit passes the stored aggregate as
        ``last_aggregate_commit``."""
        max_bytes = state.consensus_params.block.max_bytes
        empty_max_bytes = max_bytes == -1
        if empty_max_bytes:
            max_bytes = MAX_BLOCK_SIZE_BYTES
        max_gas = state.consensus_params.block.max_gas

        evidence, ev_size = self.evpool.pending_evidence(
            state.consensus_params.evidence.max_bytes)
        data_cap = max_data_bytes(max_bytes, ev_size,
                                  state.validators.size())
        reap_cap = -1 if empty_max_bytes else data_cap
        txs = self.mempool.reap_max_bytes_max_gas(reap_cap, max_gas)
        commit: Commit | AggregateCommit = last_ext_commit.to_commit()
        if height != state.initial_height and \
                state.consensus_params.feature \
                .aggregate_commits_enabled(height - 1):
            commit = last_aggregate_commit \
                if last_aggregate_commit is not None \
                else AggregateCommit.from_commit(commit)
        block = state.make_block(height, txs, commit, evidence,
                                 proposer_addr)
        rpp = await self.proxy_app.prepare_proposal(
            abci.PrepareProposalRequest(
                max_tx_bytes=data_cap,
                txs=list(block.data.txs),
                local_last_commit=build_extended_commit_info(
                    last_ext_commit, self._load_valset(
                        last_ext_commit.height, state),
                    state.initial_height,
                    state.consensus_params.feature),
                misbehavior=_evidence_to_abci(evidence),
                height=block.header.height,
                time=block.header.time,
                next_validators_hash=block.header.next_validators_hash,
                proposer_address=block.header.proposer_address,
            ))
        total = sum(len(tx) + compute_proto_size_overhead(len(tx))
                    for tx in rpp.txs)
        if total > data_cap:
            raise ExecutionError(
                f"post-PrepareProposal txs exceed max data bytes "
                f"{total} > {data_cap}")
        return state.make_block(height, list(rpp.txs), commit, evidence,
                                proposer_addr,
                                block_time=block.header.time)

    def _load_valset(self, height: int, state: State):
        """The validator set that SIGNED height (reference:
        buildExtendedCommitInfoFromStore → LoadValidators(ec.Height))."""
        try:
            return self.store.load_validators(height)
        except Exception:
            if height == state.last_block_height and \
                    state.last_validators is not None:
                return state.last_validators
            raise

    async def process_proposal(self, block: Block, state: State) -> bool:
        """Reference: execution.go ProcessProposal (:173)."""
        resp = await self.proxy_app.process_proposal(
            abci.ProcessProposalRequest(
                hash=block.hash(),
                height=block.header.height,
                time=block.header.time,
                txs=list(block.data.txs),
                proposed_last_commit=self._last_commit_info(block, state),
                misbehavior=_evidence_to_abci(block.evidence),
                proposer_address=block.header.proposer_address,
                next_validators_hash=block.header.next_validators_hash,
            ))
        if resp.status == abci.PROCESS_PROPOSAL_STATUS_UNKNOWN:
            raise ExecutionError(
                "ProcessProposal responded with status UNKNOWN")
        return resp.is_accepted()

    def _last_commit_info(self, block: Block,
                          state: State) -> abci.CommitInfo:
        if block.header.height == state.initial_height:
            return abci.CommitInfo()
        last_vals = self.store.load_validators(block.header.height - 1)
        return build_last_commit_info(block, last_vals,
                                      state.initial_height)

    # ------------------------------------------------------------------
    def validate_block(self, state: State, block: Block) -> None:
        """Reference: execution.go ValidateBlock."""
        if self._last_validated_hash != block.hash():
            validate_block(state, block, self.device)
            self._last_validated_hash = block.hash()
        try:
            self.evpool.check_evidence(block.evidence)
        except (EvidenceError, VoteError) as e:   # -> an invalid block
            raise BlockValidationError(f"invalid evidence: {e}") from e

    async def apply_block(self, state: State, block_id: BlockID,
                          block: Block,
                          syncing_to_height: int = 0) -> State:
        """Validate + execute + commit (reference: ApplyBlock :224)."""
        if self._last_validated_hash != block.hash():
            try:
                validate_block(state, block, self.device)
            except BlockValidationError as e:
                raise InvalidBlockError(str(e)) from e
            self._last_validated_hash = block.hash()
        return await self._apply_block(state, block_id, block,
                                       syncing_to_height)

    async def apply_verified_block(self, state: State, block_id: BlockID,
                                   block: Block,
                                   syncing_to_height: int = 0) -> State:
        return await self._apply_block(state, block_id, block,
                                       syncing_to_height)

    async def _apply_block(self, state: State, block_id: BlockID,
                           block: Block,
                           syncing_to_height: int) -> State:
        h = block.header
        abci_response = await self.proxy_app.finalize_block(
            abci.FinalizeBlockRequest(
                hash=block.hash(),
                next_validators_hash=h.next_validators_hash,
                proposer_address=h.proposer_address,
                height=h.height,
                time=h.time,
                decided_last_commit=self._last_commit_info(block, state),
                misbehavior=_evidence_to_abci(block.evidence),
                txs=list(block.data.txs),
                syncing_to_height=syncing_to_height or h.height,
            ))
        self.logger.info("Finalized block", height=h.height,
                         num_txs_res=len(abci_response.tx_results),
                         num_val_updates=len(
                             abci_response.validator_updates))
        if len(block.data.txs) != len(abci_response.tx_results):
            raise ExecutionError(
                f"expected tx results length to match block txs: "
                f"{len(block.data.txs)} != "
                f"{len(abci_response.tx_results)}")

        fail.fail()    # crash point: finalized, responses unsaved
                       # (execution.go:267)

        # save results BEFORE app commit (crash-consistency barrier)
        self.store.save_finalize_block_response(h.height, abci_response)

        fail.fail()    # crash point: responses saved, state not updated
                       # (execution.go:274)

        validator_updates = validate_validator_updates(
            abci_response.validator_updates,
            state.consensus_params.validator)
        if validator_updates:
            self.metrics.validator_set_updates.add()
        if abci_response.consensus_param_updates is not None:
            self.metrics.consensus_param_updates.add()

        state = update_state(state, block_id, block, abci_response,
                             validator_updates)

        # lock mempool, app Commit, update mempool
        retain_height = await self.commit(state, block, abci_response)

        self.evpool.update(state, block.evidence)

        fail.fail()    # crash point: app committed, state unsaved
                       # (execution.go:315)

        state.app_hash = abci_response.app_hash
        self.store.save(state)

        # app-requested pruning: hand the retain height to the pruner
        # service (reference: execution.go pruneBlocks -> state/pruner.go)
        self.last_retain_height = retain_height
        if self.pruner is not None and retain_height > 0:
            self.pruner.set_application_retain_height(retain_height)

        self._fire_events(block, block_id, abci_response,
                          validator_updates)
        return state

    async def commit(self, state: State, block: Block,
                     abci_response: abci.FinalizeBlockResponse) -> int:
        """Reference: execution.go Commit (:403)."""
        self.mempool.pre_update()
        self.mempool.lock()
        try:
            await self.mempool.flush_app_conn()
            res = await self.proxy_app.commit()
            self.logger.info("Committed state", height=block.header.height)
            await self.mempool.update(
                block.header.height, list(block.data.txs),
                abci_response.tx_results)
        finally:
            self.mempool.unlock()
        return res.retain_height

    # ------------------------------------------------------------------
    async def extend_vote(self, vote: Vote, block: Block,
                          state: State) -> tuple[bytes, bytes]:
        """Reference: execution.go ExtendVote (:339)."""
        if block.hash() != vote.block_id.hash:
            raise ExecutionError("vote's hash does not match block")
        if vote.height != block.header.height:
            raise ExecutionError("vote and block heights do not match")
        resp = await self.proxy_app.extend_vote(abci.ExtendVoteRequest(
            hash=vote.block_id.hash,
            height=vote.height,
            time=block.header.time,
            txs=list(block.data.txs),
            proposed_last_commit=self._last_commit_info(block, state),
            misbehavior=_evidence_to_abci(block.evidence),
            next_validators_hash=block.header.next_validators_hash,
            proposer_address=block.header.proposer_address,
        ))
        return resp.vote_extension, resp.non_rp_extension

    async def verify_vote_extension(self, vote: Vote) -> bool:
        """Reference: execution.go VerifyVoteExtension (:369)."""
        resp = await self.proxy_app.verify_vote_extension(
            abci.VerifyVoteExtensionRequest(
                hash=vote.block_id.hash,
                validator_address=vote.validator_address,
                height=vote.height,
                vote_extension=vote.extension,
                non_rp_vote_extension=vote.non_rp_extension,
            ))
        if resp.status == abci.VERIFY_VOTE_EXTENSION_STATUS_UNKNOWN:
            raise ExecutionError(
                "VerifyVoteExtension responded with status UNKNOWN")
        return resp.is_accepted()

    # ------------------------------------------------------------------
    def _fire_events(self, block: Block, block_id: BlockID,
                     abci_response: abci.FinalizeBlockResponse,
                     validator_updates: list[Validator]) -> None:
        """Reference: execution.go fireEvents."""
        bus = self.event_bus
        bus.publish_new_block(block, block_id, abci_response)
        bus.publish_new_block_header(block.header)
        # every height, events or none (reference: execution.go
        # fireEvents), so the block indexer can find every height; the
        # JAX executor publishes only when FinalizeBlock returned events
        bus.publish_new_block_events(block.header.height,
                                     abci_response.events,
                                     len(block.data.txs))
        for ev in block.evidence:
            bus.publish_new_evidence(ev, block.header.height)
        for i, tx in enumerate(block.data.txs):
            bus.publish_tx(block.header.height, i, tx,
                           abci_response.tx_results[i],
                           abci_response.tx_results[i].events)
        if validator_updates:
            bus.publish_validator_set_updates(validator_updates)


def provisional_next_state(state: State, block_id: BlockID,
                           block: Block) -> State:
    """The H+1 state the consensus machine can know BEFORE height H's
    FinalizeBlock/Commit have run — the pipelined-commit seam.

    Everything H+1 needs up to (but not including) block validation
    and proposal construction is already determined when H is decided:
    the H+1 validator set is ``state.next_validators`` (validator
    updates from H only land at H+2), the chain id and vote-extension
    schedule come from the pre-H consensus params, and the last
    validators are H's signers.  The fields only execution can produce
    — ``app_hash``, ``last_results_hash``, validator/param updates,
    ``next_block_delay`` — are left at their pre-H values; the
    pipeline barrier replaces this provisional state with the real
    post-apply state before anything reads them (ConsensusState
    reconciles on the apply-done handoff and rebuilds the height vote
    set in the rare case a param update changed what the provisional
    state baked in)."""
    return update_state(state, block_id, block,
                        abci.FinalizeBlockResponse(
                            next_block_delay_ns=state.next_block_delay_ns),
                        [])


def update_state(state: State, block_id: BlockID, block: Block,
                 abci_response: abci.FinalizeBlockResponse,
                 validator_updates: list[Validator]) -> State:
    """Reference: execution.go updateState."""
    header = block.header
    n_val_set = state.next_validators.copy()

    last_height_vals_changed = state.last_height_validators_changed
    if validator_updates:
        n_val_set.update_with_change_set(validator_updates)
        # changes from height H apply at H+2 (nextValSet delay)
        last_height_vals_changed = header.height + 1 + 1
    n_val_set.increment_proposer_priority(1)

    next_version = StateVersion(
        consensus=state.version.consensus,
        software=state.version.software)
    next_params = state.consensus_params
    last_height_params_changed = state.last_height_consensus_params_changed
    if abci_response.consensus_param_updates is not None:
        next_params = state.consensus_params.update(
            abci_response.consensus_param_updates)
        try:
            next_params.validate_basic()
        except ParamsError as e:
            raise ExecutionError(
                f"validating new consensus params: {e}") from e
        # bump only the new state's version; the caller's snapshot stays
        # untouched (Go passes State by value)
        next_version.consensus = type(state.version.consensus)(
            block=state.version.consensus.block,
            app=next_params.version.app)
        last_height_params_changed = header.height + 1

    new_state = State(
        version=next_version,
        chain_id=state.chain_id,
        initial_height=state.initial_height,
        last_block_height=header.height,
        last_block_id=block_id,
        last_block_time=header.time,
        next_validators=n_val_set,
        validators=state.next_validators.copy(),
        last_validators=state.validators.copy(),
        last_height_validators_changed=last_height_vals_changed,
        consensus_params=next_params,
        last_height_consensus_params_changed=last_height_params_changed,
        last_results_hash=tx_results_hash(abci_response.tx_results),
        app_hash=b"",   # filled after app Commit
        next_block_delay_ns=abci_response.next_block_delay_ns,
    )
    return new_state


def _evidence_to_abci(evidence: list) -> list[abci.Misbehavior]:
    """Reference: types/evidence.go Evidence.ABCI()."""
    out = []
    for ev in evidence:
        if isinstance(ev, DuplicateVoteEvidence):
            out.append(abci.Misbehavior(
                type=abci.MISBEHAVIOR_TYPE_DUPLICATE_VOTE,
                validator=abci.ABCIValidator(
                    address=ev.vote_a.validator_address,
                    power=ev.validator_power),
                height=ev.vote_a.height,
                time=ev.timestamp,
                total_voting_power=ev.total_voting_power))
        elif isinstance(ev, LightClientAttackEvidence):
            for val in ev.byzantine_validators:
                out.append(abci.Misbehavior(
                    type=abci.MISBEHAVIOR_TYPE_LIGHT_CLIENT_ATTACK,
                    validator=abci.ABCIValidator(
                        address=val.address, power=val.voting_power),
                    height=ev.common_height,
                    time=ev.timestamp,
                    total_voting_power=ev.total_voting_power))
    return out
