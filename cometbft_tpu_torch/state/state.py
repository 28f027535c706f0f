"""sm.State: the deterministic node state between blocks.

Reference: state/state.go — State value (:47-84), MakeGenesisState
(:303), MakeBlock — through cometbft_tpu/state/state.py.  ``bytes()``
is what the state store writes at every height: three full validator
sets through the proto codec.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from .. import version as _version
from ..types.block import Block, ConsensusVersion, Data, Header
from ..types.block_id import BlockID
from ..types.commit import Commit
from ..types.genesis import GenesisDoc
from ..types.params import ConsensusParams
from ..types.timestamp import Timestamp
from ..types.validator import Validator
from ..types.validator_set import ValidatorSet
from ..wire import state_pb, encode, decode


class StateError(Exception):
    pass


@dataclass
class StateVersion:
    consensus: ConsensusVersion = field(default_factory=ConsensusVersion)
    software: str = _version.CMT_SEM_VER


@dataclass
class State:
    version: StateVersion = field(default_factory=StateVersion)
    chain_id: str = ""
    initial_height: int = 0

    last_block_height: int = 0
    last_block_id: BlockID = field(default_factory=BlockID)
    last_block_time: Timestamp = field(default_factory=Timestamp.zero)

    next_validators: Optional[ValidatorSet] = None
    validators: Optional[ValidatorSet] = None
    last_validators: Optional[ValidatorSet] = None
    last_height_validators_changed: int = 0

    consensus_params: ConsensusParams = field(
        default_factory=ConsensusParams)
    last_height_consensus_params_changed: int = 0

    last_results_hash: bytes = b""
    app_hash: bytes = b""
    # delay between committing a block and starting the next height
    next_block_delay_ns: int = 0

    def copy(self) -> "State":
        return State(
            version=replace(self.version),
            chain_id=self.chain_id,
            initial_height=self.initial_height,
            last_block_height=self.last_block_height,
            last_block_id=self.last_block_id,
            last_block_time=self.last_block_time,
            next_validators=self.next_validators.copy()
            if self.next_validators else None,
            validators=self.validators.copy() if self.validators else None,
            last_validators=self.last_validators.copy()
            if self.last_validators else None,
            last_height_validators_changed=(
                self.last_height_validators_changed),
            consensus_params=self.consensus_params.update(None),
            last_height_consensus_params_changed=(
                self.last_height_consensus_params_changed),
            last_results_hash=self.last_results_hash,
            app_hash=self.app_hash,
            next_block_delay_ns=self.next_block_delay_ns,
        )

    def is_empty(self) -> bool:
        return self.validators is None

    # ------------------------------------------------------------------
    def block_time(self, height: int, last_commit: Commit) -> Timestamp:
        """The consensus-mandated block time (reference: state.go
        MakeBlock:252-260): now() under PBTS, the initial height
        included; genesis time at the initial height otherwise; else
        the BFT-time weighted median of LastCommit.  The PBTS check
        comes first: a PBTS chain whose nodes boot later than
        message_delay after genesis would otherwise propose height 1
        with the genesis time, which every validator finds untimely."""
        if self.consensus_params.feature.pbts_enabled(height):
            return Timestamp.now()
        if height == self.initial_height:
            return self.last_block_time
        return last_commit.median_time(self.last_validators)

    def make_block(self, height: int, txs: list[bytes],
                   last_commit: Commit, evidence: list,
                   proposer_address: bytes,
                   block_time: Optional[Timestamp] = None) -> Block:
        """Build a block wired to this state (reference: state.go
        MakeBlock — fills header from state)."""
        block = Block(
            header=Header(
                version=ConsensusVersion(
                    block=self.version.consensus.block,
                    app=self.version.consensus.app),
                chain_id=self.chain_id,
                height=height,
                time=block_time if block_time is not None
                else self.block_time(height, last_commit),
                last_block_id=self.last_block_id,
                validators_hash=self.validators.hash(),
                next_validators_hash=self.next_validators.hash(),
                consensus_hash=self.consensus_params.hash(),
                app_hash=self.app_hash,
                last_results_hash=self.last_results_hash,
                proposer_address=proposer_address,
            ),
            data=Data(txs=txs),
            evidence=list(evidence),
            last_commit=last_commit,
        )
        block.fill_header()
        return block

    # ------------------------------------------------------------------
    def to_proto(self) -> dict:
        d: dict = {
            "version": {
                "consensus": self.version.consensus.to_proto(),
                "software": self.version.software,
            },
            "last_block_id": self.last_block_id.to_proto(),
            "last_block_time": self.last_block_time.to_proto(),
            "consensus_params": self.consensus_params.to_proto(),
            "next_block_delay": _dur_proto(self.next_block_delay_ns),
        }
        if self.chain_id:
            d["chain_id"] = self.chain_id
        if self.initial_height:
            d["initial_height"] = self.initial_height
        if self.last_block_height:
            d["last_block_height"] = self.last_block_height
        if self.next_validators is not None:
            d["next_validators"] = self.next_validators.to_proto()
        if self.validators is not None:
            d["validators"] = self.validators.to_proto()
        if self.last_validators is not None and \
                self.last_validators.size() > 0:
            d["last_validators"] = self.last_validators.to_proto()
        if self.last_height_validators_changed:
            d["last_height_validators_changed"] = \
                self.last_height_validators_changed
        if self.last_height_consensus_params_changed:
            d["last_height_consensus_params_changed"] = \
                self.last_height_consensus_params_changed
        if self.last_results_hash:
            d["last_results_hash"] = self.last_results_hash
        if self.app_hash:
            d["app_hash"] = self.app_hash
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "State":
        ver = d.get("version") or {}
        nv, v, lv = (d.get("next_validators"), d.get("validators"),
                     d.get("last_validators"))
        return cls(
            version=StateVersion(
                consensus=ConsensusVersion.from_proto(
                    ver.get("consensus") or {}),
                software=ver.get("software", "")),
            chain_id=d.get("chain_id", ""),
            initial_height=d.get("initial_height", 0),
            last_block_height=d.get("last_block_height", 0),
            last_block_id=BlockID.from_proto(d.get("last_block_id") or {}),
            last_block_time=Timestamp.from_proto(
                d.get("last_block_time") or {}),
            next_validators=ValidatorSet.from_proto(nv)
            if nv is not None else None,
            validators=ValidatorSet.from_proto(v) if v is not None
            else None,
            last_validators=ValidatorSet.from_proto(lv)
            if lv is not None else ValidatorSet(),
            last_height_validators_changed=d.get(
                "last_height_validators_changed", 0),
            consensus_params=ConsensusParams.from_proto(
                d.get("consensus_params") or {}),
            last_height_consensus_params_changed=d.get(
                "last_height_consensus_params_changed", 0),
            last_results_hash=d.get("last_results_hash", b""),
            app_hash=d.get("app_hash", b""),
            next_block_delay_ns=_dur_from_proto(
                d.get("next_block_delay") or {}),
        )

    def bytes(self) -> bytes:
        return encode(state_pb.STATE, self.to_proto())

    @classmethod
    def from_bytes(cls, raw: bytes) -> "State":
        return cls.from_proto(decode(state_pb.STATE, raw))


def _dur_proto(ns: int) -> dict:
    d: dict = {}
    s, rem = divmod(ns, 1_000_000_000)
    if s:
        d["seconds"] = s
    if rem:
        d["nanos"] = rem
    return d


def _dur_from_proto(d: dict) -> int:
    return d.get("seconds", 0) * 1_000_000_000 + d.get("nanos", 0)


def make_genesis_state(gen_doc: GenesisDoc) -> State:
    """Reference: state.go MakeGenesisState (:303)."""
    gen_doc.validate_and_complete()
    if gen_doc.validators:
        validators = [Validator.new(v.pub_key, v.power)
                      for v in gen_doc.validators]
        validator_set = ValidatorSet(validators)
        next_validator_set = ValidatorSet(validators)
        next_validator_set.increment_proposer_priority(1)
    else:
        validator_set = ValidatorSet()
        next_validator_set = ValidatorSet()

    return State(
        version=StateVersion(),
        chain_id=gen_doc.chain_id,
        initial_height=gen_doc.initial_height,
        last_block_height=0,
        last_block_id=BlockID(),
        last_block_time=gen_doc.genesis_time,
        next_validators=next_validator_set,
        validators=validator_set,
        last_validators=ValidatorSet(),
        last_height_validators_changed=gen_doc.initial_height,
        consensus_params=gen_doc.consensus_params.update(None),
        last_height_consensus_params_changed=gen_doc.initial_height,
        app_hash=gen_doc.app_hash,
    )
