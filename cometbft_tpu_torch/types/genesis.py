"""Genesis document: the chain-level configuration.

Reference: types/genesis.go — GenesisDoc with validators, consensus params,
app state; its JSON with amino-compatible pubkey encoding
({"type": "tendermint/PubKeyEd25519", "value": <b64>}) — through
cometbft_tpu/types/genesis.py.  Reading and writing genesis files is
left to the caller.
"""
from __future__ import annotations

import base64
import json
from dataclasses import dataclass, field
from typing import Any, Optional

from ..crypto import encoding as crypto_encoding
from ..crypto.keys import PubKey
from .params import (
    BlockParams, ConsensusParams, EvidenceParams, FeatureParams,
    SynchronyParams, ValidatorParams, VersionParams,
    default_consensus_params,
)
from .timestamp import Timestamp
from .validator import MAX_TOTAL_VOTING_POWER, Validator
from .validator_set import ValidatorSet

MAX_CHAIN_ID_LEN = 50

# amino-compatible JSON type tags (single registry: crypto/encoding.py)
_PUBKEY_JSON_TYPES = crypto_encoding.AMINO_PUBKEY_NAMES
_PUBKEY_JSON_TYPES_REV = {v: k for k, v in _PUBKEY_JSON_TYPES.items()}


class GenesisError(Exception):
    pass


def pub_key_to_json(pk: PubKey) -> dict:
    tag = _PUBKEY_JSON_TYPES.get(pk.type())
    if tag is None:
        raise GenesisError(f"unsupported pubkey type {pk.type()}")
    return {"type": tag,
            "value": base64.b64encode(pk.bytes()).decode()}


def pub_key_from_json(d: dict) -> PubKey:
    key_type = _PUBKEY_JSON_TYPES_REV.get(d.get("type", ""))
    if key_type is None:
        raise GenesisError(f"unsupported pubkey json type {d.get('type')}")
    return crypto_encoding.pub_key_from_type_and_bytes(
        key_type, base64.b64decode(d["value"]))


@dataclass
class GenesisValidator:
    address: bytes
    pub_key: PubKey
    power: int
    name: str = ""


@dataclass
class GenesisDoc:
    chain_id: str
    genesis_time: Timestamp = field(default_factory=Timestamp.now)
    initial_height: int = 1
    consensus_params: Optional[ConsensusParams] = field(
        default_factory=default_consensus_params)
    validators: list[GenesisValidator] = field(default_factory=list)
    app_hash: bytes = b""
    app_state: Any = None

    def validate_and_complete(self) -> None:
        """Reference: genesis.go ValidateAndComplete."""
        if not self.chain_id:
            raise GenesisError("genesis doc must include non-empty chain_id")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise GenesisError(
                f"chain_id in genesis doc is too long (max: "
                f"{MAX_CHAIN_ID_LEN})")
        if self.initial_height < 0:
            raise GenesisError("initial_height cannot be negative")
        if self.initial_height == 0:
            self.initial_height = 1
        if self.consensus_params is None:
            self.consensus_params = default_consensus_params()
        else:
            self.consensus_params.validate_basic()
        for i, v in enumerate(self.validators):
            if v.power == 0:
                raise GenesisError(
                    f"genesis file cannot contain validators with no "
                    f"voting power: {v.name or i}")
            if v.power < 0:
                raise GenesisError("negative voting power")
            if v.power > MAX_TOTAL_VOTING_POWER:
                raise GenesisError("voting power too large")
            if v.address and v.address != v.pub_key.address():
                raise GenesisError(
                    f"incorrect address for validator {v.name or i}")
            if not v.address:
                v.address = v.pub_key.address()
        if self.genesis_time.is_zero():
            self.genesis_time = Timestamp.now()

    def validator_hash(self) -> bytes:
        vset = ValidatorSet([Validator.new(v.pub_key, v.power)
                             for v in self.validators])
        return vset.hash()

    # ------------------------------------------------------------------
    def to_json(self) -> str:
        doc = {
            "genesis_time": self.genesis_time.rfc3339(),
            "chain_id": self.chain_id,
            "initial_height": str(self.initial_height),
            "consensus_params": _params_to_json(self.consensus_params),
            "validators": [
                {
                    "address": v.address.hex().upper(),
                    "pub_key": pub_key_to_json(v.pub_key),
                    "power": str(v.power),
                    "name": v.name,
                }
                for v in self.validators
            ],
            "app_hash": self.app_hash.hex().upper(),
        }
        if self.app_state is not None:
            doc["app_state"] = self.app_state
        return json.dumps(doc, indent=2)

    @classmethod
    def from_json(cls, raw: str) -> "GenesisDoc":
        d = json.loads(raw)
        if "chain_id" not in d:
            raise GenesisError("genesis doc missing chain_id")
        vals = []
        for v in d.get("validators") or []:
            pk = pub_key_from_json(v["pub_key"])
            vals.append(GenesisValidator(
                address=bytes.fromhex(v.get("address", "")) or
                pk.address(),
                pub_key=pk,
                power=int(v["power"]),
                name=v.get("name", ""),
            ))
        gt = d.get("genesis_time")
        doc = cls(
            chain_id=d["chain_id"],
            genesis_time=Timestamp.from_rfc3339(gt) if gt
            else Timestamp.zero(),
            initial_height=int(d.get("initial_height", 1) or 1),
            consensus_params=_params_from_json(d.get("consensus_params")),
            validators=vals,
            app_hash=bytes.fromhex(d.get("app_hash", "")),
            app_state=d.get("app_state"),
        )
        doc.validate_and_complete()
        return doc


def _params_to_json(p: Optional[ConsensusParams]) -> Optional[dict]:
    if p is None:
        return None
    return {
        "block": {"max_bytes": str(p.block.max_bytes),
                  "max_gas": str(p.block.max_gas)},
        "evidence": {
            "max_age_num_blocks": str(p.evidence.max_age_num_blocks),
            "max_age_duration": str(p.evidence.max_age_duration_ns),
            "max_bytes": str(p.evidence.max_bytes),
        },
        "validator": {"pub_key_types": list(p.validator.pub_key_types)},
        "version": {"app": str(p.version.app)},
        "synchrony": {
            "precision": str(p.synchrony.precision_ns),
            "message_delay": str(p.synchrony.message_delay_ns),
        },
        "feature": {
            "vote_extensions_enable_height": str(
                p.feature.vote_extensions_enable_height),
            "pbts_enable_height": str(p.feature.pbts_enable_height),
            "aggregate_commit_enable_height": str(
                p.feature.aggregate_commit_enable_height),
        },
    }


def _params_from_json(d: Optional[dict]) -> Optional[ConsensusParams]:
    if d is None:
        return None
    blk = d.get("block") or {}
    ev = d.get("evidence") or {}
    val = d.get("validator") or {}
    ver = d.get("version") or {}
    syn = d.get("synchrony") or {}
    feat = d.get("feature") or {}
    dflt = ConsensusParams()
    return ConsensusParams(
        block=BlockParams(
            max_bytes=int(blk.get("max_bytes", dflt.block.max_bytes)),
            max_gas=int(blk.get("max_gas", dflt.block.max_gas))),
        evidence=EvidenceParams(
            max_age_num_blocks=int(ev.get(
                "max_age_num_blocks", dflt.evidence.max_age_num_blocks)),
            max_age_duration_ns=int(ev.get(
                "max_age_duration", dflt.evidence.max_age_duration_ns)),
            max_bytes=int(ev.get("max_bytes", dflt.evidence.max_bytes))),
        validator=ValidatorParams(pub_key_types=list(
            val.get("pub_key_types", dflt.validator.pub_key_types))),
        version=VersionParams(app=int(ver.get("app", 0))),
        synchrony=SynchronyParams(
            precision_ns=int(syn.get(
                "precision", dflt.synchrony.precision_ns)),
            message_delay_ns=int(syn.get(
                "message_delay", dflt.synchrony.message_delay_ns))),
        feature=FeatureParams(
            vote_extensions_enable_height=int(feat.get(
                "vote_extensions_enable_height", 0)),
            pbts_enable_height=int(feat.get("pbts_enable_height", 0)),
            aggregate_commit_enable_height=int(feat.get(
                "aggregate_commit_enable_height", 0))),
    )
