"""On-chain consensus parameters.

Reference: types/params.go — ConsensusParams tree, defaults, Hash over
HashedParams, ValidateBasic, feature-height gates (vote extensions,
PBTS, aggregate commits) — through cometbft_tpu/types/params.py, whose
names, defaults and error texts this copy keeps.
"""
from __future__ import annotations

from dataclasses import dataclass, field, replace
from typing import Optional

from ..crypto import tmhash
from ..wire import pb, encode

MAX_BLOCK_SIZE_BYTES = 100 * 1024 * 1024
BLOCK_PART_SIZE_BYTES = 65536
MAX_BLOCK_PARTS_COUNT = MAX_BLOCK_SIZE_BYTES // BLOCK_PART_SIZE_BYTES + 1
ABCI_PUB_KEY_TYPE_ED25519 = "ed25519"

_NS_PER_MS = 1_000_000
_NS_PER_S = 1_000_000_000
MAX_MESSAGE_DELAY_NS = 24 * 3600 * _NS_PER_S
MAX_PRECISION_NS = 30 * _NS_PER_S


class ParamsError(Exception):
    pass


def _dur_proto(ns: int) -> dict:
    d: dict = {}
    s, rem = divmod(ns, _NS_PER_S)
    if s:
        d["seconds"] = s
    if rem:
        d["nanos"] = rem
    return d


def _dur_from_proto(d: dict) -> int:
    return d.get("seconds", 0) * _NS_PER_S + d.get("nanos", 0)


@dataclass
class BlockParams:
    max_bytes: int = 4194304   # 4 MB
    max_gas: int = 10_000_000

    def validate(self) -> None:
        if self.max_bytes == 0:
            raise ParamsError("block.MaxBytes cannot be 0")
        if self.max_bytes < -1:
            raise ParamsError("block.MaxBytes must be -1 or greater")
        if self.max_bytes > MAX_BLOCK_SIZE_BYTES:
            raise ParamsError(
                f"block.MaxBytes is too big, max {MAX_BLOCK_SIZE_BYTES}")
        if self.max_gas < -1:
            raise ParamsError("block.MaxGas must be -1 or greater")


@dataclass
class EvidenceParams:
    max_age_num_blocks: int = 100_000
    max_age_duration_ns: int = 48 * 3600 * _NS_PER_S
    max_bytes: int = 1_048_576

    def validate(self, block_max_bytes: int) -> None:
        if self.max_age_num_blocks <= 0:
            raise ParamsError("evidence.MaxAgeNumBlocks must be positive")
        if self.max_age_duration_ns <= 0:
            raise ParamsError("evidence.MaxAgeDuration must be positive")
        cap_ = block_max_bytes if block_max_bytes >= 0 \
            else MAX_BLOCK_SIZE_BYTES
        if self.max_bytes > cap_:
            raise ParamsError("evidence.MaxBytes exceeds block.MaxBytes")
        if self.max_bytes < 0:
            raise ParamsError("evidence.MaxBytes must be non-negative")


@dataclass
class ValidatorParams:
    pub_key_types: list[str] = field(
        default_factory=lambda: [ABCI_PUB_KEY_TYPE_ED25519])

    def validate(self) -> None:
        if not self.pub_key_types:
            raise ParamsError("validator.PubKeyTypes must not be empty")
        for t in self.pub_key_types:
            if t not in ("ed25519", "secp256k1", "bls12_381",
                         "secp256k1eth"):
                raise ParamsError(f"unknown pubkey type {t!r}")

    def is_valid_pub_key_type(self, key_type: str) -> bool:
        return key_type in self.pub_key_types


@dataclass
class VersionParams:
    app: int = 0


@dataclass
class SynchronyParams:
    precision_ns: int = 505 * _NS_PER_MS
    message_delay_ns: int = 15 * _NS_PER_S

    def validate(self) -> None:
        if self.precision_ns <= 0:
            raise ParamsError("synchrony.Precision must be positive")
        if self.message_delay_ns <= 0:
            raise ParamsError("synchrony.MessageDelay must be positive")
        if self.precision_ns > MAX_PRECISION_NS:
            raise ParamsError("synchrony.Precision too large")
        if self.message_delay_ns > MAX_MESSAGE_DELAY_NS:
            raise ParamsError("synchrony.MessageDelay too large")

    def in_round(self, round_: int) -> "SynchronyParams":
        """Adaptive per-round relaxation of PBTS bounds (reference:
        params.go SynchronyParams.InRound)."""
        delay = self.message_delay_ns
        for _ in range(round_):
            delay = delay * 110 // 100  # +10% per round
            if delay > MAX_MESSAGE_DELAY_NS:
                delay = MAX_MESSAGE_DELAY_NS
                break
        return SynchronyParams(self.precision_ns, delay)


@dataclass
class FeatureParams:
    vote_extensions_enable_height: int = 0
    pbts_enable_height: int = 0
    # the reference package's extension: commits for heights >= this
    # are one BLS aggregate signature + signer bitmap — O(1) pairing
    # verification in validator count.  Requires PBTS
    # (aggregate commits carry no per-vote timestamps, so BFT time's
    # weighted median is unavailable) and is incompatible with vote
    # extensions (per-validator extension signatures cannot be
    # aggregated into one shared-message signature).
    aggregate_commit_enable_height: int = 0

    def vote_extensions_enabled(self, height: int) -> bool:
        h = self.vote_extensions_enable_height
        return h > 0 and height >= h

    def pbts_enabled(self, height: int) -> bool:
        h = self.pbts_enable_height
        return h > 0 and height >= h

    def aggregate_commits_enabled(self, height: int) -> bool:
        """True when the commit FOR height must be the aggregate form."""
        h = self.aggregate_commit_enable_height
        return h > 0 and height >= h

    def validate(self) -> None:
        if self.vote_extensions_enable_height < 0:
            raise ParamsError(
                "feature.VoteExtensionsEnableHeight must be non-negative")
        if self.pbts_enable_height < 0:
            raise ParamsError(
                "feature.PbtsEnableHeight must be non-negative")
        agg = self.aggregate_commit_enable_height
        if agg < 0:
            raise ParamsError(
                "feature.AggregateCommitEnableHeight must be "
                "non-negative")
        if agg > 0:
            if not (0 < self.pbts_enable_height <= agg):
                raise ParamsError(
                    "feature.AggregateCommitEnableHeight requires PBTS "
                    "enabled at or before it (aggregate commits have "
                    "no per-vote timestamps for BFT time)")
            if self.vote_extensions_enable_height > 0:
                raise ParamsError(
                    "feature.AggregateCommitEnableHeight is "
                    "incompatible with vote extensions")


@dataclass
class ConsensusParams:
    block: BlockParams = field(default_factory=BlockParams)
    evidence: EvidenceParams = field(default_factory=EvidenceParams)
    validator: ValidatorParams = field(default_factory=ValidatorParams)
    version: VersionParams = field(default_factory=VersionParams)
    synchrony: SynchronyParams = field(default_factory=SynchronyParams)
    feature: FeatureParams = field(default_factory=FeatureParams)

    def validate_basic(self) -> None:
        self.block.validate()
        self.evidence.validate(self.block.max_bytes)
        self.validator.validate()
        self.synchrony.validate()
        self.feature.validate()
        if self.feature.aggregate_commit_enable_height > 0 and \
                self.validator.pub_key_types != ["bls12_381"]:
            # cross-struct check (FeatureParams.validate cannot see
            # validator params): a non-BLS signer would make every
            # post-enable proposal fail AggregateCommit.from_commit —
            # the chain halts with the root cause buried in logs.
            # Reject the misconfiguration at genesis/param-update
            # instead.
            raise ParamsError(
                "feature.AggregateCommitEnableHeight requires "
                "validator.PubKeyTypes == ['bls12_381']")

    def hash(self) -> bytes:
        """sha256 of HashedParams proto (reference: params.go:425)."""
        d: dict = {}
        if self.block.max_bytes:
            d["block_max_bytes"] = self.block.max_bytes
        if self.block.max_gas:
            d["block_max_gas"] = self.block.max_gas
        return tmhash.sum(encode(pb.HASHED_PARAMS, d))

    def update(self, updates: Optional["ConsensusParams"]) -> \
            "ConsensusParams":
        """Nil-aware merge: sub-structs the update leaves as None keep the
        current values (reference: params.go Update — only non-nil proto
        sub-messages are applied)."""
        if updates is None:
            return replace(self)

        def pick(new, cur):
            return replace(new) if new is not None else replace(cur)

        return ConsensusParams(
            block=pick(updates.block, self.block),
            evidence=pick(updates.evidence, self.evidence),
            validator=pick(updates.validator, self.validator),
            version=pick(updates.version, self.version),
            synchrony=pick(updates.synchrony, self.synchrony),
            feature=pick(updates.feature, self.feature),
        )

    def to_proto(self) -> dict:
        return {
            "block": {
                **({"max_bytes": self.block.max_bytes}
                   if self.block.max_bytes else {}),
                **({"max_gas": self.block.max_gas}
                   if self.block.max_gas else {}),
            },
            "evidence": {
                **({"max_age_num_blocks": self.evidence.max_age_num_blocks}
                   if self.evidence.max_age_num_blocks else {}),
                "max_age_duration": _dur_proto(
                    self.evidence.max_age_duration_ns),
                **({"max_bytes": self.evidence.max_bytes}
                   if self.evidence.max_bytes else {}),
            },
            "validator": {"pub_key_types": list(
                self.validator.pub_key_types)},
            "version": {**({"app": self.version.app}
                           if self.version.app else {})},
            "synchrony": {
                "precision": _dur_proto(self.synchrony.precision_ns),
                "message_delay": _dur_proto(
                    self.synchrony.message_delay_ns),
            },
            "feature": {
                **({"vote_extensions_enable_height":
                    {"value": self.feature.vote_extensions_enable_height}}
                   if self.feature.vote_extensions_enable_height else {}),
                **({"pbts_enable_height":
                    {"value": self.feature.pbts_enable_height}}
                   if self.feature.pbts_enable_height else {}),
                **({"aggregate_commit_enable_height":
                    {"value":
                     self.feature.aggregate_commit_enable_height}}
                   if self.feature.aggregate_commit_enable_height
                   else {}),
            },
        }

    @classmethod
    def from_proto(cls, d: dict) -> "ConsensusParams":
        blk = d.get("block") or {}
        ev = d.get("evidence") or {}
        val = d.get("validator") or {}
        ver = d.get("version") or {}
        syn = d.get("synchrony") or {}
        feat = d.get("feature") or {}
        return cls(
            block=BlockParams(max_bytes=blk.get("max_bytes", 0),
                              max_gas=blk.get("max_gas", 0)),
            evidence=EvidenceParams(
                max_age_num_blocks=ev.get("max_age_num_blocks", 0),
                max_age_duration_ns=_dur_from_proto(
                    ev.get("max_age_duration") or {}),
                max_bytes=ev.get("max_bytes", 0)),
            validator=ValidatorParams(
                pub_key_types=list(val.get("pub_key_types", []))),
            version=VersionParams(app=ver.get("app", 0)),
            synchrony=SynchronyParams(
                precision_ns=_dur_from_proto(syn.get("precision") or {}),
                message_delay_ns=_dur_from_proto(
                    syn.get("message_delay") or {})),
            feature=FeatureParams(
                vote_extensions_enable_height=(
                    feat.get("vote_extensions_enable_height") or {}
                ).get("value", 0),
                pbts_enable_height=(
                    feat.get("pbts_enable_height") or {}).get("value", 0),
                aggregate_commit_enable_height=(
                    feat.get("aggregate_commit_enable_height") or {}
                ).get("value", 0)),
        )


def default_consensus_params() -> ConsensusParams:
    return ConsensusParams()
