"""Header, Data, Block, BlockMeta, SignedHeader and LightBlock.

Reference: types/block.go — Header.Hash is a merkle root over the 14
field encodings (:446), Block.Hash = Header.Hash, the block's part set
for gossip and storage, SignedHeader and LightBlock with their
ValidateBasic, through cometbft_tpu/types/block.py:26-434.  The hash
must equal the reference's byte for byte: the string, int64 and bytes
fields are wrapped as gogotypes values (cdcEncode, empty input -> empty
leaf), the version, time and last block id encode as messages (a zero
BlockID and Go's zero time included).
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from .. import version as _version
from ..crypto import merkle, tmhash
from ..wire import decode, encode, pb
from .block_id import BlockID
from .commit import AggregateCommit, Commit, CommitError
from .part_set import BLOCK_PART_SIZE, PartSet, PartSetHeader
from .timestamp import Timestamp
from .tx import txs_hash
from .validator_set import ValidatorSet

MAX_CHAIN_ID_LEN = 50
# MaxHeaderBytes / MaxOverheadForBlock (reference: types/block.go)
MAX_HEADER_BYTES = 626
MAX_OVERHEAD_FOR_BLOCK = 11


class BlockError(Exception):
    pass


def validate_hash(h: bytes) -> None:
    """Reference: types/validation.go ValidateHash — empty or
    tmhash-sized."""
    if h and len(h) != tmhash.SIZE:
        raise BlockError(
            f"expected size to be {tmhash.SIZE} bytes, got {len(h)} bytes")


def _cdc_bytes(b: bytes) -> bytes:
    """gogotypes.BytesValue wrapping (reference: encoding_helper.go
    cdcEncode); empty input -> empty encoding."""
    if not b:
        return b""
    return encode(pb.BYTES_VALUE, {"value": b})


def _cdc_string(s: str) -> bytes:
    if not s:
        return b""
    return encode(pb.STRING_VALUE, {"value": s})


def _cdc_int64(i: int) -> bytes:
    if not i:
        return b""
    return encode(pb.INT64_VALUE, {"value": i})


_HASH_FIELDS = ("last_commit_hash", "data_hash", "validators_hash",
                "next_validators_hash", "consensus_hash", "app_hash",
                "last_results_hash", "evidence_hash", "proposer_address")


@dataclass(frozen=True)
class ConsensusVersion:
    block: int = _version.BLOCK_PROTOCOL
    app: int = 0

    def to_proto(self) -> dict:
        d: dict = {}
        if self.block:
            d["block"] = self.block
        if self.app:
            d["app"] = self.app
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "ConsensusVersion":
        return cls(block=d.get("block", 0), app=d.get("app", 0))


@dataclass
class Header:
    version: ConsensusVersion = field(default_factory=ConsensusVersion)
    chain_id: str = ""
    height: int = 0
    time: Timestamp = field(default_factory=Timestamp.zero)
    last_block_id: BlockID = field(default_factory=BlockID)
    last_commit_hash: bytes = b""
    data_hash: bytes = b""
    validators_hash: bytes = b""
    next_validators_hash: bytes = b""
    consensus_hash: bytes = b""
    app_hash: bytes = b""
    last_results_hash: bytes = b""
    evidence_hash: bytes = b""
    proposer_address: bytes = b""

    def hash(self) -> bytes:
        """Merkle root over the 14 encoded fields (reference: block.go:446).

        Returns b"" when the header is incomplete (no ValidatorsHash)."""
        if not self.validators_hash:
            return b""
        leaves = [
            encode(pb.CONSENSUS_VERSION, self.version.to_proto()),
            _cdc_string(self.chain_id),
            _cdc_int64(self.height),
            encode(pb.TIMESTAMP, self.time.to_proto()),
            encode(pb.BLOCK_ID, self.last_block_id.to_proto()),
        ]
        leaves += [_cdc_bytes(getattr(self, name)) for name in _HASH_FIELDS]
        return merkle.hash_from_byte_slices(leaves)

    def validate_basic(self) -> None:
        if self.version.block != _version.BLOCK_PROTOCOL:
            raise BlockError(
                f"block protocol is incorrect: got {self.version.block}, "
                f"want {_version.BLOCK_PROTOCOL}")
        if len(self.chain_id) > MAX_CHAIN_ID_LEN:
            raise BlockError("chainID is too long")
        if self.height < 0:
            raise BlockError("negative Height")
        if self.height == 0:
            raise BlockError("zero Height")
        self.last_block_id.validate_basic()
        validate_hash(self.last_commit_hash)
        validate_hash(self.data_hash)
        validate_hash(self.evidence_hash)
        if len(self.proposer_address) != 20:
            raise BlockError("invalid ProposerAddress length")
        validate_hash(self.validators_hash)
        validate_hash(self.next_validators_hash)
        validate_hash(self.consensus_hash)
        validate_hash(self.last_results_hash)

    def to_proto(self) -> dict:
        d: dict = {
            "version": self.version.to_proto(),
            "time": self.time.to_proto(),
            "last_block_id": self.last_block_id.to_proto(),
        }
        if self.chain_id:
            d["chain_id"] = self.chain_id
        if self.height:
            d["height"] = self.height
        for name in _HASH_FIELDS:
            v = getattr(self, name)
            if v:
                d[name] = v
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "Header":
        return cls(
            version=ConsensusVersion.from_proto(d.get("version") or {}),
            chain_id=d.get("chain_id", ""),
            height=d.get("height", 0),
            time=Timestamp.from_proto(d.get("time") or {}),
            last_block_id=BlockID.from_proto(d.get("last_block_id") or {}),
            **{name: d.get(name, b"") for name in _HASH_FIELDS},
        )


@dataclass
class Data:
    txs: list[bytes] = field(default_factory=list)
    _hash: Optional[bytes] = field(default=None, repr=False, compare=False)

    def hash(self) -> bytes:
        if self._hash is None:
            self._hash = txs_hash(self.txs)
        return self._hash

    def to_proto(self) -> dict:
        return {"txs": list(self.txs)} if self.txs else {}

    @classmethod
    def from_proto(cls, d: dict) -> "Data":
        return cls(txs=list(d.get("txs", [])))


@dataclass
class Block:
    header: Header = field(default_factory=Header)
    data: Data = field(default_factory=Data)
    evidence: list = field(default_factory=list)  # list[Evidence]
    # a per-signature Commit, or an AggregateCommit past the aggregate-
    # commit enable height
    last_commit: Commit | AggregateCommit | None = None

    def hash(self) -> bytes:
        return self.header.hash()

    def block_id(self, part_set_header: PartSetHeader) -> BlockID:
        return BlockID(hash=self.hash(), part_set_header=part_set_header)

    def make_part_set(self, part_size: int | None = None) -> PartSet:
        raw = encode(pb.BLOCK, self.to_proto())
        return PartSet.from_data(raw, part_size or BLOCK_PART_SIZE)

    def evidence_hash(self) -> bytes:
        return merkle.hash_from_byte_slices(
            [ev.bytes() for ev in self.evidence])

    def fill_header(self) -> None:
        """Derive LastCommitHash, DataHash and EvidenceHash (reference:
        block.go fillHeader)."""
        if not self.header.last_commit_hash and self.last_commit:
            self.header.last_commit_hash = self.last_commit.hash()
        if not self.header.data_hash:
            self.header.data_hash = self.data.hash()
        if not self.header.evidence_hash:
            self.header.evidence_hash = self.evidence_hash()

    def validate_basic(self) -> None:
        """Reference: block.go Block.ValidateBasic."""
        self.header.validate_basic()
        if self.last_commit is None:
            if self.header.height != 1:
                raise BlockError("nil LastCommit")
        else:
            try:
                self.last_commit.validate_basic()
            except CommitError as e:
                raise BlockError(f"wrong LastCommit: {e}") from e
            if self.header.last_commit_hash != self.last_commit.hash():
                raise BlockError("wrong LastCommitHash")
        if self.header.data_hash != self.data.hash():
            raise BlockError("wrong DataHash")
        if self.header.evidence_hash != self.evidence_hash():
            raise BlockError("wrong EvidenceHash")

    def to_proto(self) -> dict:
        d: dict = {
            "header": self.header.to_proto(),
            "data": self.data.to_proto(),
            "evidence": {"evidence": [ev.to_proto_wrapped()
                                      for ev in self.evidence]}
            if self.evidence else {},
        }
        if isinstance(self.last_commit, AggregateCommit):
            d["last_aggregate_commit"] = self.last_commit.to_proto()
        elif self.last_commit is not None:
            d["last_commit"] = self.last_commit.to_proto()
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "Block":
        # evidence.py imports LightBlock from here
        from .evidence import evidence_from_proto_wrapped
        lc = d.get("last_commit")
        lac = d.get("last_aggregate_commit")
        if lc is not None and lac is not None:
            raise BlockError(
                "block carries both per-signature and aggregate "
                "LastCommit")
        last_commit: Commit | AggregateCommit | None = None
        if lc is not None:
            last_commit = Commit.from_proto(lc)
        elif lac is not None:
            last_commit = AggregateCommit.from_proto(lac)
        return cls(
            header=Header.from_proto(d.get("header") or {}),
            data=Data.from_proto(d.get("data") or {}),
            evidence=[evidence_from_proto_wrapped(e)
                      for e in (d.get("evidence") or {}).get("evidence",
                                                             [])],
            last_commit=last_commit,
        )

    @classmethod
    def from_parts(cls, ps: PartSet) -> "Block":
        return cls.from_proto(decode(pb.BLOCK, ps.assemble()))

    def __str__(self) -> str:
        return (f"Block{{H:{self.header.height} "
                f"#{self.hash().hex().upper()[:12]} "
                f"txs:{len(self.data.txs)}}}")


@dataclass
class SignedHeader:
    header: Optional[Header] = None
    # a per-signature Commit or an AggregateCommit
    commit: Commit | AggregateCommit | None = None

    def validate_basic(self, chain_id: str) -> None:
        """Reference: block.go SignedHeader.ValidateBasic."""
        if self.header is None:
            raise BlockError("missing header")
        if self.commit is None:
            raise BlockError("missing commit")
        self.header.validate_basic()
        if self.header.chain_id != chain_id:
            raise BlockError(
                f"header belongs to another chain {self.header.chain_id!r}")
        self.commit.validate_basic()
        if self.header.height != self.commit.height:
            raise BlockError("header and commit height mismatch")
        if self.header.hash() != self.commit.block_id.hash:
            raise BlockError("commit signs block which differs from header")

    @property
    def height(self) -> int:
        return self.header.height if self.header else 0

    def to_proto(self) -> dict:
        d: dict = {}
        if self.header is not None:
            d["header"] = self.header.to_proto()
        if isinstance(self.commit, AggregateCommit):
            d["aggregate_commit"] = self.commit.to_proto()
        elif self.commit is not None:
            d["commit"] = self.commit.to_proto()
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "SignedHeader":
        h, c = d.get("header"), d.get("commit")
        ac = d.get("aggregate_commit")
        if c is not None and ac is not None:
            raise BlockError(
                "signed header carries both per-signature and "
                "aggregate commit")
        commit: Commit | AggregateCommit | None = None
        if c is not None:
            commit = Commit.from_proto(c)
        elif ac is not None:
            commit = AggregateCommit.from_proto(ac)
        return cls(
            header=Header.from_proto(h) if h is not None else None,
            commit=commit,
        )


@dataclass
class LightBlock:
    signed_header: Optional[SignedHeader] = None
    validator_set: Optional[ValidatorSet] = None

    def validate_basic(self, chain_id: str) -> None:
        if self.signed_header is None:
            raise BlockError("missing signed header")
        if self.validator_set is None:
            raise BlockError("missing validator set")
        self.signed_header.validate_basic(chain_id)
        self.validator_set.validate_basic()
        if self.signed_header.header.validators_hash != \
                self.validator_set.hash():
            raise BlockError("validator set hash mismatch with header")

    @property
    def height(self) -> int:
        return self.signed_header.height if self.signed_header else 0

    def hash(self) -> bytes:
        return self.signed_header.header.hash() if (
            self.signed_header and self.signed_header.header) else b""

    def to_proto(self) -> dict:
        d: dict = {}
        if self.signed_header is not None:
            d["signed_header"] = self.signed_header.to_proto()
        if self.validator_set is not None:
            d["validator_set"] = self.validator_set.to_proto()
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "LightBlock":
        sh, vs = d.get("signed_header"), d.get("validator_set")
        return cls(
            signed_header=SignedHeader.from_proto(sh)
            if sh is not None else None,
            validator_set=ValidatorSet.from_proto(vs)
            if vs is not None else None,
        )


@dataclass
class BlockMeta:
    block_id: BlockID = field(default_factory=BlockID)
    block_size: int = 0
    header: Header = field(default_factory=Header)
    num_txs: int = 0

    def to_proto(self) -> dict:
        d: dict = {"block_id": self.block_id.to_proto(),
                   "header": self.header.to_proto()}
        if self.block_size:
            d["block_size"] = self.block_size
        if self.num_txs:
            d["num_txs"] = self.num_txs
        return d

    @classmethod
    def from_proto(cls, d: dict) -> "BlockMeta":
        return cls(
            block_id=BlockID.from_proto(d.get("block_id") or {}),
            block_size=d.get("block_size", 0),
            header=Header.from_proto(d.get("header") or {}),
            num_txs=d.get("num_txs", 0),
        )


def make_block(height: int, txs: list[bytes], last_commit: Commit,
               evidence: list) -> Block:
    """Reference: block.go MakeBlock."""
    b = Block(
        header=Header(height=height),
        data=Data(txs=txs),
        evidence=list(evidence),
        last_commit=last_commit,
    )
    b.fill_header()
    return b
