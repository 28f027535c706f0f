"""Consensus messages (gossip + WAL payloads).

Reference: internal/consensus/msgs.go — ProposalMessage, BlockPartMessage,
VoteMessage, NewRoundStepMessage, NewValidBlockMessage, HasVoteMessage,
VoteSetMaj23Message, VoteSetBitsMessage, ProposalPOLMessage.

WAL/JSON codec: proto-shaped dicts with bytes hex-tagged, so records are
self-describing and durable across code changes.

The port's copy of cometbft_tpu/consensus/messages.py: every kind, the
WAL form and the p2p codec give the JAX package's bytes, so either side
decodes the other's.
"""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Optional

from ..libs.bits import BitArray
from ..types.block_id import BlockID
from ..types.part_set import Part
from ..types.proposal import Proposal
from ..types.vote import Vote


def jsonify(obj: Any) -> Any:
    """Nested proto-dict → JSON-safe (bytes → {"__b": hex})."""
    if isinstance(obj, (bytes, bytearray)):
        return {"__b": bytes(obj).hex()}
    if isinstance(obj, dict):
        return {k: jsonify(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [jsonify(v) for v in obj]
    return obj


def dejsonify(obj: Any) -> Any:
    if isinstance(obj, dict):
        if set(obj.keys()) == {"__b"}:
            return bytes.fromhex(obj["__b"])
        return {k: dejsonify(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [dejsonify(v) for v in obj]
    return obj


@dataclass
class ProposalMessage:
    proposal: Proposal

    TYPE = "proposal"

    def to_wal(self) -> dict:
        return {"type": self.TYPE,
                "proposal": jsonify(self.proposal.to_proto())}


@dataclass
class BlockPartMessage:
    height: int
    round: int
    part: Part

    TYPE = "block_part"

    def to_wal(self) -> dict:
        return {"type": self.TYPE, "height": self.height,
                "round": self.round,
                "part": jsonify(self.part.to_proto())}


@dataclass
class VoteMessage:
    vote: Vote

    TYPE = "vote"

    def to_wal(self) -> dict:
        return {"type": self.TYPE, "vote": jsonify(self.vote.to_proto())}


@dataclass
class NewRoundStepMessage:
    height: int
    round: int
    step: int
    seconds_since_start_time: int = 0
    last_commit_round: int = -1

    TYPE = "new_round_step"


@dataclass
class NewValidBlockMessage:
    height: int
    round: int
    block_part_set_header: object = None   # PartSetHeader
    block_parts: Optional[BitArray] = None
    is_commit: bool = False

    TYPE = "new_valid_block"


@dataclass
class HasVoteMessage:
    height: int
    round: int
    type: int
    index: int

    TYPE = "has_vote"


@dataclass
class VoteSetMaj23Message:
    height: int
    round: int
    type: int
    block_id: BlockID = field(default_factory=BlockID)

    TYPE = "vote_set_maj23"


@dataclass
class VoteSetBitsMessage:
    height: int
    round: int
    type: int
    block_id: BlockID = field(default_factory=BlockID)
    votes: Optional[BitArray] = None

    TYPE = "vote_set_bits"


@dataclass
class ProposalPOLMessage:
    height: int
    proposal_pol_round: int
    proposal_pol: Optional[BitArray] = None

    TYPE = "proposal_pol"


@dataclass
class HasProposalBlockPartMessage:
    height: int
    round: int
    index: int

    TYPE = "has_proposal_block_part"


FEATURE_COMPACT_BLOCKS = "compactblocks/1"
FEATURE_VOTE_BATCH = "votebatch/1"
# can parse AggregateCommit wire arms (blocks/signed headers of
# chains past feature.aggregate_commit_enable_height).  Advertised
# whenever the software supports it; on an aggregate-commit chain the
# consensus reactor refuses peers that do not advertise it — they
# cannot decode the chain's blocks (docs/aggregate_commits.md).
# Ed25519 chains ignore it entirely; compatible_with is unchanged.
FEATURE_AGG_COMMIT = "aggcommit/1"

# below this many txs the compact form saves almost nothing over the
# single part it replaces, and the reconstruct round trip only adds
# latency risk — small proposals always go out as full parts
COMPACT_MIN_TXS = 8


@dataclass
class CompactBlockPartMessage:
    """The whole proposal as skeleton + ordered tx hashes
    (docs/gossip.md): ``skeleton`` is the block's canonical proto
    encoding with ``data.txs`` emptied, ``tx_hashes`` the
    concatenated 32-byte tx keys in block order.  A receiver that
    holds every tx rebuilds the byte-identical part set
    (``reconstruct_block_bytes``) and never needs the full
    BlockPartMessages; one that doesn't falls back to the existing
    part gossip.  Never written to the WAL — the reconstructed parts
    are fed through the normal BlockPartMessage path, so replay sees
    exactly what a full-part peer would have logged."""
    height: int
    round: int
    part_set_header: object        # PartSetHeader
    skeleton: bytes
    tx_hashes: list                # list[bytes], 32 bytes each

    TYPE = "compact_block"


@dataclass
class CompactBlockNackMessage:
    """Receiver-driven fallback: reconstruction failed (missing txs,
    header mismatch), cancel the grace window and push full parts
    immediately."""
    height: int
    round: int

    TYPE = "compact_block_nack"


@dataclass
class VoteBatchMessage:
    votes: list                    # list[Vote]

    TYPE = "vote_batch"


@dataclass
class AggregateCommitMessage:
    """Catchup on an aggregate-commit chain: the stored commit for a
    lagging peer's height is ONE aggregate signature + signer bitmap,
    so individual precommit votes cannot be reconstructed and gossiped
    — the aggregate itself is shipped instead and injected as the
    height's +2/3 precommit evidence after verification
    (docs/aggregate_commits.md).  WAL'd like a vote: replay re-verifies
    and re-injects it."""
    commit: object                 # types.commit.AggregateCommit

    TYPE = "aggregate_commit"

    def to_wal(self) -> dict:
        return {"type": self.TYPE,
                "commit": jsonify(self.commit.to_proto())}


def make_compact_block(height: int, round_: int, block,
                       part_set_header) -> CompactBlockPartMessage:
    """Build the compact form from a complete proposal block."""
    from ..types.tx import tx_key
    d = block.to_proto()
    data = dict(d.get("data") or {})
    data.pop("txs", None)
    d["data"] = data
    from ..wire import pb, encode
    return CompactBlockPartMessage(
        height=height, round=round_,
        part_set_header=part_set_header,
        skeleton=encode(pb.BLOCK, d),
        tx_hashes=[tx_key(tx) for tx in block.data.txs])


def reconstruct_block_bytes(skeleton: bytes, txs: list) -> bytes:
    """Splice resolved txs back into the skeleton and re-encode.
    The wire codec is canonical (ascending field order, proto3 zero
    omission), so the result is byte-identical to the proposer's
    ``Block.make_part_set`` input whenever the txs match."""
    from ..wire import pb, decode, encode
    d = decode(pb.BLOCK, skeleton)
    data = dict(d.get("data") or {})
    data["txs"] = list(txs)
    d["data"] = data
    return encode(pb.BLOCK, d)


def message_from_wal(d: dict):
    """Decode a WAL msg record back into a message object."""
    t = d.get("type")
    if t == ProposalMessage.TYPE:
        return ProposalMessage(
            Proposal.from_proto(dejsonify(d["proposal"])))
    if t == BlockPartMessage.TYPE:
        return BlockPartMessage(
            height=d["height"], round=d["round"],
            part=Part.from_proto(dejsonify(d["part"])))
    if t == VoteMessage.TYPE:
        return VoteMessage(Vote.from_proto(dejsonify(d["vote"])))
    if t == AggregateCommitMessage.TYPE:
        from ..types.commit import AggregateCommit
        return AggregateCommitMessage(
            AggregateCommit.from_proto(dejsonify(d["commit"])))
    raise ValueError(f"unknown WAL message type {t!r}")


# ---------------------------------------------------------------------------
# p2p wire codec (reference: internal/consensus/msgs.go MsgToProto /
# MsgFromProto over cometbft.consensus.v2.Message)

def encode_p2p(msg) -> bytes:
    from ..wire import consensus_pb, encode
    from ..types.part_set import PartSetHeader

    if isinstance(msg, ProposalMessage):
        d = {"proposal": {"proposal": msg.proposal.to_proto()}}
    elif isinstance(msg, BlockPartMessage):
        d = {"block_part": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {}),
            "part": msg.part.to_proto()}}
    elif isinstance(msg, VoteMessage):
        d = {"vote": {"vote": msg.vote.to_proto()}}
    elif isinstance(msg, NewRoundStepMessage):
        d = {"new_round_step": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {}),
            **({"step": msg.step} if msg.step else {}),
            **({"seconds_since_start_time":
                msg.seconds_since_start_time}
               if msg.seconds_since_start_time else {}),
            **({"last_commit_round": msg.last_commit_round}
               if msg.last_commit_round else {})}}
    elif isinstance(msg, NewValidBlockMessage):
        d = {"new_valid_block": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {}),
            "block_part_set_header":
                msg.block_part_set_header.to_proto(),
            **({"block_parts": msg.block_parts.to_proto()}
               if msg.block_parts is not None else {}),
            **({"is_commit": True} if msg.is_commit else {})}}
    elif isinstance(msg, HasVoteMessage):
        d = {"has_vote": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {}),
            **({"type": msg.type} if msg.type else {}),
            **({"index": msg.index} if msg.index else {})}}
    elif isinstance(msg, VoteSetMaj23Message):
        d = {"vote_set_maj23": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {}),
            **({"type": msg.type} if msg.type else {}),
            "block_id": msg.block_id.to_proto()}}
    elif isinstance(msg, VoteSetBitsMessage):
        d = {"vote_set_bits": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {}),
            **({"type": msg.type} if msg.type else {}),
            "block_id": msg.block_id.to_proto(),
            "votes": msg.votes.to_proto() if msg.votes is not None
            else {}}}
    elif isinstance(msg, ProposalPOLMessage):
        d = {"proposal_pol": {
            **({"height": msg.height} if msg.height else {}),
            **({"proposal_pol_round": msg.proposal_pol_round}
               if msg.proposal_pol_round else {}),
            "proposal_pol": msg.proposal_pol.to_proto()
            if msg.proposal_pol is not None else {}}}
    elif isinstance(msg, HasProposalBlockPartMessage):
        d = {"has_proposal_block_part": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {}),
            **({"index": msg.index} if msg.index else {})}}
    elif isinstance(msg, CompactBlockPartMessage):
        d = {"compact_block": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {}),
            "part_set_header": msg.part_set_header.to_proto(),
            "skeleton": msg.skeleton,
            "tx_hashes": b"".join(msg.tx_hashes)}}
    elif isinstance(msg, CompactBlockNackMessage):
        d = {"compact_block_nack": {
            **({"height": msg.height} if msg.height else {}),
            **({"round": msg.round} if msg.round else {})}}
    elif isinstance(msg, VoteBatchMessage):
        d = {"vote_batch": {
            "votes": [v.to_proto() for v in msg.votes]}}
    elif isinstance(msg, AggregateCommitMessage):
        d = {"aggregate_commit": {"commit": msg.commit.to_proto()}}
    else:
        raise ValueError(f"cannot encode message {type(msg)}")
    return encode(consensus_pb.MESSAGE, d)


def decode_p2p(raw: bytes):
    from ..wire import consensus_pb, decode
    from ..libs.bits import BitArray
    from ..types.block_id import BlockID
    from ..types.part_set import Part, PartSetHeader

    d = decode(consensus_pb.MESSAGE, raw)
    if "proposal" in d:
        return ProposalMessage(Proposal.from_proto(
            d["proposal"].get("proposal") or {}))
    if "block_part" in d:
        bp = d["block_part"]
        return BlockPartMessage(
            height=bp.get("height", 0), round=bp.get("round", 0),
            part=Part.from_proto(bp.get("part") or {}))
    if "vote" in d:
        return VoteMessage(Vote.from_proto(
            d["vote"].get("vote") or {}))
    if "new_round_step" in d:
        n = d["new_round_step"]
        return NewRoundStepMessage(
            height=n.get("height", 0), round=n.get("round", 0),
            step=n.get("step", 0),
            seconds_since_start_time=n.get(
                "seconds_since_start_time", 0),
            last_commit_round=n.get("last_commit_round", 0))
    if "new_valid_block" in d:
        n = d["new_valid_block"]
        return NewValidBlockMessage(
            height=n.get("height", 0), round=n.get("round", 0),
            block_part_set_header=PartSetHeader.from_proto(
                n.get("block_part_set_header") or {}),
            block_parts=BitArray.from_proto(n["block_parts"])
            if n.get("block_parts") is not None else None,
            is_commit=n.get("is_commit", False))
    if "has_vote" in d:
        n = d["has_vote"]
        return HasVoteMessage(height=n.get("height", 0),
                              round=n.get("round", 0),
                              type=n.get("type", 0),
                              index=n.get("index", 0))
    if "vote_set_maj23" in d:
        n = d["vote_set_maj23"]
        return VoteSetMaj23Message(
            height=n.get("height", 0), round=n.get("round", 0),
            type=n.get("type", 0),
            block_id=BlockID.from_proto(n.get("block_id") or {}))
    if "vote_set_bits" in d:
        n = d["vote_set_bits"]
        return VoteSetBitsMessage(
            height=n.get("height", 0), round=n.get("round", 0),
            type=n.get("type", 0),
            block_id=BlockID.from_proto(n.get("block_id") or {}),
            votes=BitArray.from_proto(n.get("votes") or {}))
    if "proposal_pol" in d:
        n = d["proposal_pol"]
        return ProposalPOLMessage(
            height=n.get("height", 0),
            proposal_pol_round=n.get("proposal_pol_round", 0),
            proposal_pol=BitArray.from_proto(
                n.get("proposal_pol") or {}))
    if "has_proposal_block_part" in d:
        n = d["has_proposal_block_part"]
        return HasProposalBlockPartMessage(
            height=n.get("height", 0), round=n.get("round", 0),
            index=n.get("index", 0))
    if "compact_block" in d:
        n = d["compact_block"]
        blob = n.get("tx_hashes", b"")
        return CompactBlockPartMessage(
            height=n.get("height", 0), round=n.get("round", 0),
            part_set_header=PartSetHeader.from_proto(
                n.get("part_set_header") or {}),
            skeleton=n.get("skeleton", b""),
            tx_hashes=[blob[i:i + 32]
                       for i in range(0, len(blob) - 31, 32)])
    if "compact_block_nack" in d:
        n = d["compact_block_nack"]
        return CompactBlockNackMessage(height=n.get("height", 0),
                                       round=n.get("round", 0))
    if "vote_batch" in d:
        return VoteBatchMessage(
            votes=[Vote.from_proto(v)
                   for v in d["vote_batch"].get("votes", [])])
    if "aggregate_commit" in d:
        from ..types.commit import AggregateCommit
        return AggregateCommitMessage(AggregateCommit.from_proto(
            d["aggregate_commit"].get("commit") or {}))
    raise ValueError(f"unknown consensus message {sorted(d)}")
