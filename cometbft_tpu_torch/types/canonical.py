"""Canonical sign-bytes: the exact bytes validators sign.

Reference: types/canonical.go + proto/cometbft/types/v2/canonical.proto.
Height/round are sfixed64 (fixed-size for canonicalization); the BlockID is
dropped entirely for nil votes; sign-bytes are uvarint-length-delimited
(libs/protoio MarshalDelimited).
"""
from __future__ import annotations

from ..wire import pb, marshal_delimited
from ..wire.proto import Msg, encode, encode_uvarint
from .block_id import BlockID
from .timestamp import Timestamp

# SignedMsgType (proto/cometbft/types/v2/types.proto)
UNKNOWN_TYPE = 0
PREVOTE_TYPE = 1
PRECOMMIT_TYPE = 2
PROPOSAL_TYPE = 32


def is_vote_type_valid(t: int) -> bool:
    return t in (PREVOTE_TYPE, PRECOMMIT_TYPE)


def canonicalize_block_id(bid: BlockID) -> dict | None:
    """nil → None (field omitted from sign-bytes); else CanonicalBlockID."""
    if bid.is_nil():
        return None
    d: dict = {"part_set_header": bid.part_set_header.to_proto()}
    if bid.hash:
        d["hash"] = bid.hash
    return d


def _canonical_vote(chain_id: str, type_: int, height: int, round_: int,
                    bid: BlockID, ts: Timestamp) -> dict:
    d: dict = {"timestamp": ts.to_proto()}
    if type_:
        d["type"] = type_
    if height:
        d["height"] = height
    if round_:
        d["round"] = round_
    cbid = canonicalize_block_id(bid)
    if cbid is not None:
        d["block_id"] = cbid
    if chain_id:
        d["chain_id"] = chain_id
    return d


def vote_sign_bytes(chain_id: str, type_: int, height: int, round_: int,
                    bid: BlockID, ts: Timestamp) -> bytes:
    """Reference: types/vote.go VoteSignBytes."""
    return marshal_delimited(
        pb.CANONICAL_VOTE,
        _canonical_vote(chain_id, type_, height, round_, bid, ts))


def _split_canonical_vote_desc():
    """CANONICAL_VOTE split at the timestamp field.  Split descriptors
    (not dict filtering) because timestamp is always=True — encoding
    the full descriptor with the field unset would still emit an empty
    timestamp submessage into the wrong half."""
    fields = pb.CANONICAL_VOTE.fields
    if [f.name for f in fields] != \
            ["type", "height", "round", "block_id", "timestamp",
             "chain_id"]:
        # explicit (not assert): must fail fast even under python -O —
        # a drifted descriptor would otherwise emit wrong sign bytes
        raise ValueError("CANONICAL_VOTE field layout drifted; "
                         "fix the template split")
    pre = Msg(pb.CANONICAL_VOTE.name + ".pre", *fields[:4])
    ts = Msg(pb.CANONICAL_VOTE.name + ".ts", fields[4])
    suf = Msg(pb.CANONICAL_VOTE.name + ".suf", fields[5])
    return pre, ts, suf


_CV_SPLIT = _split_canonical_vote_desc()


def vote_sign_bytes_template(chain_id: str, type_: int, height: int,
                             round_: int, bid: BlockID):
    """Returns make(ts) -> the same bytes as vote_sign_bytes for that
    timestamp.  Canonical proto fields marshal in field-number order
    (type=1, height=2, round=3, block_id=4, timestamp=5, chain_id=6),
    so everything except the timestamp field marshals ONCE and each
    vote splices its own timestamp between the two halves — a commit's
    votes share every signed field but the timestamp."""
    pre_desc, ts_desc, suf_desc = _CV_SPLIT
    d = _canonical_vote(chain_id, type_, height, round_, bid,
                        Timestamp(0, 0))
    d.pop("timestamp")
    pre = encode(pre_desc, d)
    suf = encode(suf_desc, d)

    def make(ts: Timestamp) -> bytes:
        mid = encode(ts_desc, {"timestamp": ts.to_proto()})
        body_len = len(pre) + len(mid) + len(suf)
        return encode_uvarint(body_len) + pre + mid + suf

    return make


def vote_extension_sign_bytes(chain_id: str, height: int, round_: int,
                              extension: bytes) -> bytes:
    """Reference: types/vote.go VoteExtensionSignBytes."""
    d: dict = {}
    if extension:
        d["extension"] = extension
    if height:
        d["height"] = height
    if round_:
        d["round"] = round_
    if chain_id:
        d["chain_id"] = chain_id
    return marshal_delimited(pb.CANONICAL_VOTE_EXTENSION, d)


def proposal_sign_bytes(chain_id: str, height: int, round_: int,
                        pol_round: int, bid: BlockID,
                        ts: Timestamp) -> bytes:
    """Reference: types/proposal.go ProposalSignBytes."""
    d: dict = {"type": PROPOSAL_TYPE, "timestamp": ts.to_proto()}
    if height:
        d["height"] = height
    if round_:
        d["round"] = round_
    if pol_round:
        d["pol_round"] = pol_round
    cbid = canonicalize_block_id(bid)
    if cbid is not None:
        d["block_id"] = cbid
    if chain_id:
        d["chain_id"] = chain_id
    return marshal_delimited(pb.CANONICAL_PROPOSAL, d)
