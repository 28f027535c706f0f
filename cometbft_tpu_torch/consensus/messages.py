"""Consensus gossip messages that carry votes, and their p2p wire codec.

Reference: internal/consensus/msgs.go (VoteMessage, MsgToProto /
MsgFromProto over cometbft.consensus.v2.Message), through
cometbft_tpu/consensus/messages.py — ``VoteMessage`` (:69-77),
``VoteBatchMessage`` (:198-201) and the ``vote`` / ``vote_batch`` arms of
``encode_p2p`` / ``decode_p2p`` (:274-285, :349, :359-447).  The bytes
are the JAX package's, so either side decodes the other's.

Every other message kind (proposal, block part, round step, has-vote,
maj23, bits, compact blocks, aggregate-commit catch-up) comes with the
consensus state machine, ROADMAP.md queue item A.7d; until then the
codec raises on it.  The WAL form (``to_wal``) comes with it too.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..types.vote import Vote
from ..wire import consensus_pb, decode, encode

_NOT_PORTED = ("is not ported yet: it comes with the consensus state "
               "machine (ROADMAP.md A.7d)")


@dataclass
class VoteMessage:
    vote: Vote

    TYPE = "vote"


@dataclass
class VoteBatchMessage:
    votes: list                    # list[Vote]

    TYPE = "vote_batch"


def encode_p2p(msg) -> bytes:
    """A VoteMessage or VoteBatchMessage -> its cometbft.consensus.v2
    Message bytes."""
    if isinstance(msg, VoteMessage):
        d = {"vote": {"vote": msg.vote.to_proto()}}
    elif isinstance(msg, VoteBatchMessage):
        d = {"vote_batch": {"votes": [v.to_proto() for v in msg.votes]}}
    else:
        raise ValueError(f"consensus message {type(msg).__name__} "
                         f"{_NOT_PORTED}")
    return encode(consensus_pb.MESSAGE, d)


def decode_p2p(raw: bytes):
    """cometbft.consensus.v2 Message bytes -> a VoteMessage or
    VoteBatchMessage; any other arm raises."""
    d = decode(consensus_pb.MESSAGE, raw)
    if "vote" in d:
        return VoteMessage(Vote.from_proto(d["vote"].get("vote") or {}))
    if "vote_batch" in d:
        return VoteBatchMessage(
            votes=[Vote.from_proto(v)
                   for v in d["vote_batch"].get("votes", [])])
    raise ValueError(f"consensus message without a vote or vote_batch arm "
                     f"{_NOT_PORTED}")
