"""Wire descriptors for cometbft.consensus.v2 gossip messages.

Reference: proto/cometbft/consensus/v2/types.proto, through
cometbft_tpu/wire/consensus_pb.py: every message and the ``Message``
oneof with the same field numbers, so either package decodes the
other's bytes.
"""
from .proto import F, Msg
from .pb import (AGGREGATE_COMMIT, BLOCK_ID, PART, PART_SET_HEADER,
                 PROPOSAL, VOTE)

BIT_ARRAY = Msg(
    "cometbft.libs.bits.v1.BitArray",
    F(1, "bits", "int64"),
    F(2, "elems", "uint64", repeated=True),
)

NEW_ROUND_STEP = Msg(
    "cometbft.consensus.v2.NewRoundStep",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "step", "uint32"),
    F(4, "seconds_since_start_time", "int64"),
    F(5, "last_commit_round", "int32"),
)

NEW_VALID_BLOCK = Msg(
    "cometbft.consensus.v2.NewValidBlock",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "block_part_set_header", "msg", msg=PART_SET_HEADER,
      always=True),
    F(4, "block_parts", "msg", msg=BIT_ARRAY),
    F(5, "is_commit", "bool"),
)

PROPOSAL_MSG = Msg(
    "cometbft.consensus.v2.Proposal",
    F(1, "proposal", "msg", msg=PROPOSAL, always=True),
)

PROPOSAL_POL = Msg(
    "cometbft.consensus.v2.ProposalPOL",
    F(1, "height", "int64"),
    F(2, "proposal_pol_round", "int32"),
    F(3, "proposal_pol", "msg", msg=BIT_ARRAY, always=True),
)

BLOCK_PART = Msg(
    "cometbft.consensus.v2.BlockPart",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "part", "msg", msg=PART, always=True),
)

VOTE_MSG = Msg(
    "cometbft.consensus.v2.Vote",
    F(1, "vote", "msg", msg=VOTE),
)

HAS_VOTE = Msg(
    "cometbft.consensus.v2.HasVote",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "type", "enum"),
    F(4, "index", "int32"),
)

VOTE_SET_MAJ23 = Msg(
    "cometbft.consensus.v2.VoteSetMaj23",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "type", "enum"),
    F(4, "block_id", "msg", msg=BLOCK_ID, always=True),
)

VOTE_SET_BITS = Msg(
    "cometbft.consensus.v2.VoteSetBits",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "type", "enum"),
    F(4, "block_id", "msg", msg=BLOCK_ID, always=True),
    F(5, "votes", "msg", msg=BIT_ARRAY, always=True),
)

HAS_PROPOSAL_BLOCK_PART = Msg(
    "cometbft.consensus.v2.HasProposalBlockPart",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "index", "int32"),
)

# compact-block proposal relay (docs/gossip.md): the proposal as the
# block's proto bytes WITHOUT data.txs plus the ordered full tx
# hashes; receivers splice txs from their mempool, re-encode (the
# codec is canonical) and rebuild the identical part set.  Negotiated
# via the "compactblocks/1" handshake capability.
COMPACT_BLOCK = Msg(
    "cometbft.consensus.v2.CompactBlock",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "part_set_header", "msg", msg=PART_SET_HEADER, always=True),
    F(4, "skeleton", "bytes"),
    F(5, "tx_hashes", "bytes"),     # n * 32 bytes, block order
)

# receiver-driven fallback: "I could not rebuild your compact
# proposal — send full parts now".  Cancels the sender's grace
# window; without it a miss only falls back after the grace timer,
# which can outlive a whole round under aggressive timeouts.
COMPACT_BLOCK_NACK = Msg(
    "cometbft.consensus.v2.CompactBlockNack",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
)

# vote batching ("votebatch/1"): missing votes coalesced per wire
# message on the vote channel, like the mempool's tx batching
VOTE_BATCH = Msg(
    "cometbft.consensus.v2.VoteBatch",
    F(1, "votes", "msg", msg=VOTE, repeated=True),
)

# aggregate-commit catchup (docs/aggregate_commits.md): on an
# aggregate chain a lagging peer cannot be served reconstructed
# precommit votes — the stored commit is one aggregate signature —
# so the reactor ships the aggregate itself.  Only sent to peers
# that negotiated "aggcommit/1".
AGG_COMMIT_MSG = Msg(
    "cometbft.consensus.v2.AggregateCommitCatchup",
    F(1, "commit", "msg", msg=AGGREGATE_COMMIT, always=True),
)

MESSAGE = Msg(
    "cometbft.consensus.v2.Message",   # oneof sum
    F(1, "new_round_step", "msg", msg=NEW_ROUND_STEP),
    F(2, "new_valid_block", "msg", msg=NEW_VALID_BLOCK),
    F(3, "proposal", "msg", msg=PROPOSAL_MSG),
    F(4, "proposal_pol", "msg", msg=PROPOSAL_POL),
    F(5, "block_part", "msg", msg=BLOCK_PART),
    F(6, "vote", "msg", msg=VOTE_MSG),
    F(7, "has_vote", "msg", msg=HAS_VOTE),
    F(8, "vote_set_maj23", "msg", msg=VOTE_SET_MAJ23),
    F(9, "vote_set_bits", "msg", msg=VOTE_SET_BITS),
    F(10, "has_proposal_block_part", "msg",
      msg=HAS_PROPOSAL_BLOCK_PART),
    F(11, "compact_block", "msg", msg=COMPACT_BLOCK),
    F(12, "vote_batch", "msg", msg=VOTE_BATCH),
    F(13, "compact_block_nack", "msg", msg=COMPACT_BLOCK_NACK),
    F(14, "aggregate_commit", "msg", msg=AGG_COMMIT_MSG),
)
