"""Wire descriptors of the consensus gossip messages that carry votes.

The port's trimmed copy of cometbft_tpu/wire/consensus_pb.py (which
mirrors the reference's proto/cometbft/consensus/v2/types.proto): the
``Vote`` message (:53), ``VoteBatch`` (:116) and the ``Message`` oneof
(:131-145) with only its ``vote`` and ``vote_batch`` arms.  Field
numbers are the reference's, so a message of either arm is byte for
byte what a full node sends; an arm not listed here decodes to a dict
without either key.
"""
from .proto import F, Msg
from .pb import VOTE

VOTE_MSG = Msg(
    "cometbft.consensus.v2.Vote",
    F(1, "vote", "msg", msg=VOTE),
)

# vote batching ("votebatch/1"): missing votes coalesced per wire
# message on the vote channel
VOTE_BATCH = Msg(
    "cometbft.consensus.v2.VoteBatch",
    F(1, "votes", "msg", msg=VOTE, repeated=True),
)

MESSAGE = Msg(
    "cometbft.consensus.v2.Message",   # oneof sum
    F(6, "vote", "msg", msg=VOTE_MSG),
    F(12, "vote_batch", "msg", msg=VOTE_BATCH),
)
