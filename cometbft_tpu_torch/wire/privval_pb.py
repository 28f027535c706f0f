"""Wire descriptors for cometbft.privval.v2 (remote signer protocol).

Reference: proto/cometbft/privval/v2/types.proto — the Message oneof
carried as uvarint-length-delimited frames between the node's
SignerListenerEndpoint and the external SignerServer; a copy of
cometbft_tpu/wire/privval_pb.py.
"""
from .pb import PROPOSAL, VOTE
from .proto import F, Msg

REMOTE_SIGNER_ERROR = Msg(
    "cometbft.privval.v2.RemoteSignerError",
    F(1, "code", "int32"),
    F(2, "description", "string"),
)

PUB_KEY_REQUEST = Msg(
    "cometbft.privval.v2.PubKeyRequest",
    F(1, "chain_id", "string"),
)

PUB_KEY_RESPONSE = Msg(
    "cometbft.privval.v2.PubKeyResponse",
    F(2, "error", "msg", msg=REMOTE_SIGNER_ERROR),
    F(3, "pub_key_bytes", "bytes"),
    F(4, "pub_key_type", "string"),
)

SIGN_VOTE_REQUEST = Msg(
    "cometbft.privval.v2.SignVoteRequest",
    F(1, "vote", "msg", msg=VOTE),
    F(2, "chain_id", "string"),
    F(3, "skip_extension_signing", "bool"),
)

SIGNED_VOTE_RESPONSE = Msg(
    "cometbft.privval.v2.SignedVoteResponse",
    F(1, "vote", "msg", msg=VOTE, always=True),
    F(2, "error", "msg", msg=REMOTE_SIGNER_ERROR),
)

SIGN_PROPOSAL_REQUEST = Msg(
    "cometbft.privval.v2.SignProposalRequest",
    F(1, "proposal", "msg", msg=PROPOSAL),
    F(2, "chain_id", "string"),
)

SIGNED_PROPOSAL_RESPONSE = Msg(
    "cometbft.privval.v2.SignedProposalResponse",
    F(1, "proposal", "msg", msg=PROPOSAL, always=True),
    F(2, "error", "msg", msg=REMOTE_SIGNER_ERROR),
)

SIGN_BYTES_REQUEST = Msg(
    "cometbft.privval.v2.SignBytesRequest",
    F(1, "value", "bytes"),
)

SIGN_BYTES_RESPONSE = Msg(
    "cometbft.privval.v2.SignBytesResponse",
    F(1, "signature", "bytes"),
    F(2, "error", "msg", msg=REMOTE_SIGNER_ERROR),
)

PING_REQUEST = Msg("cometbft.privval.v2.PingRequest")
PING_RESPONSE = Msg("cometbft.privval.v2.PingResponse")

MESSAGE = Msg(
    "cometbft.privval.v2.Message",
    F(1, "pub_key_request", "msg", msg=PUB_KEY_REQUEST),
    F(2, "pub_key_response", "msg", msg=PUB_KEY_RESPONSE),
    F(3, "sign_vote_request", "msg", msg=SIGN_VOTE_REQUEST),
    F(4, "signed_vote_response", "msg", msg=SIGNED_VOTE_RESPONSE),
    F(5, "sign_proposal_request", "msg", msg=SIGN_PROPOSAL_REQUEST),
    F(6, "signed_proposal_response", "msg", msg=SIGNED_PROPOSAL_RESPONSE),
    F(7, "ping_request", "msg", msg=PING_REQUEST),
    F(8, "ping_response", "msg", msg=PING_RESPONSE),
    F(9, "sign_bytes_request", "msg", msg=SIGN_BYTES_REQUEST),
    F(10, "sign_bytes_response", "msg", msg=SIGN_BYTES_RESPONSE),
)
