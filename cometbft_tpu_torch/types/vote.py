"""Vote constants that commits carry: the BlockIDFlag values and the
signature size cap.

Reference: types/vote.go, proto/cometbft/types/v2/validator.proto.  The
Vote type itself (gossip, extensions) is not ported yet.
"""

# max(ed25519=64, bls12_381=96); reference: types/signable.go:13
MAX_SIGNATURE_SIZE = 96

# BlockIDFlag (proto/cometbft/types/v2/validator.proto)
BLOCK_ID_FLAG_ABSENT = 1
BLOCK_ID_FLAG_COMMIT = 2
BLOCK_ID_FLAG_NIL = 3
