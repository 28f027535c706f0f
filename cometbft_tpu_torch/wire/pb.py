"""Message descriptors for votes and proposals and their canonical
forms, commits (per-signature, aggregate and extended), validator sets,
headers, signed headers, light blocks, evidence, blocks and their data,
parts and metas, and consensus params.

The port's trimmed copy of cometbft_tpu/wire/pb.py (which mirrors the
reference's proto/cometbft/**/*.proto).  Field numbers, kinds and
gogoproto nullability are the consensus-critical contract.
"""
from .proto import F, Msg

TIMESTAMP = Msg(
    "google.protobuf.Timestamp",
    F(1, "seconds", "int64"),
    F(2, "nanos", "int32"),
)

DURATION = Msg(
    "google.protobuf.Duration",
    F(1, "seconds", "int64"),
    F(2, "nanos", "int32"),
)

# wrapper types used by cdcEncode-style field hashing (gogotypes wrappers)
INT64_VALUE = Msg("google.protobuf.Int64Value", F(1, "value", "int64"))
STRING_VALUE = Msg("google.protobuf.StringValue", F(1, "value", "string"))
BYTES_VALUE = Msg("google.protobuf.BytesValue", F(1, "value", "bytes"))

CONSENSUS_VERSION = Msg(
    "cometbft.version.v1.Consensus",
    F(1, "block", "uint64"),
    F(2, "app", "uint64"),
)

PUBLIC_KEY = Msg(
    "cometbft.crypto.v1.PublicKey",  # oneof sum: exactly one field set
    F(1, "ed25519", "bytes"),
    F(2, "secp256k1", "bytes"),
    F(3, "bls12381", "bytes"),
    F(4, "secp256k1eth", "bytes"),
)

PROOF = Msg(
    "cometbft.crypto.v1.Proof",
    F(1, "total", "int64"),
    F(2, "index", "int64"),
    F(3, "leaf_hash", "bytes"),
    F(4, "aunts", "bytes", repeated=True),
)

PART_SET_HEADER = Msg(
    "cometbft.types.v2.PartSetHeader",
    F(1, "total", "uint32"),
    F(2, "hash", "bytes"),
)

PART = Msg(
    "cometbft.types.v2.Part",
    F(1, "index", "uint32"),
    F(2, "bytes", "bytes"),
    F(3, "proof", "msg", msg=PROOF, always=True),
)

BLOCK_ID = Msg(
    "cometbft.types.v2.BlockID",
    F(1, "hash", "bytes"),
    F(2, "part_set_header", "msg", msg=PART_SET_HEADER, always=True),
)

DATA = Msg(
    "cometbft.types.v2.Data",
    F(1, "txs", "bytes", repeated=True),
)

VOTE = Msg(
    "cometbft.types.v2.Vote",
    F(1, "type", "enum"),
    F(2, "height", "int64"),
    F(3, "round", "int32"),
    F(4, "block_id", "msg", msg=BLOCK_ID, always=True),
    F(5, "timestamp", "msg", msg=TIMESTAMP, always=True),
    F(6, "validator_address", "bytes"),
    F(7, "validator_index", "int32"),
    F(8, "signature", "bytes"),
    F(9, "extension", "bytes"),
    F(10, "extension_signature", "bytes"),
    F(11, "non_rp_extension", "bytes"),
    F(12, "non_rp_extension_signature", "bytes"),
)

COMMIT_SIG = Msg(
    "cometbft.types.v2.CommitSig",
    F(1, "block_id_flag", "enum"),
    F(2, "validator_address", "bytes"),
    F(3, "timestamp", "msg", msg=TIMESTAMP, always=True),
    F(4, "signature", "bytes"),
)

COMMIT = Msg(
    "cometbft.types.v2.Commit",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "block_id", "msg", msg=BLOCK_ID, always=True),
    F(4, "signatures", "msg", msg=COMMIT_SIG, repeated=True),
)

AGGREGATE_COMMIT = Msg(
    "cometbft.types.v2.AggregateCommit",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "block_id", "msg", msg=BLOCK_ID, always=True),
    F(4, "signer_count", "int64"),
    F(5, "signers", "bytes"),
    F(6, "signature", "bytes"),
)

EXTENDED_COMMIT_SIG = Msg(
    "cometbft.types.v2.ExtendedCommitSig",
    F(1, "block_id_flag", "enum"),
    F(2, "validator_address", "bytes"),
    F(3, "timestamp", "msg", msg=TIMESTAMP, always=True),
    F(4, "signature", "bytes"),
    F(5, "extension", "bytes"),
    F(6, "extension_signature", "bytes"),
    F(7, "non_rp_extension", "bytes"),
    F(8, "non_rp_extension_signature", "bytes"),
)

EXTENDED_COMMIT = Msg(
    "cometbft.types.v2.ExtendedCommit",
    F(1, "height", "int64"),
    F(2, "round", "int32"),
    F(3, "block_id", "msg", msg=BLOCK_ID, always=True),
    F(4, "extended_signatures", "msg", msg=EXTENDED_COMMIT_SIG,
      repeated=True),
)

PROPOSAL = Msg(
    "cometbft.types.v2.Proposal",
    F(1, "type", "enum"),
    F(2, "height", "int64"),
    F(3, "round", "int32"),
    F(4, "pol_round", "int32"),
    F(5, "block_id", "msg", msg=BLOCK_ID, always=True),
    F(6, "timestamp", "msg", msg=TIMESTAMP, always=True),
    F(7, "signature", "bytes"),
)

VALIDATOR = Msg(
    "cometbft.types.v2.Validator",
    F(1, "address", "bytes"),
    F(2, "pub_key", "msg", msg=PUBLIC_KEY),  # deprecated in reference
    F(3, "voting_power", "int64"),
    F(4, "proposer_priority", "int64"),
    F(5, "pub_key_bytes", "bytes"),
    F(6, "pub_key_type", "string"),
)

SIMPLE_VALIDATOR = Msg(
    "cometbft.types.v2.SimpleValidator",
    F(1, "pub_key", "msg", msg=PUBLIC_KEY),
    F(2, "voting_power", "int64"),
)

VALIDATOR_SET = Msg(
    "cometbft.types.v2.ValidatorSet",
    F(1, "validators", "msg", msg=VALIDATOR, repeated=True),
    F(2, "proposer", "msg", msg=VALIDATOR),
    F(3, "total_voting_power", "int64"),
)

CANONICAL_PART_SET_HEADER = Msg(
    "cometbft.types.v2.CanonicalPartSetHeader",
    F(1, "total", "uint32"),
    F(2, "hash", "bytes"),
)

CANONICAL_BLOCK_ID = Msg(
    "cometbft.types.v2.CanonicalBlockID",
    F(1, "hash", "bytes"),
    F(2, "part_set_header", "msg", msg=CANONICAL_PART_SET_HEADER,
      always=True),
)

CANONICAL_PROPOSAL = Msg(
    "cometbft.types.v2.CanonicalProposal",
    F(1, "type", "enum"),
    F(2, "height", "sfixed64"),
    F(3, "round", "sfixed64"),
    F(4, "pol_round", "int64"),
    F(5, "block_id", "msg", msg=CANONICAL_BLOCK_ID),  # nullable
    F(6, "timestamp", "msg", msg=TIMESTAMP, always=True),
    F(7, "chain_id", "string"),
)

CANONICAL_VOTE = Msg(
    "cometbft.types.v2.CanonicalVote",
    F(1, "type", "enum"),
    F(2, "height", "sfixed64"),
    F(3, "round", "sfixed64"),
    F(4, "block_id", "msg", msg=CANONICAL_BLOCK_ID),  # nullable
    F(5, "timestamp", "msg", msg=TIMESTAMP, always=True),
    F(6, "chain_id", "string"),
)

CANONICAL_VOTE_EXTENSION = Msg(
    "cometbft.types.v2.CanonicalVoteExtension",
    F(1, "extension", "bytes"),
    F(2, "height", "sfixed64"),
    F(3, "round", "sfixed64"),
    F(4, "chain_id", "string"),
)

HEADER = Msg(
    "cometbft.types.v2.Header",
    F(1, "version", "msg", msg=CONSENSUS_VERSION, always=True),
    F(2, "chain_id", "string"),
    F(3, "height", "int64"),
    F(4, "time", "msg", msg=TIMESTAMP, always=True),
    F(5, "last_block_id", "msg", msg=BLOCK_ID, always=True),
    F(6, "last_commit_hash", "bytes"),
    F(7, "data_hash", "bytes"),
    F(8, "validators_hash", "bytes"),
    F(9, "next_validators_hash", "bytes"),
    F(10, "consensus_hash", "bytes"),
    F(11, "app_hash", "bytes"),
    F(12, "last_results_hash", "bytes"),
    F(13, "evidence_hash", "bytes"),
    F(14, "proposer_address", "bytes"),
)

SIGNED_HEADER = Msg(
    "cometbft.types.v2.SignedHeader",
    F(1, "header", "msg", msg=HEADER),
    F(2, "commit", "msg", msg=COMMIT),
    F(3, "aggregate_commit", "msg", msg=AGGREGATE_COMMIT),
)

LIGHT_BLOCK = Msg(
    "cometbft.types.v2.LightBlock",
    F(1, "signed_header", "msg", msg=SIGNED_HEADER),
    F(2, "validator_set", "msg", msg=VALIDATOR_SET),
)

DUPLICATE_VOTE_EVIDENCE = Msg(
    "cometbft.types.v2.DuplicateVoteEvidence",
    F(1, "vote_a", "msg", msg=VOTE),
    F(2, "vote_b", "msg", msg=VOTE),
    F(3, "total_voting_power", "int64"),
    F(4, "validator_power", "int64"),
    F(5, "timestamp", "msg", msg=TIMESTAMP, always=True),
)

LIGHT_CLIENT_ATTACK_EVIDENCE = Msg(
    "cometbft.types.v2.LightClientAttackEvidence",
    F(1, "conflicting_block", "msg", msg=LIGHT_BLOCK),
    F(2, "common_height", "int64"),
    F(3, "byzantine_validators", "msg", msg=VALIDATOR, repeated=True),
    F(4, "total_voting_power", "int64"),
    F(5, "timestamp", "msg", msg=TIMESTAMP, always=True),
)

EVIDENCE = Msg(
    "cometbft.types.v2.Evidence",  # oneof sum
    F(1, "duplicate_vote_evidence", "msg", msg=DUPLICATE_VOTE_EVIDENCE),
    F(2, "light_client_attack_evidence", "msg",
      msg=LIGHT_CLIENT_ATTACK_EVIDENCE),
)

EVIDENCE_LIST = Msg(
    "cometbft.types.v2.EvidenceList",
    F(1, "evidence", "msg", msg=EVIDENCE, repeated=True),
)

BLOCK = Msg(
    "cometbft.types.v2.Block",
    F(1, "header", "msg", msg=HEADER, always=True),
    F(2, "data", "msg", msg=DATA, always=True),
    F(3, "evidence", "msg", msg=EVIDENCE_LIST, always=True),
    F(4, "last_commit", "msg", msg=COMMIT),
    F(5, "last_aggregate_commit", "msg", msg=AGGREGATE_COMMIT),
)

BLOCK_META = Msg(
    "cometbft.types.v2.BlockMeta",
    F(1, "block_id", "msg", msg=BLOCK_ID, always=True),
    F(2, "block_size", "int64"),
    F(3, "header", "msg", msg=HEADER, always=True),
    F(4, "num_txs", "int64"),
)

# consensus params (params.proto)

BLOCK_PARAMS = Msg(
    "cometbft.types.v2.BlockParams",
    F(1, "max_bytes", "int64"),
    F(2, "max_gas", "int64"),
)

EVIDENCE_PARAMS = Msg(
    "cometbft.types.v2.EvidenceParams",
    F(1, "max_age_num_blocks", "int64"),
    F(2, "max_age_duration", "msg", msg=DURATION, always=True),
    F(3, "max_bytes", "int64"),
)

VALIDATOR_PARAMS = Msg(
    "cometbft.types.v2.ValidatorParams",
    F(1, "pub_key_types", "string", repeated=True),
)

VERSION_PARAMS = Msg(
    "cometbft.types.v2.VersionParams",
    F(1, "app", "uint64"),
)

SYNCHRONY_PARAMS = Msg(
    "cometbft.types.v2.SynchronyParams",
    F(1, "precision", "msg", msg=DURATION),
    F(2, "message_delay", "msg", msg=DURATION),
)

FEATURE_PARAMS = Msg(
    "cometbft.types.v2.FeatureParams",
    F(1, "vote_extensions_enable_height", "msg", msg=INT64_VALUE),
    F(2, "pbts_enable_height", "msg", msg=INT64_VALUE),
    F(3, "aggregate_commit_enable_height", "msg", msg=INT64_VALUE),
)

CONSENSUS_PARAMS = Msg(
    "cometbft.types.v2.ConsensusParams",
    F(1, "block", "msg", msg=BLOCK_PARAMS),
    F(2, "evidence", "msg", msg=EVIDENCE_PARAMS),
    F(3, "validator", "msg", msg=VALIDATOR_PARAMS),
    F(4, "version", "msg", msg=VERSION_PARAMS),
    F(6, "synchrony", "msg", msg=SYNCHRONY_PARAMS),
    F(7, "feature", "msg", msg=FEATURE_PARAMS),
)

HASHED_PARAMS = Msg(
    "cometbft.types.v2.HashedParams",
    F(1, "block_max_bytes", "int64"),
    F(2, "block_max_gas", "int64"),
)
