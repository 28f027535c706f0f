"""Carry validator sets, commits, votes, headers, light blocks,
evidence, blocks, block metas, consensus params, genesis docs and states
across from the reference package.

Accepts the reference's plain data — a ``ValidatorSet.to_proto()`` /
``Commit.to_proto()`` / ``AggregateCommit.to_proto()`` /
``Vote.to_proto()`` / ``ExtendedCommit.to_proto()`` / ``Header`` /
``SignedHeader`` / ``LightBlock`` / ``Block`` / ``BlockMeta`` /
``ConsensusParams`` / ``State`` ``.to_proto()`` dict of Python bytes
and ints, or its protobuf wire bytes; evidence as the wrapped
``Evidence`` oneof (``to_proto_wrapped()``); a genesis doc as its JSON
(``GenesisDoc.to_json()``) — and returns the port's objects.  Validator
sets may hold any of the four key types.  Nothing of the reference is
imported: the dict layout and the wire schema are the contract.
"""
from __future__ import annotations

from .state.state import State
from .types.block import Block, BlockMeta, Header, LightBlock, SignedHeader
from .types.commit import AggregateCommit, Commit, ExtendedCommit
from .types.evidence import Evidence, evidence_from_proto_wrapped
from .types.genesis import GenesisDoc
from .types.params import ConsensusParams
from .types.validator_set import ValidatorSet
from .types.vote import Vote
from .wire import decode, pb, state_pb


def _as_dict(obj, desc) -> dict:
    if isinstance(obj, (bytes, bytearray, memoryview)):
        return decode(desc, bytes(obj))
    if isinstance(obj, dict):
        return obj
    raise TypeError(
        f"expected a {desc.name} dict or its wire bytes, got "
        f"{type(obj).__name__}")


def validator_set(obj) -> ValidatorSet:
    return ValidatorSet.from_proto(_as_dict(obj, pb.VALIDATOR_SET))


def commit(obj) -> Commit:
    return Commit.from_proto(_as_dict(obj, pb.COMMIT))


def aggregate_commit(obj) -> AggregateCommit:
    return AggregateCommit.from_proto(_as_dict(obj, pb.AGGREGATE_COMMIT))


def vote(obj) -> Vote:
    return Vote.from_proto(_as_dict(obj, pb.VOTE))


def extended_commit(obj) -> ExtendedCommit:
    return ExtendedCommit.from_proto(_as_dict(obj, pb.EXTENDED_COMMIT))


def header(obj) -> Header:
    return Header.from_proto(_as_dict(obj, pb.HEADER))


def signed_header(obj) -> SignedHeader:
    return SignedHeader.from_proto(_as_dict(obj, pb.SIGNED_HEADER))


def light_block(obj) -> LightBlock:
    return LightBlock.from_proto(_as_dict(obj, pb.LIGHT_BLOCK))


def evidence(obj) -> Evidence:
    return evidence_from_proto_wrapped(_as_dict(obj, pb.EVIDENCE))


def block(obj) -> Block:
    return Block.from_proto(_as_dict(obj, pb.BLOCK))


def block_meta(obj) -> BlockMeta:
    return BlockMeta.from_proto(_as_dict(obj, pb.BLOCK_META))


def consensus_params(obj) -> ConsensusParams:
    return ConsensusParams.from_proto(_as_dict(obj, pb.CONSENSUS_PARAMS))


def genesis_doc(obj) -> GenesisDoc:
    """From the JSON a genesis file holds (str or bytes)."""
    if isinstance(obj, (bytes, bytearray, memoryview)):
        obj = bytes(obj).decode()
    if not isinstance(obj, str):
        raise TypeError(
            f"expected genesis JSON, got {type(obj).__name__}")
    return GenesisDoc.from_json(obj)


def state(obj) -> State:
    return State.from_proto(_as_dict(obj, state_pb.STATE))
