"""Carry validator sets, commits, votes, headers, light blocks and
evidence across from the reference package.

Accepts the reference's plain data — a ``ValidatorSet.to_proto()`` /
``Commit.to_proto()`` / ``AggregateCommit.to_proto()`` /
``Vote.to_proto()`` / ``ExtendedCommit.to_proto()`` / ``Header`` /
``SignedHeader`` / ``LightBlock`` ``.to_proto()`` dict of Python bytes
and ints, or its protobuf wire bytes; evidence as the wrapped
``Evidence`` oneof (``to_proto_wrapped()``) — and returns the port's
objects.  Validator sets may hold any of the four key types.  Nothing
of the reference is imported: the dict layout and the wire schema are
the contract.
"""
from __future__ import annotations

from .types.block import Header, LightBlock, SignedHeader
from .types.commit import AggregateCommit, Commit, ExtendedCommit
from .types.evidence import Evidence, evidence_from_proto_wrapped
from .types.validator_set import ValidatorSet
from .types.vote import Vote
from .wire import decode, pb


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
