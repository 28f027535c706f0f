"""The bytes a CometBFT validator signs for a vote, encoded from the
protobuf schema alone.

types/vote.go VoteSignBytes is ``protoio.MarshalDelimited`` of a
``CanonicalVote`` (proto/cometbft/types/v1/canonical.proto):

    CanonicalVote         1 type (enum, varint)   2 height (sfixed64)
                          3 round (sfixed64)      4 block_id (nullable)
                          5 timestamp (non-nullable)   6 chain_id (string)
    CanonicalBlockID      1 hash (bytes)   2 part_set_header (non-nullable)
    CanonicalPartSetHeader 1 total (uint32)  2 hash (bytes)
    google.protobuf.Timestamp  1 seconds (int64)  2 nanos (int32)

proto3 leaves out a scalar equal to zero; a non-nullable message is
written even when empty; the whole is prefixed by its length as an
unsigned varint.
"""
from __future__ import annotations

import struct
from typing import Callable, Optional

PRECOMMIT = 2
_MASK64 = (1 << 64) - 1


def uvarint(n: int) -> bytes:
    out = bytearray()
    while n >= 0x80:
        out.append((n & 0x7F) | 0x80)
        n >>= 7
    out.append(n)
    return bytes(out)


def _key(num: int, wire_type: int) -> bytes:
    return uvarint(num << 3 | wire_type)


def _bytes_field(num: int, payload: bytes) -> bytes:
    return _key(num, 2) + uvarint(len(payload)) + payload


def timestamp(seconds: int, nanos: int) -> bytes:
    out = b""
    if seconds:
        out += _key(1, 0) + uvarint(seconds & _MASK64)
    if nanos:
        out += _key(2, 0) + uvarint(nanos & _MASK64)
    return out


def block_id(hash_: bytes, psh_total: int, psh_hash: bytes
             ) -> Optional[bytes]:
    """The CanonicalBlockID's encoding; None for the nil block id, which
    a nil vote leaves out."""
    if not hash_ and not psh_total and not psh_hash:
        return None
    psh = b""
    if psh_total:
        psh += _key(1, 0) + uvarint(psh_total)
    if psh_hash:
        psh += _bytes_field(2, psh_hash)
    return (_bytes_field(1, hash_) if hash_ else b"") + _bytes_field(2, psh)


def vote_template(chain_id: str, type_: int, height: int, round_: int,
                  bid: Optional[bytes]) -> Callable[[int, int], bytes]:
    """fn(seconds, nanos) -> the sign bytes of a vote with those fields
    and that timestamp (the commit's votes differ only in it)."""
    head = b""
    if type_:
        head += _key(1, 0) + uvarint(type_)
    if height:
        head += _key(2, 1) + struct.pack("<q", height)
    if round_:
        head += _key(3, 1) + struct.pack("<q", round_)
    if bid is not None:
        head += _bytes_field(4, bid)
    tail = _bytes_field(6, chain_id.encode()) if chain_id else b""

    def sign_bytes(seconds: int, nanos: int) -> bytes:
        body = head + _bytes_field(5, timestamp(seconds, nanos)) + tail
        return uvarint(len(body)) + body

    return sign_bytes
