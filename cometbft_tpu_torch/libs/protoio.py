"""Length-delimited frame IO shared by the socket protocols.

Reference: libs/protoio — uvarint-length-prefixed messages, used by the
ABCI socket protocol (abci/types/messages.go) and the privval remote
signer (privval/msgs.go).  A copy of cometbft_tpu/libs/protoio.py: the
same frames and error texts; the caller names the exception type.
"""
from __future__ import annotations

import asyncio
from typing import Optional, Type

from ..wire.proto import encode_uvarint  # single canonical encoder

__all__ = ["encode_uvarint", "read_delimited", "write_delimited"]


async def read_delimited(reader: asyncio.StreamReader, max_size: int,
                         exc_type: Type[Exception]) -> Optional[bytes]:
    """One uvarint-length-delimited frame; None on clean EOF at a frame
    boundary; raises exc_type on oversize/malformed/torn frames."""
    prefix = b""
    size = 0
    shift = 0
    while True:
        b = await reader.read(1)
        if not b:
            if prefix:
                raise exc_type("EOF inside length prefix")
            return None
        prefix += b
        size |= (b[0] & 0x7F) << shift
        shift += 7
        if b[0] < 0x80:
            break
        if len(prefix) > 10:
            raise exc_type("length prefix too long")
    if size > max_size:
        raise exc_type(f"message too large: {size}")
    return await reader.readexactly(size)


def write_delimited(payload: bytes) -> bytes:
    """Frame bytes for a payload (caller writes them)."""
    return encode_uvarint(len(payload)) + payload
