"""Descriptor-driven protobuf wire codec (the port's copy of
cometbft_tpu/wire/proto.py).

Gogoproto-compatible semantics (reference: api/ generated marshalers):
  * fields serialized in ascending field-number order;
  * proto3 scalar fields omitted when zero ("" / b"" / 0 / False);
  * embedded messages: `always=True` mirrors gogoproto `nullable=false`
    (field emitted even when the value is all-zero); otherwise a None value
    omits the field;
  * int32/int64/enum negatives encode as 10-byte two's-complement varints;
  * unknown fields are skipped on decode (forward compatibility);
  * a known field whose wire type is not its kind's is refused with a
    ValueError, as gogoproto refuses a "wrong wireType"; a repeated
    number field also reads a packed run (wire type 2).

Messages are plain dicts keyed by field name; absent == default.
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field as dc_field
from typing import Any, Optional, Sequence

_MASK64 = (1 << 64) - 1

# wire types
_WT_VARINT = 0
_WT_FIXED64 = 1
_WT_LEN = 2
_WT_FIXED32 = 5

# the scalar kinds are defined once by _KIND_WT below;
# _SCALAR_KINDS = frozenset(_KIND_WT) next to it


@dataclass(frozen=True)
class F:
    """One field of a message descriptor.

    The wire tag bytes and the kind's encoder function are bound once
    here — encode() is on the consensus gossip hot path (every vote /
    block part / mempool tx marshals through it), and per-call tag
    arithmetic plus a 12-way kind chain measured ~2x the whole encode
    cost."""
    num: int
    name: str
    kind: str                      # scalar kind or "msg"
    msg: Optional["Msg"] = None    # sub-descriptor when kind == "msg"
    repeated: bool = False
    always: bool = False           # gogoproto nullable=false for msg kinds

    def __post_init__(self):
        if self.kind == "msg":
            if self.msg is None:
                raise ValueError(f"{self.name}: msg kind needs descriptor")
            wt = _WT_LEN
        elif self.kind not in _SCALAR_KINDS:
            raise ValueError(f"{self.name}: unknown kind {self.kind}")
        else:
            wt = _KIND_WT[self.kind]
        object.__setattr__(self, "tag", _tag(self.num, wt))
        object.__setattr__(self, "enc", _ENCODERS.get(self.kind))


@dataclass(frozen=True)
class Msg:
    """A message descriptor: name + ordered fields."""
    name: str
    fields: Sequence[F] = dc_field(default_factory=tuple)

    def __init__(self, name: str, *fields: F):
        object.__setattr__(self, "name", name)
        object.__setattr__(
            self, "fields", tuple(sorted(fields, key=lambda f: f.num)))
        by_num = {f.num: f for f in self.fields}
        if len(by_num) != len(self.fields):
            raise ValueError(f"{name}: duplicate field numbers")
        object.__setattr__(self, "_by_num", by_num)

    def empty(self) -> dict:
        return {}


def encode_uvarint(u: int) -> bytes:
    if u < 0:
        raise ValueError("uvarint must be non-negative")
    out = bytearray()
    while True:
        b = u & 0x7F
        u >>= 7
        if u:
            out.append(b | 0x80)
        else:
            out.append(b)
            return bytes(out)


def _append_uvarint(out: bytearray, u: int) -> None:
    """encode_uvarint without the intermediate bytes allocation."""
    while u > 0x7F:
        out.append((u & 0x7F) | 0x80)
        u >>= 7
    out.append(u)


def _tag(num: int, wt: int) -> bytes:
    return encode_uvarint((num << 3) | wt)


_KIND_WT = {
    "int32": _WT_VARINT, "int64": _WT_VARINT, "enum": _WT_VARINT,
    "uint32": _WT_VARINT, "uint64": _WT_VARINT, "bool": _WT_VARINT,
    "sfixed64": _WT_FIXED64, "fixed64": _WT_FIXED64,
    "sfixed32": _WT_FIXED32, "fixed32": _WT_FIXED32,
    "bytes": _WT_LEN, "string": _WT_LEN,
}
_SCALAR_KINDS = frozenset(_KIND_WT)


def _e_int(tag: bytes, v: Any, out: bytearray) -> None:
    out += tag
    _append_uvarint(out, int(v) & _MASK64)


def _e_uint(tag: bytes, v: Any, out: bytearray) -> None:
    u = int(v)
    if u < 0:
        raise ValueError("uvarint must be non-negative")
    out += tag
    _append_uvarint(out, u)


def _e_bool(tag: bytes, v: Any, out: bytearray) -> None:
    out += tag
    out.append(1 if v else 0)


_PACK_q = struct.Struct("<q").pack
_PACK_Q = struct.Struct("<Q").pack
_PACK_i = struct.Struct("<i").pack
_PACK_I = struct.Struct("<I").pack


def _e_sfixed64(tag: bytes, v: Any, out: bytearray) -> None:
    out += tag
    out += _PACK_q(int(v))


def _e_fixed64(tag: bytes, v: Any, out: bytearray) -> None:
    out += tag
    out += _PACK_Q(int(v))


def _e_sfixed32(tag: bytes, v: Any, out: bytearray) -> None:
    out += tag
    out += _PACK_i(int(v))


def _e_fixed32(tag: bytes, v: Any, out: bytearray) -> None:
    out += tag
    out += _PACK_I(int(v))


def _e_bytes(tag: bytes, v: Any, out: bytearray) -> None:
    b = bytes(v)
    out += tag
    _append_uvarint(out, len(b))
    out += b


def _e_string(tag: bytes, v: Any, out: bytearray) -> None:
    b = v.encode("utf-8")
    out += tag
    _append_uvarint(out, len(b))
    out += b


_ENCODERS = {
    "int32": _e_int, "int64": _e_int, "enum": _e_int,
    "uint32": _e_uint, "uint64": _e_uint, "bool": _e_bool,
    "sfixed64": _e_sfixed64, "fixed64": _e_fixed64,
    "sfixed32": _e_sfixed32, "fixed32": _e_fixed32,
    "bytes": _e_bytes, "string": _e_string,
}


def _is_zero(kind: str, v: Any) -> bool:
    if v is None:
        return True
    if kind == "bytes":
        return len(v) == 0
    if kind == "string":
        return v == ""
    if kind == "bool":
        return not v
    return int(v) == 0


def encode(desc: Msg, d: dict) -> bytes:
    out = bytearray()
    for f in desc.fields:
        v = d.get(f.name)
        if f.repeated:
            if not v:
                continue
            enc = f.enc
            if enc is None:                    # msg kind
                for item in v:
                    body = encode(f.msg, item)
                    out += f.tag
                    _append_uvarint(out, len(body))
                    out += body
            else:
                tag = f.tag
                for item in v:
                    enc(tag, item, out)
        elif f.kind == "msg":
            if v is None:
                if not f.always:
                    continue
                v = {}
            body = encode(f.msg, v)
            out += f.tag
            _append_uvarint(out, len(body))
            out += body
        else:
            if _is_zero(f.kind, v):
                continue
            f.enc(f.tag, v, out)
    return bytes(out)


def decode_uvarint(data: bytes, pos: int) -> tuple[int, int]:
    result = 0
    shift = 0
    while True:
        if pos >= len(data):
            raise ValueError("truncated varint")
        b = data[pos]
        pos += 1
        result |= (b & 0x7F) << shift
        if not (b & 0x80):
            return result, pos
        shift += 7
        if shift > 63:
            raise ValueError("varint too long")


def _to_signed64(u: int) -> int:
    return u - (1 << 64) if u >= (1 << 63) else u


def _to_signed32(u: int) -> int:
    u &= 0xFFFFFFFF
    return u - (1 << 32) if u >= (1 << 31) else u


def _dec_scalar(f: F, data: bytes, pos: int, wt: int) -> tuple[Any, int]:
    k = f.kind
    if wt == _WT_VARINT:
        u, pos = decode_uvarint(data, pos)
        if k in ("int64", "enum"):
            return _to_signed64(u), pos
        if k == "int32":
            return _to_signed32(_to_signed64(u)), pos
        if k == "bool":
            return bool(u), pos
        return u, pos
    if wt == _WT_FIXED64:
        raw = data[pos:pos + 8]
        if len(raw) != 8:
            raise ValueError("truncated fixed64")
        pos += 8
        fmt = "<q" if k == "sfixed64" else "<Q"
        return struct.unpack(fmt, raw)[0], pos
    if wt == _WT_FIXED32:
        raw = data[pos:pos + 4]
        if len(raw) != 4:
            raise ValueError("truncated fixed32")
        pos += 4
        fmt = "<i" if k == "sfixed32" else "<I"
        return struct.unpack(fmt, raw)[0], pos
    if wt == _WT_LEN:
        ln, pos = decode_uvarint(data, pos)
        raw = data[pos:pos + ln]
        if len(raw) != ln:
            raise ValueError("truncated length-delimited field")
        pos += ln
        if k == "string":
            return raw.decode("utf-8"), pos
        return bytes(raw), pos
    raise ValueError(f"unsupported wire type {wt}")


def _skip(data: bytes, pos: int, wt: int) -> int:
    if wt == _WT_VARINT:
        _, pos = decode_uvarint(data, pos)
        return pos
    if wt == _WT_FIXED64:
        return pos + 8
    if wt == _WT_FIXED32:
        return pos + 4
    if wt == _WT_LEN:
        ln, pos = decode_uvarint(data, pos)
        return pos + ln
    raise ValueError(f"cannot skip wire type {wt}")


def decode(desc: Msg, data: bytes) -> dict:
    d: dict = {}
    pos = 0
    n = len(data)
    by_num = desc._by_num  # type: ignore[attr-defined]
    while pos < n:
        key, pos = decode_uvarint(data, pos)
        num, wt = key >> 3, key & 0x7
        f = by_num.get(num)
        if f is None:
            pos = _skip(data, pos, wt)
            continue
        if f.kind == "msg":
            if wt != _WT_LEN:
                raise ValueError(f"{desc.name}.{f.name}: bad wire type {wt}")
            ln, pos = decode_uvarint(data, pos)
            raw = data[pos:pos + ln]
            if len(raw) != ln:
                raise ValueError("truncated embedded message")
            pos += ln
            v = decode(f.msg, raw)
            if f.repeated:
                d.setdefault(f.name, []).append(v)
            else:
                d[f.name] = v
        elif wt == _KIND_WT[f.kind]:
            v, pos = _dec_scalar(f, data, pos, wt)
            if f.repeated:
                d.setdefault(f.name, []).append(v)
            else:
                d[f.name] = v
        elif wt == _WT_LEN and f.repeated:
            # a packed run of a repeated number field, as gogoproto
            # writes and reads it
            ln, pos = decode_uvarint(data, pos)
            end = pos + ln
            if end > n:
                raise ValueError("truncated packed field")
            items = d.setdefault(f.name, [])
            inner = _KIND_WT[f.kind]
            while pos < end:
                v, pos = _dec_scalar(f, data, pos, inner)
                items.append(v)
            if pos != end:
                raise ValueError("truncated packed field")
        else:
            # gogoproto: "proto: wrong wireType"
            raise ValueError(f"{desc.name}.{f.name}: bad wire type {wt}")
    # gogoproto nullable=false embedded messages decode to their zero value
    for f in desc.fields:
        if f.kind == "msg" and f.always and not f.repeated and f.name not in d:
            d[f.name] = {}
    return d


def marshal_delimited(desc: Msg, d: dict) -> bytes:
    """uvarint-length-prefixed encoding (reference: libs/protoio)."""
    body = encode(desc, d)
    return encode_uvarint(len(body)) + body


def unmarshal_delimited(desc: Msg, data: bytes) -> tuple[dict, int]:
    """Decode one length-prefixed message; returns (msg, bytes consumed)."""
    ln, pos = decode_uvarint(data, 0)
    raw = data[pos:pos + ln]
    if len(raw) != ln:
        raise ValueError("truncated delimited message")
    return decode(desc, raw), pos + ln

