"""ASCII armor: text-safe encoding for keys and sensitive blobs.

Reference: crypto/armor/armor.go — OpenPGP-style armor blocks
(-----BEGIN <type>-----, base64 body with CRC24 checksum, headers).
A copy of cometbft_tpu/crypto/armor.py: the same text, byte for byte,
and the same error texts.
"""
from __future__ import annotations

import base64


class ArmorError(Exception):
    pass


_CRC24_INIT = 0xB704CE
_CRC24_POLY = 0x1864CFB


def _crc24(data: bytes) -> int:
    crc = _CRC24_INIT
    for b in data:
        crc ^= b << 16
        for _ in range(8):
            crc <<= 1
            if crc & 0x1000000:
                crc ^= _CRC24_POLY
    return crc & 0xFFFFFF


def encode_armor(block_type: str, headers: dict[str, str],
                 data: bytes) -> str:
    lines = [f"-----BEGIN {block_type}-----"]
    for k in sorted(headers):
        lines.append(f"{k}: {headers[k]}")
    if headers:
        lines.append("")
    b64 = base64.b64encode(data).decode()
    for i in range(0, len(b64), 64):
        lines.append(b64[i:i + 64])
    crc = base64.b64encode(
        _crc24(data).to_bytes(3, "big")).decode()
    lines.append(f"={crc}")
    lines.append(f"-----END {block_type}-----")
    return "\n".join(lines) + "\n"


def decode_armor(armor_str: str) -> tuple[str, dict[str, str], bytes]:
    """-> (block_type, headers, data); raises ArmorError."""
    lines = [ln.rstrip("\r") for ln in armor_str.strip().split("\n")]
    if not lines or not lines[0].startswith("-----BEGIN ") or \
            not lines[0].endswith("-----"):
        raise ArmorError("missing BEGIN line")
    block_type = lines[0][len("-----BEGIN "):-len("-----")]
    if not lines[-1].startswith(f"-----END {block_type}"):
        raise ArmorError("missing or mismatched END line")
    body = lines[1:-1]
    headers: dict[str, str] = {}
    i = 0
    while i < len(body) and ":" in body[i]:
        k, _, v = body[i].partition(":")
        headers[k.strip()] = v.strip()
        i += 1
    if i < len(body) and body[i] == "":
        i += 1
    crc_expected = None
    b64_parts = []
    for ln in body[i:]:
        if ln.startswith("="):
            crc_expected = ln[1:]
        elif ln:
            b64_parts.append(ln)
    try:
        data = base64.b64decode("".join(b64_parts), validate=True)
    except Exception as e:
        raise ArmorError(f"bad base64 body: {e}") from None
    if crc_expected is not None:
        got = base64.b64encode(_crc24(data).to_bytes(3, "big")).decode()
        if got != crc_expected:
            raise ArmorError("CRC24 checksum mismatch")
    return block_type, headers, data
