"""ChaCha20-Poly1305 AEAD + X25519 + HKDF-SHA256 in Python and numpy.

The port's copy of cometbft_tpu/crypto/_aead_fallback.py, the standard
library plus numpy:

* ChaCha20 (RFC 8439) — numpy-vectorized across blocks.
* Poly1305 — the classic one-big-int Horner chain mod 2^130-5.
* X25519 (RFC 7748) — constant-structure Montgomery ladder in python
  ints; only runs twice per connection handshake.
* HKDF-SHA256 (RFC 5869) — stdlib hmac.

X25519 and HKDF are the secret connection's own (p2p/secret_connection.py
calls them twice a connection).  The ChaCha20-Poly1305 here is the plain
version of the host library (ops/aead_host.py): the secret connection
never calls it; the tests and chip_smoke.py hold the library to it.  The
JAX copy's native fast path is not kept.  Outputs are bit-identical to
the OpenSSL-backed implementations.
"""
from __future__ import annotations

import hashlib
import hmac as _hmac
import secrets
import struct

import numpy as np


class AEADInvalidTag(Exception):
    pass


# ---------------------------------------------------------------------
# HKDF-SHA256 (RFC 5869)

def hkdf_sha256(ikm: bytes, salt: bytes, info: bytes,
                length: int) -> bytes:
    prk = _hmac.new(salt or b"\x00" * 32, ikm, hashlib.sha256).digest()
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = _hmac.new(prk, t + info + bytes([i]),
                      hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


# ---------------------------------------------------------------------
# ChaCha20 (RFC 8439) — state rows vectorized over the block axis

_CONSTANTS = np.array([0x61707865, 0x3320646e, 0x79622d32, 0x6b206574],
                      dtype=np.uint32)


def _rotl(x: np.ndarray, n: int) -> np.ndarray:
    return (x << np.uint32(n)) | (x >> np.uint32(32 - n))


def _quarter(x, a, b, c, d) -> None:
    x[a] += x[b]; x[d] = _rotl(x[d] ^ x[a], 16)     # noqa: E702
    x[c] += x[d]; x[b] = _rotl(x[b] ^ x[c], 12)     # noqa: E702
    x[a] += x[b]; x[d] = _rotl(x[d] ^ x[a], 8)      # noqa: E702
    x[c] += x[d]; x[b] = _rotl(x[b] ^ x[c], 7)      # noqa: E702


def _chacha20_keystream(key: bytes, counter: int, nonce: bytes,
                        nbytes: int) -> np.ndarray:
    nblocks = (nbytes + 63) // 64
    state = np.empty((16, nblocks), dtype=np.uint32)
    state[:4] = _CONSTANTS[:, None]
    state[4:12] = np.frombuffer(key, dtype="<u4")[:, None]
    state[12] = (counter + np.arange(nblocks)).astype(np.uint32)
    state[13:16] = np.frombuffer(nonce, dtype="<u4")[:, None]
    x = state.copy()
    with np.errstate(over="ignore"):
        for _ in range(10):
            _quarter(x, 0, 4, 8, 12)
            _quarter(x, 1, 5, 9, 13)
            _quarter(x, 2, 6, 10, 14)
            _quarter(x, 3, 7, 11, 15)
            _quarter(x, 0, 5, 10, 15)
            _quarter(x, 1, 6, 11, 12)
            _quarter(x, 2, 7, 8, 13)
            _quarter(x, 3, 4, 9, 14)
        x += state
    # serialize per block: (16, n) -> (n, 16) little-endian words
    ks = np.ascontiguousarray(x.T).view(np.uint8).reshape(-1)
    return ks[:nbytes]


# ---------------------------------------------------------------------
# Poly1305

_P1305 = (1 << 130) - 5
_CLAMP = 0x0ffffffc0ffffffc0ffffffc0fffffff


def _poly1305(otk: bytes, msg: bytes) -> bytes:
    r = int.from_bytes(otk[:16], "little") & _CLAMP
    s = int.from_bytes(otk[16:32], "little")
    acc = 0
    for i in range(0, len(msg), 16):
        blk = msg[i:i + 16]
        n = int.from_bytes(blk, "little") + (1 << (8 * len(blk)))
        acc = ((acc + n) * r) % _P1305
    return ((acc + s) & ((1 << 128) - 1)).to_bytes(16, "little")


def _pad16(b: bytes) -> bytes:
    return b"\x00" * (-len(b) % 16)


class ChaCha20Poly1305:
    """RFC 8439 AEAD with the ``cryptography`` package's surface:
    encrypt(nonce, data, aad) -> ct||tag, decrypt raises on a bad
    tag.  One keystream pass covers the one-time key (block 0) and the
    data."""

    def __init__(self, key: bytes):
        if len(key) != 32:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)

    @staticmethod
    def _tag(otk: bytes, ct: bytes, aad: bytes) -> bytes:
        mac_data = (aad + _pad16(aad) + ct + _pad16(ct) +
                    struct.pack("<QQ", len(aad), len(ct)))
        return _poly1305(otk, mac_data)

    def encrypt(self, nonce: bytes, data: bytes,
                aad: bytes | None) -> bytes:
        aad = aad or b""
        ks = _chacha20_keystream(self._key, 0, nonce,
                                 64 + len(data))
        otk = ks[:32].tobytes()
        ct = (np.frombuffer(data, dtype=np.uint8) ^
              ks[64:]).tobytes()
        return ct + self._tag(otk, ct, aad)

    def decrypt(self, nonce: bytes, data: bytes,
                aad: bytes | None) -> bytes:
        aad = aad or b""
        if len(data) < 16:
            raise AEADInvalidTag("ciphertext shorter than the tag")
        ct, tag = data[:-16], data[-16:]
        ks = _chacha20_keystream(self._key, 0, nonce, 64 + len(ct))
        if not _hmac.compare_digest(
                self._tag(ks[:32].tobytes(), ct, aad), tag):
            raise AEADInvalidTag("authentication failed")
        return (np.frombuffer(ct, dtype=np.uint8) ^ ks[64:]).tobytes()


# ---------------------------------------------------------------------
# X25519 (RFC 7748)

_P = 2 ** 255 - 19
_A24 = 121665


def _decode_scalar(k: bytes) -> int:
    b = bytearray(k)
    b[0] &= 248
    b[31] &= 127
    b[31] |= 64
    return int.from_bytes(b, "little")


def x25519(scalar: bytes, u_bytes: bytes) -> bytes:
    """Montgomery-ladder scalar multiplication on Curve25519."""
    k = _decode_scalar(scalar)
    u = int.from_bytes(u_bytes, "little") & ((1 << 255) - 1)
    x1, x2, z2, x3, z3 = u, 1, 0, u, 1
    swap = 0
    for t in reversed(range(255)):
        k_t = (k >> t) & 1
        if swap ^ k_t:
            x2, x3 = x3, x2
            z2, z3 = z3, z2
        swap = k_t
        a = (x2 + z2) % _P
        aa = (a * a) % _P
        b = (x2 - z2) % _P
        bb = (b * b) % _P
        e = (aa - bb) % _P
        c = (x3 + z3) % _P
        d = (x3 - z3) % _P
        da = (d * a) % _P
        cb = (c * b) % _P
        x3 = (da + cb) % _P
        x3 = (x3 * x3) % _P
        z3 = (da - cb) % _P
        z3 = (u * z3 * z3) % _P
        x2 = (aa * bb) % _P
        z2 = (e * (aa + _A24 * e)) % _P
    if swap:
        x2, x3 = x3, x2
        z2, z3 = z3, z2
    out = (x2 * pow(z2, _P - 2, _P)) % _P
    return out.to_bytes(32, "little")


_BASEPOINT = (9).to_bytes(32, "little")


def x25519_keypair() -> tuple[bytes, bytes]:
    priv = secrets.token_bytes(32)
    return priv, x25519(priv, _BASEPOINT)
