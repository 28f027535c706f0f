"""ChaCha20-Poly1305 (RFC 8439) on the host CPU
(ops/csrc/chacha20poly1305.cpp).

Counterpart of the JAX package's two AEAD paths for the secret
connection (cometbft_tpu/p2p/secret_connection.py:17-35: the
``cryptography`` package's OpenSSL, else the reference's native module
behind crypto/_aead_fallback.py).  The port takes one path: this
library, built with g++ at first use, which passes its self-test on the
RFC 8439 section 2.8.2 vector before the first answer
(ops/_build.load_aead); a failed build or self-test raises, and there is
no fallback.  ctypes drops the GIL for each call.  crypto/_aead_ref.py is
the plain version; only the tests and chip_smoke.py call it, to hold
this library to it.
"""
from __future__ import annotations

import ctypes

from . import _build

TAG_SIZE = 16
KEY_SIZE = 32
NONCE_SIZE = 12


class AEADInvalidTag(Exception):
    pass


def load() -> None:
    """Build, load and self-test the library now."""
    _build.load_aead()


class ChaCha20Poly1305:
    """The ``cryptography`` package's surface: ``encrypt(nonce, data,
    aad) -> ciphertext || tag``; ``decrypt`` raises AEADInvalidTag on a
    tag that does not match."""

    def __init__(self, key: bytes):
        if len(key) != KEY_SIZE:
            raise ValueError("ChaCha20Poly1305 key must be 32 bytes")
        self._key = bytes(key)
        self._lib = _build.load_aead()

    def encrypt(self, nonce: bytes, data: bytes,
                aad: bytes | None) -> bytes:
        if len(nonce) != NONCE_SIZE:
            raise ValueError("ChaCha20Poly1305 nonce must be 12 bytes")
        aad = aad or b""
        out = ctypes.create_string_buffer(len(data) + TAG_SIZE)
        self._lib.aead_seal(self._key, nonce, aad, len(aad), data,
                            len(data), out)
        return out.raw

    def decrypt(self, nonce: bytes, data: bytes,
                aad: bytes | None) -> bytes:
        if len(nonce) != NONCE_SIZE:
            raise ValueError("ChaCha20Poly1305 nonce must be 12 bytes")
        aad = aad or b""
        if len(data) < TAG_SIZE:
            raise AEADInvalidTag("ciphertext shorter than the tag")
        out = ctypes.create_string_buffer(max(1, len(data) - TAG_SIZE))
        if self._lib.aead_open(self._key, nonce, aad, len(aad), data,
                               len(data), out) != 1:
            raise AEADInvalidTag("authentication failed")
        return out.raw[:len(data) - TAG_SIZE]
