"""ed25519 sign and single verification on the host CPU
(ops/csrc/ed25519_host.cpp).

Counterpart of the JAX package's OpenSSL calls
(cometbft_tpu/crypto/ed25519.py:8-37): the RFC 8032 sign and the ZIP-215
cofactored verify, one signature a call.  The library is built with g++
at first use and passes its self-test before the first answer
(ops/_build.load_ed25519_host); a failed build or self-test raises, and
there is no fallback.  ctypes drops the GIL for each call.  The golden
model (crypto/_ed25519_ref.py) is the plain version; only the tests and
chip_smoke.py call it, to hold this library to it.
"""
from __future__ import annotations

import ctypes

from . import _build


def _lib() -> ctypes.CDLL:
    return _build.load_ed25519_host()


def load() -> None:
    """Build, load and self-test the library now."""
    _lib()


def public_key(seed: bytes) -> bytes:
    """The 32-byte public key of a 32-byte seed."""
    if len(seed) != 32:
        raise ValueError("ed25519 seed must be 32 bytes")
    out = ctypes.create_string_buffer(32)
    _lib().ed25519_host_public_key(seed, out)
    return out.raw


def sign(seed: bytes, pub: bytes, msg: bytes) -> bytes:
    """The 64-byte signature of ``msg`` under ``seed`` (whose public key
    is ``pub``)."""
    if len(seed) != 32 or len(pub) != 32:
        raise ValueError("ed25519 seed and public key must be 32 bytes")
    out = ctypes.create_string_buffer(64)
    _lib().ed25519_host_sign(seed, pub, msg, len(msg), out)
    return out.raw


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 verification of one signature; a wrong length is False."""
    if len(pub) != 32 or len(sig) != 64:
        return False
    return _lib().ed25519_host_verify(pub, msg, len(msg), sig) == 1
