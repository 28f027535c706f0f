"""The host BLS12-381 library (ops/csrc/bls_native.cpp) at the level of
raw points.

Counterpart of the JAX package's ``bls_*`` native functions
(native/_native.cpp:535-760), which crypto/_bls12381_math.py reaches
through ``_native()``.  Points are the reference's raw wire form
(``_g1_raw`` / ``_g2_raw``): big-endian affine x || y, 96 bytes in G1
and 192 in G2, and ``b""`` for the point at infinity.  The library is
built with g++ at first use and passes its self-test before the first
answer (ops/_build.load_bls); a failed build or self-test raises.  There
is no Python fallback: crypto/_bls12381_math.py holds the plain
formulas, and only the tests call them, to hold this library to them.

A coordinate that is not below p raises ValueError, as the reference's
native functions do; the port's entry points never pass one (every
point comes from a checked decoding or from this library).
"""
from __future__ import annotations

import ctypes

import numpy as np

from . import _build

G1_BYTES = 96
G2_BYTES = 192

_ERRORS = {-1: "coordinate >= p", -2: "bad point length",
           -3: "invalid compressed point", -4: "DST too long"}


def _lib() -> ctypes.CDLL:
    return _build.load_bls()


def _check(rc: int, what: str) -> int:
    if rc < 0:
        raise ValueError(f"{what}: {_ERRORS.get(rc, rc)}")
    return rc


def _point(fn, width: int, what: str, *args) -> bytes:
    """Call a point-valued function; its raw result (b"" = infinity)."""
    out = ctypes.create_string_buffer(width)
    return b"" if _check(fn(*args, out), what) == 1 else out.raw


def selftest() -> bool:
    return _lib().bls_selftest() == 1


def pairings_product_is_one(pairs) -> bool:
    """prod e(P_i, Q_i) == 1 over (raw G1, raw G2) pairs."""
    pairs = list(pairs)
    n = len(pairs)
    g1 = b"".join(p.ljust(G1_BYTES, b"\0") for p, _ in pairs)
    g2 = b"".join(q.ljust(G2_BYTES, b"\0") for _, q in pairs)
    g1_lens = np.array([len(p) for p, _ in pairs], np.int64)
    g2_lens = np.array([len(q) for _, q in pairs], np.int64)
    return _check(_lib().bls_pairings_product_is_one(
        g1, g1_lens.ctypes.data, g2, g2_lens.ctypes.data, n),
        "pairings product") == 1


def g1_in_subgroup(p: bytes) -> bool:
    return _check(_lib().bls_g1_in_subgroup(p, len(p)), "G1") == 1


def g2_in_subgroup(q: bytes) -> bool:
    return _check(_lib().bls_g2_in_subgroup(q, len(q)), "G2") == 1


def hash_to_g2(msg: bytes, dst: bytes) -> bytes:
    return _point(_lib().bls_hash_to_g2, G2_BYTES, "hash_to_g2", msg,
                  len(msg), dst, len(dst))


def g1_uncompress(data: bytes):
    """Compressed 48 bytes -> raw G1, or None for infinity; an invalid
    encoding raises ValueError (as the reference's does)."""
    if len(data) != 48:
        raise ValueError("bad G1 compressed length")
    raw = _point(_lib().bls_g1_uncompress, G1_BYTES, "G1", data)
    return raw or None


def g2_uncompress(data: bytes):
    """Compressed 96 bytes -> raw G2, or None for infinity."""
    if len(data) != 96:
        raise ValueError("bad G2 compressed length")
    raw = _point(_lib().bls_g2_uncompress, G2_BYTES, "G2", data)
    return raw or None


def _scalar(k: int) -> bytes:
    if k < 0:
        raise ValueError("negative scalar")
    return k.to_bytes((k.bit_length() + 7) // 8, "big")


def g1_mul(p: bytes, k: int) -> bytes:
    kb = _scalar(k)
    return _point(_lib().bls_g1_mul, G1_BYTES, "G1", p, len(p), kb, len(kb))


def g2_mul(q: bytes, k: int) -> bytes:
    kb = _scalar(k)
    return _point(_lib().bls_g2_mul, G2_BYTES, "G2", q, len(q), kb, len(kb))


def g1_sum(blob: bytes) -> bytes:
    """The sum of raw G1 points laid end to end (none at infinity)."""
    if len(blob) % G1_BYTES:
        raise ValueError("blob not a multiple of 96")
    return _point(_lib().bls_g1_sum, G1_BYTES, "G1", blob,
                  len(blob) // G1_BYTES)


def g2_sum(blob: bytes) -> bytes:
    if len(blob) % G2_BYTES:
        raise ValueError("blob not a multiple of 192")
    return _point(_lib().bls_g2_sum, G2_BYTES, "G2", blob,
                  len(blob) // G2_BYTES)
