"""Pure-python secp256k1 ECDSA.

The port's copy of cometbft_tpu/crypto/_secp256k1_math.py.  It signs and
verifies for crypto/secp256k1.py and crypto/secp256k1eth.py on every
host: the port does not use OpenSSL bindings.  Jacobian-coordinate
point arithmetic keeps sign/verify at a few ms; signatures use the
RFC 6979 deterministic nonce, which interoperates with (and is
indistinguishable on the wire from) an OpenSSL signer.

Not constant-time: these key types verify on the host, inline in the
commit walk; signing here serves tests and tools.
"""
from __future__ import annotations

import hashlib
import hmac

P = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEFFFFFC2F
N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8
G = (_GX, _GY)

# affine points are (x, y) tuples; None is the point at infinity


def _jac_double(pt):
    x, y, z = pt
    if not y:
        return (0, 0, 0)
    ysq = (y * y) % P
    s = (4 * x * ysq) % P
    m = (3 * x * x) % P          # a == 0 for secp256k1
    nx = (m * m - 2 * s) % P
    ny = (m * (s - nx) - 8 * ysq * ysq) % P
    nz = (2 * y * z) % P
    return (nx, ny, nz)


def _jac_add(p, q):
    if not p[1]:
        return q
    if not q[1]:
        return p
    u1 = (p[0] * q[2] * q[2]) % P
    u2 = (q[0] * p[2] * p[2]) % P
    s1 = (p[1] * q[2] ** 3) % P
    s2 = (q[1] * p[2] ** 3) % P
    if u1 == u2:
        if s1 != s2:
            return (0, 0, 1)     # inverse points -> infinity
        return _jac_double(p)
    h = (u2 - u1) % P
    r = (s2 - s1) % P
    h2 = (h * h) % P
    h3 = (h * h2) % P
    u1h2 = (u1 * h2) % P
    nx = (r * r - h3 - 2 * u1h2) % P
    ny = (r * (u1h2 - nx) - s1 * h3) % P
    nz = (h * p[2] * q[2]) % P
    return (nx, ny, nz)


def _jac_from_affine(pt):
    return (pt[0], pt[1], 1)


def _jac_to_affine(pt):
    x, y, z = pt
    if not y or not z:
        return None
    zinv = pow(z, P - 2, P)
    zinv2 = (zinv * zinv) % P
    return ((x * zinv2) % P, (y * zinv2 * zinv) % P)


def scalar_mult(k: int, pt) -> tuple[int, int] | None:
    """k * pt (affine in, affine out; None = infinity)."""
    if pt is None or k % N == 0:
        return None
    k %= N
    acc = (0, 0, 1)
    add = _jac_from_affine(pt)
    while k:
        if k & 1:
            acc = _jac_add(acc, add)
        add = _jac_double(add)
        k >>= 1
    return _jac_to_affine(acc)


def _mod_sqrt(a: int) -> int | None:
    """sqrt mod P (P % 4 == 3)."""
    r = pow(a, (P + 1) // 4, P)
    return r if (r * r) % P == a % P else None


def decode_point(raw: bytes) -> tuple[int, int]:
    """Parse a 33-byte compressed or 65-byte uncompressed point,
    verifying curve membership."""
    if len(raw) == 33 and raw[0] in (2, 3):
        x = int.from_bytes(raw[1:], "big")
        if x >= P:
            raise ValueError("x out of range")
        y = _mod_sqrt((pow(x, 3, P) + 7) % P)
        if y is None:
            raise ValueError("not a curve point")
        if (y & 1) != (raw[0] & 1):
            y = P - y
        return (x, y)
    if len(raw) == 65 and raw[0] == 4:
        x = int.from_bytes(raw[1:33], "big")
        y = int.from_bytes(raw[33:], "big")
        if x >= P or y >= P or (y * y - pow(x, 3, P) - 7) % P:
            raise ValueError("not a curve point")
        return (x, y)
    raise ValueError("malformed point encoding")


def encode_compressed(pt: tuple[int, int]) -> bytes:
    return bytes([2 + (pt[1] & 1)]) + pt[0].to_bytes(32, "big")


def encode_uncompressed(pt: tuple[int, int]) -> bytes:
    return b"\x04" + pt[0].to_bytes(32, "big") + \
        pt[1].to_bytes(32, "big")


def pub_point(d: int) -> tuple[int, int]:
    return scalar_mult(d, G)


# ---------------------------------------------------------------------
# ECDSA

def _rfc6979_k(d: int, digest: bytes):
    """Deterministic nonce stream (RFC 6979, SHA-256)."""
    x = d.to_bytes(32, "big")
    v = b"\x01" * 32
    k = b"\x00" * 32
    mac = lambda key, msg: hmac.new(key, msg,            # noqa: E731
                                    hashlib.sha256).digest()
    k = mac(k, v + b"\x00" + x + digest)
    v = mac(k, v)
    k = mac(k, v + b"\x01" + x + digest)
    v = mac(k, v)
    while True:
        v = mac(k, v)
        cand = int.from_bytes(v, "big")
        if 0 < cand < N:
            yield cand
        k = mac(k, v + b"\x00")
        v = mac(k, v)


def sign(d: int, digest: bytes) -> tuple[int, int]:
    """(r, s) over a 32-byte digest; the caller low-S-normalizes."""
    z = int.from_bytes(digest, "big")
    for k in _rfc6979_k(d, digest):
        pt = scalar_mult(k, G)
        r = pt[0] % N
        if not r:
            continue
        s = (pow(k, N - 2, N) * (z + r * d)) % N
        if s:
            return r, s


def verify(pub: tuple[int, int], digest: bytes, r: int,
           s: int) -> bool:
    if not (0 < r < N and 0 < s < N):
        return False
    z = int.from_bytes(digest, "big")
    w = pow(s, N - 2, N)
    u1 = (z * w) % N
    u2 = (r * w) % N
    pt = _jac_add(
        _jac_from_affine(scalar_mult(u1, G)) if u1 else (0, 0, 1),
        _jac_from_affine(scalar_mult(u2, pub)) if u2 else (0, 0, 1))
    aff = _jac_to_affine(pt)
    if aff is None:
        return False
    return aff[0] % N == r
