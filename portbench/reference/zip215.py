"""ed25519 verification under ZIP-215, in plain Python integers.

ZIP-215 (https://zips.z.cash/zip-0215), which CometBFT follows through
curve25519-voi and the port follows in its kernel:

  * s must be canonical (s < L);
  * A and R decode with a y that may be at or above p (taken mod p), and
    with x = 0 under either sign bit;
  * the check is cofactored: [8]([s]B - R - [k]A) is the identity, with
    k = SHA-512(R || A || M) mod L over the bytes as given.

Slow (two scalar multiplications of ~250 additions each) and only used
where OpenSSL's strict RFC 8032 check refuses a signature
(``commit.signature_ok``).
"""
from __future__ import annotations

import hashlib

P = 2 ** 255 - 19
L = 2 ** 252 + 27742317777372353535851937790883648493
D = -121665 * pow(121666, P - 2, P) % P
D2 = 2 * D % P
SQRT_M1 = pow(2, (P - 1) // 4, P)
IDENTITY = (0, 1, 1, 0)


def _recover_x(y: int, sign: int):
    """x with x^2 = (y^2 - 1) / (d y^2 + 1) and parity ``sign``; None if
    there is no square root.  x = 0 is kept whatever the sign bit."""
    u = (y * y - 1) % P
    v = (D * y * y + 1) % P
    x = u * pow(v, 3, P) * pow(u * pow(v, 7, P), (P - 5) // 8, P) % P
    vxx = v * x * x % P
    if vxx == (-u) % P:
        x = x * SQRT_M1 % P
    elif vxx != u:
        return None
    if x != 0 and (x & 1) != sign:
        x = P - x
    return x


def decode(b: bytes):
    """32 bytes -> a point in extended coordinates, or None."""
    if len(b) != 32:
        return None
    raw = int.from_bytes(b, "little")
    y = (raw & ((1 << 255) - 1)) % P
    x = _recover_x(y, raw >> 255)
    if x is None:
        return None
    return (x, y, 1, x * y % P)


def add(p1, p2):
    """Unified addition in extended coordinates (add-2008-hwcd-3)."""
    x1, y1, z1, t1 = p1
    x2, y2, z2, t2 = p2
    a = (y1 - x1) * (y2 - x2) % P
    b = (y1 + x1) * (y2 + x2) % P
    c = t1 * D2 * t2 % P
    d = 2 * z1 * z2 % P
    e, f, g, h = b - a, d - c, d + c, b + a
    return (e * f % P, g * h % P, f * g % P, e * h % P)


def neg(p):
    x, y, z, t = p
    return ((-x) % P, y, z, (-t) % P)


def mul(k: int, p):
    out = IDENTITY
    while k:
        if k & 1:
            out = add(out, p)
        p = add(p, p)
        k >>= 1
    return out


def is_identity(p) -> bool:
    x, y, z, _ = p
    return x % P == 0 and (y - z) % P == 0


_BY = 4 * pow(5, P - 2, P) % P
B = (_recover_x(_BY, 0), _BY, 1, _recover_x(_BY, 0) * _BY % P)


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    if len(pub) != 32 or len(sig) != 64:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:
        return False
    a = decode(pub)
    r = decode(sig[:32])
    if a is None or r is None:
        return False
    k = int.from_bytes(hashlib.sha512(sig[:32] + pub + msg).digest(),
                       "little") % L
    q = add(add(mul(s, B), neg(r)), neg(mul(k, a)))
    for _ in range(3):
        q = add(q, q)
    return is_identity(q)
