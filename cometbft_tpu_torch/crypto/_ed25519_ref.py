"""Pure-Python ed25519 with ZIP-215 verification semantics.

The golden model of the port: the CUDA kernel, its plain PyTorch version
and the host prep are all held to it, and it signs the commits the tests
and the chip smoke build.  ZIP-215 (reference: crypto/ed25519/ed25519.go:36-44):

  * S must be canonical (S < L); non-canonical S is rejected.
  * A and R encodings are accepted permissively: y >= p is allowed, and
    "negative zero" x-coordinates are allowed.
  * The *cofactored* equation is used: [8]S·B == [8]R + [8]k·A, so
    small-order components never affect the verdict.

Arithmetic uses Python big ints: slow, but exact.
"""
from __future__ import annotations

import hashlib

P = 2**255 - 19
L = 2**252 + 27742317777372353535851937790883648493
D = (-121665 * pow(121666, P - 2, P)) % P
SQRT_M1 = pow(2, (P - 1) // 4, P)  # sqrt(-1) mod p

# Base point B
_BY = (4 * pow(5, P - 2, P)) % P


def _recover_x(y: int, sign: int) -> int | None:
    """Recover x from y and the sign bit; permissive (ZIP-215) rules.

    Returns None if y^2-1 / (d*y^2+1) is not a square (invalid encoding).
    Accepts x == 0 with sign == 1 ("negative zero") per ZIP-215.
    """
    yy = (y * y) % P
    u = (yy - 1) % P
    v = (D * yy + 1) % P
    # candidate root: x = u * v^3 * (u * v^7)^((p-5)/8)
    v3 = (v * v % P) * v % P
    v7 = (v3 * v3 % P) * v % P
    x = (u * v3 % P) * pow(u * v7 % P, (P - 5) // 8, P) % P
    vxx = (v * x % P) * x % P
    if vxx == u:
        pass
    elif vxx == (P - u) % P:
        x = (x * SQRT_M1) % P
    else:
        return None
    if (x & 1) != sign:
        x = (P - x) % P
    return x


def decompress(s: bytes) -> tuple[int, int] | None:
    """Decode a 32-byte point encoding under ZIP-215 permissive rules.

    Non-canonical y (y >= p) is accepted: y is reduced mod p.
    """
    if len(s) != 32:
        return None
    n = int.from_bytes(s, "little")
    sign = n >> 255
    y = (n & ((1 << 255) - 1)) % P  # permissive: reduce non-canonical y
    x = _recover_x(y, sign)
    if x is None:
        return None
    return (x, y)


def compress(pt: tuple[int, int]) -> bytes:
    x, y = pt
    return (y | ((x & 1) << 255)).to_bytes(32, "little")


# -- group ops (affine via extended coordinates internally) -----------------

def _ext(pt):
    x, y = pt
    return (x, y, 1, x * y % P)


def _unext(e):
    X, Y, Z, _ = e
    zi = pow(Z, P - 2, P)
    return (X * zi % P, Y * zi % P)


def _ext_add(p, q):
    # add-2008-hwcd-3 (unified, complete for a=-1 twisted Edwards)
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    A = (Y1 - X1) * (Y2 - X2) % P
    B = (Y1 + X1) * (Y2 + X2) % P
    C = 2 * D * T1 % P * T2 % P
    Dd = 2 * Z1 * Z2 % P
    E = B - A
    F = Dd - C
    G = Dd + C
    H = B + A
    return (E * F % P, G * H % P, F * G % P, E * H % P)


def _ext_double(p):
    return _ext_add(p, p)


def point_add(p, q):
    return _unext(_ext_add(_ext(p), _ext(q)))


def scalar_mult(k: int, pt) -> tuple[int, int]:
    e = _ext(pt)
    acc = (0, 1, 1, 0)  # identity
    while k > 0:
        if k & 1:
            acc = _ext_add(acc, e)
        e = _ext_double(e)
        k >>= 1
    return _unext(acc)


B = scalar_mult(1, (_recover_x(_BY, 0), _BY))  # base point affine


def is_identity_cofactored(pt) -> bool:
    """True iff [8]pt == identity (pt is in the small-order subgroup)."""
    e = _ext(pt)
    for _ in range(3):
        e = _ext_double(e)
    x, y = _unext(e)
    return x == 0 and y == 1


# -- hashing / scalars -------------------------------------------------------

def sha512_mod_l(*parts: bytes) -> int:
    h = hashlib.sha512()
    for part in parts:
        h.update(part)
    return int.from_bytes(h.digest(), "little") % L


# -- key ops -----------------------------------------------------------------

def secret_expand(seed: bytes) -> tuple[int, bytes]:
    h = hashlib.sha512(seed).digest()
    a = int.from_bytes(h[:32], "little")
    a &= (1 << 254) - 8
    a |= 1 << 254
    return a, h[32:]


def public_key(seed: bytes) -> bytes:
    a, _ = secret_expand(seed)
    return compress(scalar_mult(a, B))


def sign(seed: bytes, msg: bytes) -> bytes:
    a, prefix = secret_expand(seed)
    A = compress(scalar_mult(a, B))
    r = sha512_mod_l(prefix, msg)
    Rp = scalar_mult(r, B)
    Rb = compress(Rp)
    k = sha512_mod_l(Rb, A, msg)
    s = (r + k * a) % L
    return Rb + s.to_bytes(32, "little")


def verify(pub: bytes, msg: bytes, sig: bytes) -> bool:
    """ZIP-215 single verification: cofactored, permissive A/R decoding."""
    if len(sig) != 64 or len(pub) != 32:
        return False
    s = int.from_bytes(sig[32:], "little")
    if s >= L:  # non-canonical S rejected
        return False
    A = decompress(pub)
    if A is None:
        return False
    R = decompress(sig[:32])
    if R is None:
        return False
    k = sha512_mod_l(sig[:32], pub, msg)
    # [8](S·B - R - k·A) == identity
    sB = scalar_mult(s, B)
    kA = scalar_mult(k, A)
    neg = lambda p: ((P - p[0]) % P, p[1])  # noqa: E731
    chk = point_add(sB, point_add(neg(R), neg(kA)))
    return is_identity_cofactored(chk)
