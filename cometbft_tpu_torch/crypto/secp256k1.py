"""secp256k1 ECDSA keys (Cosmos-style).

Reference: crypto/secp256k1/secp256k1.go, through
cometbft_tpu/crypto/secp256k1.py —
  * PrivKey 32 bytes, Sign = ECDSA over SHA-256(msg), 64-byte R||S output in
    lower-S form (secp256k1.go:120-131).
  * PubKey = 33-byte compressed point (secp256k1.go:137-143).
  * Address = RIPEMD160(SHA256(compressed pubkey)) — Bitcoin style
    (secp256k1.go:148-172).
  * VerifySignature rejects signatures not in lower-S form (malleability;
    secp256k1.go:188-218).

Signing (RFC 6979 nonce) and verification go through the pure-Python
curve arithmetic of crypto/_secp256k1_math.py on every host: the port
uses no OpenSSL bindings.  This key type never batches; the commit walk
verifies it inline.
"""
from __future__ import annotations

import hashlib
import secrets

from . import _secp256k1_math as _sp
from .keys import PrivKey, PubKey

KEY_TYPE = "secp256k1"
PRIV_KEY_SIZE = 32
PUB_KEY_SIZE = 33          # compressed: 02/03 parity byte + x-coordinate
SIG_SIZE = 64              # R || S

# Curve order (reference: secp256k1.S256().N).
_N = _sp.N
_HALF_N = _N // 2


def _sha256(b: bytes) -> bytes:
    return hashlib.sha256(b).digest()


def _rs(sig: bytes):
    """(r, s) of a 64-byte R||S in range and in lower-S form, else None
    (reference: secp256k1.go:188-218)."""
    if len(sig) != SIG_SIZE:
        return None
    r = int.from_bytes(sig[:32], "big")
    s = int.from_bytes(sig[32:], "big")
    if not (0 < r < _N) or not (0 < s < _N) or s > _HALF_N:
        return None
    return r, s


def _low_s(r: int, s: int) -> bytes:
    if s > _HALF_N:
        s = _N - s
    return r.to_bytes(32, "big") + s.to_bytes(32, "big")


class Secp256k1PubKey(PubKey):
    __slots__ = ("_raw", "_addr")

    def __init__(self, raw: bytes):
        if len(raw) != PUB_KEY_SIZE:
            raise ValueError(
                f"secp256k1 pubkey must be {PUB_KEY_SIZE} bytes, got {len(raw)}")
        self._raw = bytes(raw)
        self._addr: bytes | None = None

    def address(self) -> bytes:
        """Bitcoin-style RIPEMD160(SHA256(pubkey)). Ref secp256k1.go:148."""
        if self._addr is None:
            h = hashlib.new("ripemd160")
            h.update(_sha256(self._raw))
            self._addr = h.digest()
        return self._addr

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """64-byte R||S; rejects high-S (malleable) signatures; a key
        that is not a curve point verifies nothing."""
        rs = _rs(sig)
        if rs is None:
            return False
        try:
            return _sp.verify(_sp.decode_point(self._raw), _sha256(msg), *rs)
        except ValueError:
            return False


class Secp256k1PrivKey(PrivKey):
    __slots__ = ("_raw", "_d")

    def __init__(self, raw: bytes):
        if len(raw) != PRIV_KEY_SIZE:
            raise ValueError(
                f"secp256k1 privkey must be {PRIV_KEY_SIZE} bytes, got {len(raw)}")
        d = int.from_bytes(raw, "big")
        if not (0 < d < _N):
            raise ValueError("secp256k1 privkey scalar out of range")
        self._raw = bytes(raw)
        self._d = d

    def bytes(self) -> bytes:
        return self._raw

    def sign(self, msg: bytes) -> bytes:
        """ECDSA over SHA-256(msg); returns R||S with S normalized to the
        lower half-order. Ref secp256k1.go:120-131."""
        return _low_s(*_sp.sign(self._d, _sha256(msg)))

    def pub_key(self) -> Secp256k1PubKey:
        return Secp256k1PubKey(_sp.encode_compressed(_sp.pub_point(self._d)))

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> Secp256k1PrivKey:
    """Random scalar in (0, N). Ref secp256k1.go:62-88."""
    while True:
        raw = secrets.token_bytes(PRIV_KEY_SIZE)
        d = int.from_bytes(raw, "big")
        if 0 < d < _N:
            return Secp256k1PrivKey(raw)


def gen_priv_key_from_secret(secret: bytes) -> Secp256k1PrivKey:
    """Deterministic: k = (SHA256(secret) mod (N-1)) + 1.
    Ref secp256k1.go:93-118 GenPrivKeySecp256k1."""
    fe = int.from_bytes(_sha256(secret), "big")
    d = fe % (_N - 1) + 1
    return Secp256k1PrivKey(d.to_bytes(32, "big"))
