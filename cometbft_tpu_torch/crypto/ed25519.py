"""ed25519 keys — the default validator key type.

Reference: crypto/ed25519/ed25519.go — ZIP-215 verification semantics
(:36-44) — through cometbft_tpu/crypto/ed25519.py.  Signing and
single-signature verification run the host library
(ops/ed25519_host.py, g++-built and self-tested at load; the JAX package
uses OpenSSL for both), which raises rather than falls back when it
cannot build.  The pure-Python golden model (crypto/_ed25519_ref.py) is
its plain version and is on no path.  Batches go through crypto/batch.py
and the CUDA kernel.
"""
from __future__ import annotations

import hashlib
import secrets

from ..ops import ed25519_host as host
from .keys import PrivKey, PubKey, address_hash

KEY_TYPE = "ed25519"
PUB_KEY_SIZE = 32
PRIV_KEY_SIZE = 64  # seed || pubkey, matching the reference's 64-byte privkey
SIGNATURE_SIZE = 64


class Ed25519PubKey(PubKey):
    __slots__ = ("_raw", "_addr")

    def __init__(self, raw: bytes):
        if len(raw) != PUB_KEY_SIZE:
            raise ValueError(f"ed25519 pubkey must be {PUB_KEY_SIZE} bytes")
        self._raw = bytes(raw)
        self._addr: bytes | None = None

    def address(self) -> bytes:
        if self._addr is None:
            self._addr = address_hash(self._raw)
        return self._addr

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        if len(sig) != SIGNATURE_SIZE:
            return False
        return host.verify(self._raw, msg, sig)


class Ed25519PrivKey(PrivKey):
    __slots__ = ("_seed", "_pub")

    def __init__(self, raw: bytes):
        # accept 32-byte seed or 64-byte seed||pub (reference format)
        if len(raw) == 64:
            raw = raw[:32]
        if len(raw) != 32:
            raise ValueError("ed25519 privkey must be 32-byte seed or 64 bytes")
        self._seed = bytes(raw)
        self._pub = host.public_key(self._seed)

    def bytes(self) -> bytes:
        return self._seed + self._pub  # 64-byte reference layout

    def sign(self, msg: bytes) -> bytes:
        return host.sign(self._seed, self._pub, msg)

    def pub_key(self) -> Ed25519PubKey:
        return Ed25519PubKey(self._pub)

    def type(self) -> str:
        return KEY_TYPE



def gen_priv_key() -> Ed25519PrivKey:
    return Ed25519PrivKey(secrets.token_bytes(32))


def gen_priv_key_from_secret(secret: bytes) -> Ed25519PrivKey:
    """Deterministic key from a secret (reference: GenPrivKeyFromSecret —
    seed = SHA-256(secret))."""
    return Ed25519PrivKey(hashlib.sha256(secret).digest())
