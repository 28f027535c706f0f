"""secp256k1eth: Ethereum-compatible secp256k1 keys.

Reference: crypto/secp256k1eth/secp256k1eth.go, through
cometbft_tpu/crypto/secp256k1eth.py.  Differences from the Cosmos
secp256k1 type:
  * Address = last 20 bytes of Keccak-256(uncompressed pubkey sans 0x04
    prefix) — the Ethereum address rule (go-ethereum crypto.PubkeyToAddress);
  * pubkey serialized UNCOMPRESSED (65 bytes, 0x04 || X || Y);
  * signatures are 64-byte R || S over Keccak-256(msg), lower-S enforced.

Sign and verify go through crypto/_secp256k1_math.py, as for secp256k1.
"""
from __future__ import annotations

import secrets

from . import _secp256k1_math as _sp
from ._keccak import keccak256
from .keys import PrivKey, PubKey
from .secp256k1 import _N, _low_s, _rs

KEY_TYPE = "secp256k1eth"
ENABLED = True             # the build flag of the reference's key type
PRIV_KEY_SIZE = 32
PUB_KEY_SIZE = 65          # uncompressed: 0x04 || X || Y
SIG_SIZE = 64


class Secp256k1EthPubKey(PubKey):
    __slots__ = ("_raw", "_addr")

    def __init__(self, raw: bytes):
        if len(raw) != PUB_KEY_SIZE or raw[0] != 0x04:
            raise ValueError(
                f"secp256k1eth pubkey must be {PUB_KEY_SIZE} bytes "
                f"starting 0x04")
        self._raw = bytes(raw)
        self._addr: bytes | None = None

    def address(self) -> bytes:
        """Ethereum rule: Keccak-256(X||Y)[12:]."""
        if self._addr is None:
            self._addr = keccak256(self._raw[1:])[12:]
        return self._addr

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return KEY_TYPE

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        rs = _rs(sig)
        if rs is None:
            return False
        try:
            return _sp.verify(_sp.decode_point(self._raw), keccak256(msg),
                              *rs)
        except ValueError:
            return False


class Secp256k1EthPrivKey(PrivKey):
    __slots__ = ("_raw", "_d")

    def __init__(self, raw: bytes):
        if len(raw) != PRIV_KEY_SIZE:
            raise ValueError(
                f"secp256k1eth privkey must be {PRIV_KEY_SIZE} bytes")
        d = int.from_bytes(raw, "big")
        if not (0 < d < _N):
            raise ValueError("secp256k1eth privkey scalar out of range")
        self._raw = bytes(raw)
        self._d = d

    def bytes(self) -> bytes:
        return self._raw

    def sign(self, msg: bytes) -> bytes:
        return _low_s(*_sp.sign(self._d, keccak256(msg)))

    def pub_key(self) -> Secp256k1EthPubKey:
        return Secp256k1EthPubKey(_sp.encode_uncompressed(
            _sp.pub_point(self._d)))

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> Secp256k1EthPrivKey:
    while True:
        raw = secrets.token_bytes(PRIV_KEY_SIZE)
        d = int.from_bytes(raw, "big")
        if 0 < d < _N:
            return Secp256k1EthPrivKey(raw)
