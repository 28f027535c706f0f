"""PubKey <-> proto PublicKey conversion for the four key types.

Reference: crypto/encoding/codec.go — oneof sum keyed by key type
(proto/cometbft/crypto/v1/keys.proto: ed25519=1, secp256k1=2, bls12381=3,
secp256k1eth=4) — through cometbft_tpu/crypto/encoding.py, with the
amino JSON names genesis files use.  The key-type registry (key
generation by name, private keys) is not ported yet.
"""
from __future__ import annotations

from . import bls12381, ed25519, secp256k1, secp256k1eth
from .keys import PubKey

# proto oneof field name per key type
_FIELD_BY_TYPE = {
    "ed25519": "ed25519",
    "secp256k1": "secp256k1",
    "bls12_381": "bls12381",
    "secp256k1eth": "secp256k1eth",
}


# amino-compatible JSON type tags (genesis files, reference:
# crypto/ed25519 PubKeyName and friends)
AMINO_PUBKEY_NAMES = {
    "ed25519": "tendermint/PubKeyEd25519",
    "secp256k1": "tendermint/PubKeySecp256k1",
    "bls12_381": "cometbft/PubKeyBls12_381",
    "secp256k1eth": "cometbft/PubKeySecp256k1eth",
}


class EncodingError(Exception):
    pass


def pub_key_to_proto(pk: PubKey) -> dict:
    field = _FIELD_BY_TYPE.get(pk.type())
    if field is None:
        raise EncodingError(f"unsupported key type {pk.type()}")
    return {field: pk.bytes()}


def pub_key_from_proto(d: dict) -> PubKey:
    try:
        if "ed25519" in d:
            return ed25519.Ed25519PubKey(d["ed25519"])
        if "secp256k1" in d:
            return secp256k1.Secp256k1PubKey(d["secp256k1"])
        if "bls12381" in d:
            return bls12381.Bls12381PubKey(d["bls12381"])
        if "secp256k1eth" in d:
            return secp256k1eth.Secp256k1EthPubKey(d["secp256k1eth"])
    except ValueError as e:
        raise EncodingError(str(e)) from None
    raise EncodingError(f"unsupported proto pubkey {sorted(d)}")


def pub_key_from_type_and_bytes(key_type: str, raw: bytes) -> PubKey:
    """Reference: crypto/encoding codec + internal/keytypes registry."""
    try:
        if key_type == ed25519.KEY_TYPE:
            return ed25519.Ed25519PubKey(raw)
        if key_type == secp256k1.KEY_TYPE:
            return secp256k1.Secp256k1PubKey(raw)
        if key_type == bls12381.KEY_TYPE:
            return bls12381.Bls12381PubKey(raw)
        if key_type == secp256k1eth.KEY_TYPE:
            return secp256k1eth.Secp256k1EthPubKey(raw)
    except ValueError as e:
        raise EncodingError(str(e)) from None
    raise EncodingError(f"unsupported key type {key_type}")
