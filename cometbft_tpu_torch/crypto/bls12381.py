"""BLS12-381 keys (minimal-pubkey-size: pubkeys in G1, signatures in G2).

Reference: crypto/bls12381/key_bls12381.go, through
cometbft_tpu/crypto/bls12381.py —
  * PrivKey 32 bytes (blst.KeyGen / SecretKey.Serialize), Sign = compressed
    G2 point over hash_to_g2(msg, dstMinPk) (key_bls12381.go:112-116).
  * PubKey = 96-byte *uncompressed* G1 serialization (P1Affine.Serialize;
    const.go PubKeySize=96), KeyValidate = subgroup + non-infinity check
    (key_bls12381.go:158-169).
  * Address = SumTruncated(pubkey serialize) (key_bls12381.go:172-177).
  * VerifySignature group-checks the signature but allows infinity, since an
    aggregate can be infinite (key_bls12381.go:179-192).
  * DST "BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_" (key_bls12381.go:31).

Every curve operation — hash to G2, uncompression, subgroup checks,
scalar multiples, point sums and pairings products — runs in the host
library ops/csrc/bls_native.cpp (ops/bls_native.py), on points in its
raw wire form (big-endian affine coordinates, ``b""`` for infinity).
There is no Python fallback: crypto/_bls12381_math.py holds the plain
formulas the library is tested against, and no entry point here calls
them.  This module takes only constants from it and does the byte-level
encodings (flags, range and curve-equation checks) itself.

Aggregates (BASELINE config #5): aggregate_signatures,
aggregate_pub_keys_raw, verify_aggregate, fast_aggregate_verify and
aggregate_verify mirror the blst aggregate API the reference links
against; AggregatePubKeyCache memoises the G1 key sums of aggregate
commits; Bls12381BatchVerifier verifies independent triples with one
random-linear-combination pairings product.
"""
from __future__ import annotations

import hashlib
import hmac
import secrets
from collections import OrderedDict
from typing import Optional, Sequence

from . import tmhash
from ._bls12381_math import G1_GEN, P, R_ORDER
from .keys import BatchVerifier, PrivKey, PubKey, bisect_bad
from ..libs import metrics as libmetrics
from ..ops import bls_native as nat

KEY_TYPE = "bls12_381"
PRIV_KEY_SIZE = 32
PUB_KEY_SIZE = 96           # uncompressed G1
SIGNATURE_SIZE = 96         # compressed G2
DST = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_"

_G1_GEN_RAW = G1_GEN[0].to_bytes(48, "big") + G1_GEN[1].to_bytes(48, "big")
_NEG_G1_GEN_RAW = G1_GEN[0].to_bytes(48, "big") + \
    (P - G1_GEN[1]).to_bytes(48, "big")
_G1_INFINITY = bytes([0x40]) + bytes(95)
_G2_INFINITY = bytes([0xC0]) + bytes(95)
_HALF_P = (P - 1) // 2


class DeserializationError(ValueError):
    pass


class InfinitePubKeyError(ValueError):
    pass


def _hkdf_extract(salt: bytes, ikm: bytes) -> bytes:
    return hmac.new(salt, ikm, hashlib.sha256).digest()


def _hkdf_expand(prk: bytes, info: bytes, length: int) -> bytes:
    out = b""
    t = b""
    i = 1
    while len(out) < length:
        t = hmac.new(prk, t + info + bytes([i]), hashlib.sha256).digest()
        out += t
        i += 1
    return out[:length]


def keygen(ikm: bytes, key_info: bytes = b"") -> int:
    """draft-irtf-cfrg-bls-signature KeyGen (the algorithm behind
    blst.KeyGen, key_bls12381.go:66-74)."""
    if len(ikm) < 32:
        raise ValueError("IKM must be at least 32 bytes")
    salt = b"BLS-SIG-KEYGEN-SALT-"
    length = 48
    sk = 0
    while sk == 0:
        salt = hashlib.sha256(salt).digest()
        prk = _hkdf_extract(salt, ikm + b"\x00")
        okm = _hkdf_expand(prk, key_info + length.to_bytes(2, "big"), length)
        sk = int.from_bytes(okm, "big") % R_ORDER
    return sk


def _g1_decode(data: bytes) -> bytes:
    """Uncompressed 96 bytes -> raw G1 (b"" = infinity); the checks and
    messages of the reference's g1_deserialize (raises ValueError)."""
    flags = data[0]
    if flags & 0x80:
        # a 96-byte blob with the compressed flag set is NOT a valid
        # uncompressed encoding: pubkey bytes (and the addresses hashed
        # from them) must not be malleable
        raise ValueError("compressed flag in uncompressed G1 encoding")
    if flags & 0x40:
        if any(data[1:]):
            raise ValueError("bad G1 infinity encoding")
        return b""
    x = int.from_bytes(data[:48], "big")
    y = int.from_bytes(data[48:], "big")
    if x >= P or y >= P:
        raise ValueError("G1 coordinate out of range")
    if (y * y - x * x * x - 4) % P:
        raise ValueError("G1 point not on curve")
    return bytes(data)


def _g2_compress(raw: bytes) -> bytes:
    """Raw G2 -> ZCash-flag compressed 96 bytes (x.c1 || x.c0, 0x80
    compressed, 0x20 lexicographically larger y)."""
    if not raw:
        return _G2_INFINITY
    y0 = int.from_bytes(raw[96:144], "big")
    y1 = int.from_bytes(raw[144:], "big")
    larger = y1 > _HALF_P if y1 else y0 > _HALF_P
    out = bytearray(raw[48:96] + raw[:48])
    out[0] |= 0x80 | (0x20 if larger else 0)
    return bytes(out)


def _parse_signature(sig: bytes):
    """Compressed G2 -> raw point | None (infinity) | False (invalid)."""
    if len(sig) != SIGNATURE_SIZE:
        return False
    try:
        pt = nat.g2_uncompress(sig)
    except ValueError:
        return False
    if pt is not None and not nat.g2_in_subgroup(pt):
        return False
    return pt


def _pairs_hold(pk: bytes, msg: bytes, sig_pt: bytes) -> bool:
    """e(pk, H(m)) * e(-G1, sig) == 1."""
    return nat.pairings_product_is_one(
        [(pk, nat.hash_to_g2(msg, DST)), (_NEG_G1_GEN_RAW, sig_pt)])


class Bls12381PubKey(PubKey):
    __slots__ = ("_raw", "_pt")

    def __init__(self, raw: bytes):
        """Validates: deserializable, on curve, in G1 subgroup, not infinity
        (reference NewPublicKeyFromBytes + KeyValidate)."""
        if len(raw) != PUB_KEY_SIZE:
            raise DeserializationError(
                f"bls12381 pubkey must be {PUB_KEY_SIZE} bytes, got {len(raw)}")
        try:
            pt = _g1_decode(raw)
        except ValueError as e:
            raise DeserializationError(str(e)) from None
        if not pt:
            raise InfinitePubKeyError("bls12381: pubkey is infinite")
        if not nat.g1_in_subgroup(pt):
            raise DeserializationError("bls12381: pubkey not in G1 subgroup")
        self._raw = bytes(raw)
        self._pt = pt

    @classmethod
    def _from_raw_unchecked(cls, pt: bytes) -> "Bls12381PubKey":
        """Wrap an already-validated raw G1 point (a sum of validated
        keys; b"" = infinity), skipping the subgroup check."""
        self = object.__new__(cls)
        self._raw = pt or _G1_INFINITY
        self._pt = pt
        return self

    def address(self) -> bytes:
        return tmhash.sum_truncated(self._raw)

    def bytes(self) -> bytes:
        return self._raw

    def type(self) -> str:
        return KEY_TYPE

    def raw_point(self) -> bytes:
        """The key's raw G1 point (b"" = infinity)."""
        return self._pt

    def verify_signature(self, msg: bytes, sig: bytes) -> bool:
        """e(pk, H(m)) == e(G1, sig); signature is group-checked but may be
        infinite (aggregates can be — key_bls12381.go:185-188)."""
        sig_pt = _parse_signature(sig)
        if not sig_pt:
            return False    # invalid, or infinity: never one message
        return _pairs_hold(self._pt, msg, sig_pt)


class Bls12381PrivKey(PrivKey):
    __slots__ = ("_sk",)

    def __init__(self, raw: bytes):
        if len(raw) != PRIV_KEY_SIZE:
            raise DeserializationError(
                f"bls12381 privkey must be {PRIV_KEY_SIZE} bytes, got {len(raw)}")
        sk = int.from_bytes(raw, "big")
        if not (0 < sk < R_ORDER):
            raise DeserializationError("bls12381 privkey scalar out of range")
        self._sk = sk

    def bytes(self) -> bytes:
        return self._sk.to_bytes(PRIV_KEY_SIZE, "big")

    def sign(self, msg: bytes) -> bytes:
        return _g2_compress(nat.g2_mul(nat.hash_to_g2(msg, DST), self._sk))

    def pub_key(self) -> Bls12381PubKey:
        return Bls12381PubKey(nat.g1_mul(_G1_GEN_RAW, self._sk))

    def type(self) -> str:
        return KEY_TYPE


def gen_priv_key() -> Bls12381PrivKey:
    return gen_priv_key_from_secret(secrets.token_bytes(32))


def gen_priv_key_from_secret(secret: bytes) -> Bls12381PrivKey:
    """Reference GenPrivKeyFromSecret (key_bls12381.go:66-74): non-32-byte
    secrets are SHA-256'd into the KeyGen seed."""
    if len(secret) != 32:
        secret = hashlib.sha256(secret).digest()
    sk = keygen(secret)
    return Bls12381PrivKey(sk.to_bytes(PRIV_KEY_SIZE, "big"))


# --- aggregate API (blst P2Aggregate surface) -------------------------------

def aggregate_signatures(sigs: Sequence[bytes]) -> bytes:
    """Sum compressed-G2 signatures; raises on any invalid input."""
    if not sigs:
        raise ValueError("no signatures to aggregate")
    pts = []
    for sig in sigs:
        pt = _parse_signature(sig)
        if pt is False:
            raise ValueError("invalid signature in aggregate")
        if pt:
            pts.append(pt)
    return _g2_compress(nat.g2_sum(b"".join(pts)) if pts else b"")


# the name the aggregate-commit layer uses; same operation
aggregate = aggregate_signatures


def aggregate_pub_keys(
        pub_keys: Sequence[Bls12381PubKey]) -> Bls12381PubKey:
    """Sum already-validated pubkeys into one aggregate key (may be
    infinity; verify_aggregate rejects an infinite aggregate key)."""
    if not pub_keys:
        raise ValueError("no pubkeys to aggregate")
    return aggregate_pub_keys_raw(b"".join(pk.bytes() for pk in pub_keys))


def aggregate_pub_keys_raw(blob: bytes) -> Bls12381PubKey:
    """Sum pubkeys given as concatenated 96-byte raw serializations
    (the layout Bls12381PubKey.bytes() stores): the only O(n) step of
    aggregate-commit verification, G1 adds in the host library."""
    if not blob:
        raise ValueError("no pubkeys to aggregate")
    return Bls12381PubKey._from_raw_unchecked(nat.g1_sum(blob))


def verify_aggregate(agg_pub_key: Bls12381PubKey, msg: bytes,
                     agg_sig: bytes) -> bool:
    """O(1) verification of an aggregate signature over ONE shared
    message: e(agg_pk, H(m)) == e(G1, agg_sig), two Miller loops and
    one final exponentiation however many signers agg_pk sums."""
    pk_pt = agg_pub_key.raw_point()
    if not pk_pt:
        return False        # infinite aggregate key never verifies
    sig_pt = _parse_signature(agg_sig)
    if not sig_pt:
        return False
    return _pairs_hold(pk_pt, msg, sig_pt)


def fast_aggregate_verify(pub_keys: Sequence[Bls12381PubKey], msg: bytes,
                          sig: bytes) -> bool:
    """All signers over ONE message: aggregate pubkeys in G1, then a
    single pairing check."""
    if not pub_keys:
        return False
    sig_pt = _parse_signature(sig)
    if not sig_pt:
        return False
    pts = [pk.raw_point() for pk in pub_keys if pk.raw_point()]
    agg = nat.g1_sum(b"".join(pts)) if pts else b""
    if not agg:
        return False
    return _pairs_hold(agg, msg, sig_pt)


def aggregate_verify(pub_keys: Sequence[Bls12381PubKey],
                     msgs: Sequence[bytes], sig: bytes) -> bool:
    """Distinct-message aggregate: prod e(pk_i, H(m_i)) == e(G1, sig).
    Messages must be pairwise distinct (rogue-message rule)."""
    if not pub_keys or len(pub_keys) != len(msgs):
        return False
    if len(set(msgs)) != len(msgs):
        return False
    sig_pt = _parse_signature(sig)
    if not sig_pt:
        return False
    pairs = [(pk.raw_point(), nat.hash_to_g2(msg, DST))
             for pk, msg in zip(pub_keys, msgs)]
    pairs.append((_NEG_G1_GEN_RAW, sig_pt))
    return nat.pairings_product_is_one(pairs)


# --- aggregate-pubkey cache -------------------------------------------------
# Stable validator sets re-verify aggregate commits with the SAME
# (valset, signer bitmap) over and over: one cache hit skips the G1
# point-sum, leaving the constant 2-Miller-loop pairing as the whole
# cost of commit verification.

_AGG_PK_HITS = libmetrics.DEFAULT.counter(
    "crypto", "agg_pubkey_cache_hits",
    "Aggregate-pubkey cache hits (G1 point-sum skipped).")
_AGG_PK_MISSES = libmetrics.DEFAULT.counter(
    "crypto", "agg_pubkey_cache_misses",
    "Aggregate-pubkey cache misses (G1 point-sum performed).")
_AGG_PK_EVICTIONS = libmetrics.DEFAULT.counter(
    "crypto", "agg_pubkey_cache_evictions",
    "Aggregate-pubkey cache LRU evictions.")


class AggregatePubKeyCache:
    """LRU of aggregate pubkeys keyed (valset_hash, signer_bitmap).

    The key binds the SUM to the exact validator set revision and
    signer subset: a validator-set change rotates valset_hash, so
    stale sums can never serve a new set."""

    def __init__(self, capacity: int = 64):
        self.capacity = max(1, capacity)
        self._m: OrderedDict[tuple[bytes, bytes], Bls12381PubKey] = \
            OrderedDict()

    def get(self, valset_hash: bytes,
            signer_bitmap: bytes) -> Optional[Bls12381PubKey]:
        key = (valset_hash, signer_bitmap)
        pk = self._m.get(key)
        if pk is not None:
            self._m.move_to_end(key)
            _AGG_PK_HITS.add()
        else:
            _AGG_PK_MISSES.add()
        return pk

    def put(self, valset_hash: bytes, signer_bitmap: bytes,
            pk: Bls12381PubKey) -> None:
        """Callers insert only AFTER the aggregate signature verified
        against this sum: a stream of forged (bitmap, signature) pairs
        must not be able to evict the honest entries."""
        self._m[(valset_hash, signer_bitmap)] = pk
        if len(self._m) > self.capacity:
            self._m.popitem(last=False)
            _AGG_PK_EVICTIONS.add()

    def __len__(self) -> int:
        return len(self._m)


_AGG_PK_CACHE = AggregatePubKeyCache()


def aggregate_pubkey_cache() -> AggregatePubKeyCache:
    """The process-global cache (the verify paths have no node
    context)."""
    return _AGG_PK_CACHE


def reset_aggregate_pubkey_cache() -> None:
    """Empty the process-global cache (tests start from nothing)."""
    global _AGG_PK_CACHE
    _AGG_PK_CACHE = AggregatePubKeyCache()


class Bls12381BatchVerifier(BatchVerifier):
    """Batch verification of INDEPENDENT (pubkey, msg, sig) triples via
    a random-linear-combination pairings product:

        prod_i e([z_i]pk_i, H(m_i)) * e(-G1, sum_i [z_i]sig_i) == 1

    with fresh random 128-bit nonzero z_i, so n+1 Miller loops share
    ONE final exponentiation instead of n independent 2-pairing
    checks.  verify() returns (all_valid, per-signature mask); on a
    batch reject the failing entries are found by bisection
    (keys.bisect_bad)."""

    def __init__(self):
        self._items: list[tuple[Bls12381PubKey, bytes, bytes]] = []

    def add(self, pub_key: PubKey, msg: bytes, sig: bytes) -> None:
        if not isinstance(pub_key, Bls12381PubKey):
            raise ValueError("bls12381 batch verifier needs bls12381 keys")
        self._items.append((pub_key, msg, sig))

    def __len__(self) -> int:
        return len(self._items)

    def verify(self) -> tuple[bool, list[bool]]:
        n = len(self._items)
        if n == 0:
            return False, []
        parsed = [_parse_signature(sig) or None for _, _, sig in self._items]
        if n >= 2 and all(parsed):
            if self._rlc_holds(range(n), parsed):
                return True, [True] * n
            mask = [True] * n
            bisect_bad(
                list(range(n)), mask,
                lambda half: self._rlc_holds(half, parsed),
                lambda i: self._items[i][0].verify_signature(
                    self._items[i][1], self._items[i][2]))
            return all(mask), mask
        # degenerate (singleton / malformed sigs): per signature
        mask = [pk.verify_signature(msg, sig)
                for pk, msg, sig in self._items]
        return all(mask), mask

    def _rlc_holds(self, idxs, parsed) -> bool:
        """The random-linear-combination pairings product over a
        subset of items, with fresh 128-bit randomizers every call."""
        pairs, zsigs = [], []
        for i in idxs:
            pk, msg, _ = self._items[i]
            z = 1 | secrets.randbits(128)
            pairs.append((nat.g1_mul(pk.raw_point(), z),
                          nat.hash_to_g2(msg, DST)))
            zsigs.append(nat.g2_mul(parsed[i], z))
        agg_zsig = nat.g2_sum(b"".join(z for z in zsigs if z))
        if not agg_zsig:
            return False
        pairs.append((_NEG_G1_GEN_RAW, agg_zsig))
        return nat.pairings_product_is_one(pairs)
