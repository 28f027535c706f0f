"""The port's key types, key codec, merkle root and validator-set hash
against the JAX package's, on the same seeded inputs.

  * secp256k1, secp256k1eth and bls12381 keys derived from one seed have
    the same public key bytes and address in both packages; BLS
    signatures are deterministic and byte-identical; the port's
    secp256k1 signatures (RFC 6979) equal the reference's own
    ``_secp256k1_math.sign`` output, low-S normalised, and each package
    accepts the other's signatures (the reference signs through OpenSSL
    with a random nonce where ``cryptography`` is installed);
  * verdicts agree on a valid signature, a malleated one (high S; for
    BLS the flipped sign flag), a wrong length, a flipped bit and a key
    that is not a curve point (reference: crypto/secp256k1.py:87-109,
    crypto/bls12381.py:79-143);
  * the codec (crypto/encoding.py) round-trips all four key types and
    rejects what the reference rejects, with the same text;
  * ``merkle.hash_from_byte_slices`` (crypto/merkle.py:17-63) and
    ``ValidatorSet.hash()`` (types/validator_set.py:323-335) give the
    reference's bytes, and ``index_by_address`` (:77-88) its indices.

Everything compared is bytes or a verdict: the tolerance is exact
equality.
"""
import hashlib

import numpy as np
import pytest

from cometbft_tpu.crypto import _native_loader
from cometbft_tpu.crypto import _secp256k1_math as r_sm
from cometbft_tpu.crypto import bls12381 as r_bls
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.crypto import encoding as r_enc
from cometbft_tpu.crypto import merkle as r_merkle
from cometbft_tpu.crypto import secp256k1 as r_secp
from cometbft_tpu.crypto import secp256k1eth as r_eth
from cometbft_tpu.crypto._keccak import keccak256
from cometbft_tpu.types.validator import Validator as RValidator
from cometbft_tpu.types.validator_set import ValidatorSet as RValidatorSet
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.crypto import bls12381 as p_bls
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import encoding as p_enc
from cometbft_tpu_torch.crypto import merkle as p_merkle
from cometbft_tpu_torch.crypto import secp256k1 as p_secp
from cometbft_tpu_torch.crypto import secp256k1eth as p_eth
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

N = r_sm.N


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The reference runs its BLS in pure Python unless its native
    module is built (a verify takes ~0.7 s that way): build it."""
    _native_loader.load()


def _seeds(tag, n):
    return [hashlib.sha256(b"%s/%d" % (tag, i)).digest() for i in range(n)]


def _pairs(kind, n=3):
    """(reference privkey, port privkey) pairs from one seed each."""
    out = []
    for seed in _seeds(kind.encode(), n):
        if kind == "secp256k1":
            out.append((r_secp.gen_priv_key_from_secret(seed),
                        p_secp.gen_priv_key_from_secret(seed)))
        elif kind == "secp256k1eth":
            raw = (int.from_bytes(seed, "big") % (N - 1) + 1).to_bytes(
                32, "big")
            out.append((r_eth.Secp256k1EthPrivKey(raw),
                        p_eth.Secp256k1EthPrivKey(raw)))
        else:
            out.append((r_bls.gen_priv_key_from_secret(seed),
                        p_bls.gen_priv_key_from_secret(seed)))
    return out


KINDS = ["secp256k1", "secp256k1eth", "bls12_381"]


@pytest.mark.parametrize("kind", KINDS)
def test_public_keys_and_addresses_match(kind):
    for r, p in _pairs(kind):
        assert p.bytes() == r.bytes()
        assert p.pub_key().bytes() == r.pub_key().bytes()
        assert p.pub_key().address() == r.pub_key().address()
        assert p.pub_key().type() == r.pub_key().type() == kind


@pytest.mark.parametrize("kind", ["secp256k1", "secp256k1eth"])
def test_secp_signature_is_the_reference_rfc6979_signature(kind):
    digest = (lambda m: hashlib.sha256(m).digest()) if kind == "secp256k1" \
        else keccak256
    for i, (r, p) in enumerate(_pairs(kind)):
        msg = b"vote %d" % i
        rr, ss = r_sm.sign(int.from_bytes(r.bytes(), "big"), digest(msg))
        if ss > N // 2:
            ss = N - ss
        sig = p.sign(msg)
        assert sig == rr.to_bytes(32, "big") + ss.to_bytes(32, "big")
        # each package accepts the other's signature
        assert r.pub_key().verify_signature(msg, sig)
        assert p.pub_key().verify_signature(msg, r.sign(msg))


def test_bls_signatures_are_byte_identical():
    for i, (r, p) in enumerate(_pairs("bls12_381")):
        msg = b"precommit %d" % i
        assert p.sign(msg) == r.sign(msg)
        assert p.pub_key().verify_signature(msg, r.sign(msg))


def _flip(sig, i=10):
    return sig[:i] + bytes([sig[i] ^ 0x04]) + sig[i + 1:]


def _malleated(kind, sig):
    if kind == "bls12_381":
        return bytes([sig[0] ^ 0x20]) + sig[1:]     # the other y
    s = int.from_bytes(sig[32:], "big")
    return sig[:32] + (N - s).to_bytes(32, "big")   # high S


def _off_curve_key(kind, pub):
    """The key's bytes moved off the curve, x (or y) + 1 until the
    equation fails."""
    if kind == "secp256k1":
        x = int.from_bytes(pub[1:], "big")
        while r_sm._mod_sqrt((pow(x, 3, r_sm.P) + 7) % r_sm.P) is not None:
            x += 1
        return pub[:1] + x.to_bytes(32, "big")
    if kind == "secp256k1eth":
        y = (int.from_bytes(pub[33:], "big") + 1) % r_sm.P
        return pub[:33] + y.to_bytes(32, "big")
    y = int.from_bytes(pub[48:], "big") + 1
    return pub[:48] + y.to_bytes(48, "big")


CASES = ["valid", "malleated", "wrong_length", "flipped_bit",
         "wrong_message", "off_curve_key"]


def _outcome(fn):
    try:
        return fn()
    except Exception as e:  # noqa: BLE001 — compared by type and text
        return type(e).__name__, str(e)


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("kind", KINDS)
def test_verdicts_match_reference(kind, case):
    r, p = _pairs(kind, 1)[0]
    msg = b"the signed message"
    sig = r.sign(msg)
    pub = r.pub_key().bytes()
    vmsg = msg
    if case == "malleated":
        sig = _malleated(kind, sig)
    elif case == "wrong_length":
        sig = sig[:-1]
    elif case == "flipped_bit":
        sig = _flip(sig)
    elif case == "wrong_message":
        vmsg = msg + b"!"
    elif case == "off_curve_key":
        pub = _off_curve_key(kind, pub)
    want = _outcome(lambda: r_enc.pub_key_from_type_and_bytes(
        kind, pub).verify_signature(vmsg, sig))
    got = _outcome(lambda: p_enc.pub_key_from_type_and_bytes(
        kind, pub).verify_signature(vmsg, sig))
    assert got == want
    assert (want is True) == (case == "valid")


def _all_keys():
    seed = bytes(range(32))
    return [r_ed.Ed25519PrivKey(seed).pub_key()] + \
        [r.pub_key() for kind in KINDS for r, _ in _pairs(kind, 1)]


def test_codec_round_trip_matches_reference():
    for rk in _all_keys():
        d = r_enc.pub_key_to_proto(rk)
        pk = p_enc.pub_key_from_proto(d)
        assert p_enc.pub_key_to_proto(pk) == d
        assert pk.type() == rk.type() and pk.bytes() == rk.bytes()
        assert pk.address() == rk.address()
        same = p_enc.pub_key_from_type_and_bytes(rk.type(), rk.bytes())
        assert same == pk


@pytest.mark.parametrize("bad", [
    ("ed25519", b"\x01" * 31), ("secp256k1", b"\x02" * 32),
    ("secp256k1eth", b"\x05" + b"\x01" * 64),
    ("bls12_381", b"\x01" * 95), ("bls12_381", b"\xc0" + bytes(95)),
    ("bls12_381", b"\x40" + bytes(95)), ("sr25519", b"\x01" * 32)])
def test_codec_rejects_what_the_reference_rejects(bad):
    kind, raw = bad
    want = _outcome(lambda: r_enc.pub_key_from_type_and_bytes(kind, raw))
    got = _outcome(lambda: p_enc.pub_key_from_type_and_bytes(kind, raw))
    assert got[0] == want[0] == "EncodingError"
    assert got[1] == want[1]


@pytest.mark.parametrize("n", [0, 1, 2, 3, 7, 8, 9, 1000])
def test_merkle_root_matches_reference(n):
    rng = np.random.default_rng(n)
    items = [rng.bytes(int(k)) for k in rng.integers(0, 80, n)]
    assert p_merkle.hash_from_byte_slices(items) == \
        r_merkle.hash_from_byte_slices(items)


def _mixed_reference_set(n_ed, n_secp, n_eth, n_bls, powers=None):
    keys = ([r_ed.gen_priv_key_from_secret(s).pub_key()
             for s in _seeds(b"ed", n_ed)] +
            [r.pub_key() for r, _ in _pairs("secp256k1", n_secp)] +
            [r.pub_key() for r, _ in _pairs("secp256k1eth", n_eth)] +
            [r.pub_key() for r, _ in _pairs("bls12_381", n_bls)])
    powers = powers or [10 + i for i in range(len(keys))]
    return RValidatorSet([RValidator.new(k, pw)
                          for k, pw in zip(keys, powers)])


SETS = {
    "ed25519": (5, 0, 0, 0),
    "mixed": (3, 2, 2, 3),
    "bls": (0, 0, 0, 4),
    "one_validator": (0, 1, 0, 0),
}


@pytest.mark.parametrize("name", sorted(SETS))
def test_validator_set_hash_matches_reference(name):
    ref = _mixed_reference_set(*SETS[name])
    for port in (convert.validator_set(ref.to_proto()),
                 convert.validator_set(ref.to_proto())):
        assert port.hash() == ref.hash()
        assert [v.bytes() for v in port.validators] == \
            [v.bytes() for v in ref.validators]


def test_index_by_address_matches_reference():
    ref = _mixed_reference_set(*SETS["mixed"])
    port = convert.validator_set(ref.to_proto())
    for v in ref.validators:
        assert port.index_by_address(v.address) == \
            ref.index_by_address(v.address) >= 0
    assert port.index_by_address(b"\x00" * 20) == \
        ref.index_by_address(b"\x00" * 20) == -1


def test_port_keys_build_the_same_set_as_the_reference():
    """A set built from the port's own keys hashes as the reference's
    built from the same seeds."""
    ref = _mixed_reference_set(*SETS["mixed"])
    keys = ([p_ed.Ed25519PrivKey(r_ed.gen_priv_key_from_secret(s).bytes())
             .pub_key() for s in _seeds(b"ed", 3)] +
            [p.pub_key() for _, p in _pairs("secp256k1", 2)] +
            [p.pub_key() for _, p in _pairs("secp256k1eth", 2)] +
            [p.pub_key() for _, p in _pairs("bls12_381", 3)])
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    port = ValidatorSet([Validator.new(k, 10 + i)
                         for i, k in enumerate(keys)])
    assert port.hash() == ref.hash()
    assert port.to_proto() == ref.to_proto()
