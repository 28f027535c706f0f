"""The port's host BLS library (ops/csrc/bls_native.cpp through
ops/bls_native.py) against its plain version (the port's
crypto/_bls12381_math.py, the reference's Python formulas without their
native shortcut) and against the JAX package, byte for byte:

  * hash_to_g2, G1 and G2 uncompression of valid, off-curve,
    non-subgroup and infinity encodings, the subgroup checks, point sums
    (with a cancelling pair and a doubling), scalar multiples and
    pairings products (true, false, with an infinity) — the raw-point
    C ABI of the reference's native/_native.cpp:535-760;
  * a failed g++ build and a failed self-test raise: there is no
    fallback to the Python formulas;
  * with every function of the plain module made to raise, every BLS
    entry point still works, so the plain version is on no path;
  * the Bls12381BatchVerifier cases of tests/test_batch_grouped.py:43-88
    and the exact multi-bad mask and bisection count of
    tests/test_aggregate_commit.py:742-776 give the reference's verdicts
    and masks.

Points, bytes and verdicts: the tolerance is exact equality.  The
Python formulas are slow (a pairing costs ~0.3 s), so they run on a
handful of inputs only.
"""
import ctypes
import hashlib
from pathlib import Path

import pytest

from cometbft_tpu.crypto import _bls12381_math as r_m
from cometbft_tpu.crypto import _native_loader
from cometbft_tpu.crypto import bls12381 as r_bls
from cometbft_tpu_torch.crypto import _bls12381_math as m
from cometbft_tpu_torch.crypto import batch as p_batch
from cometbft_tpu_torch.crypto import bls12381 as p_bls
from cometbft_tpu_torch.ops import _build
from cometbft_tpu_torch.ops import bls_native as nat
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(scope="module", autouse=True)
def _reference_native():
    """The reference runs its BLS in pure Python unless its native
    module is built: build it."""
    _native_loader.load()


def _scalar(tag: bytes) -> int:
    return int.from_bytes(hashlib.sha256(tag).digest(), "big") % m.R_ORDER


def _off_subgroup_g1():
    """A point on y^2 = x^3 + 4 outside the order-r subgroup."""
    x = 5
    while True:
        y = m._sqrt_fq((x ** 3 + 4) % m.P)
        if y is not None:
            return (x, y)
        x += 1


def _off_subgroup_g2():
    x = (3, 1)
    while True:
        y = m._sqrt_fq2(m.f2_add(m.f2_mul(m.f2_sqr(x), x), m.G2_B))
        if y is not None:
            return (x, y)
        x = (x[0] + 1, x[1])


def _off_curve_x_g1():
    x = 7
    while m._sqrt_fq((x ** 3 + 4) % m.P) is not None:
        x += 1
    return x


# -- the library against the plain formulas and the reference -----------

def test_library_passes_selftest():
    assert nat.selftest()
    assert _build.bls_build_info["path"].startswith(str(_build.BUILD_DIR))


@pytest.mark.parametrize("msg", [b"", b"precommit 7", bytes(range(256))])
def test_hash_to_g2_matches_plain_and_reference(msg):
    got = nat.hash_to_g2(msg, p_bls.DST)
    assert got == m._g2_raw(m.hash_to_g2(msg, p_bls.DST))
    assert got == r_m._g2_raw(r_m.hash_to_g2(msg, p_bls.DST))


def _g1_encodings():
    good = m.pt_mul(m.G1_OPS, m.G1_GEN, _scalar(b"g1"))
    x_bad = _off_curve_x_g1()
    off_curve = bytearray(x_bad.to_bytes(48, "big"))
    off_curve[0] |= 0x80
    out_of_range = bytearray(m.P.to_bytes(48, "big"))
    out_of_range[0] |= 0x80
    comp = m.g1_compress(good)
    return {
        "valid": comp,
        "valid_other_y": m.g1_compress(m.pt_neg(m.G1_OPS, good)),
        "non_subgroup": m.g1_compress(_off_subgroup_g1()),
        "off_curve": bytes(off_curve),
        "x_out_of_range": bytes(out_of_range),
        "infinity": bytes([0xC0]) + bytes(47),
        "bad_infinity": bytes([0xC0]) + bytes(46) + b"\x01",
        "infinity_with_sign": bytes([0xE0]) + bytes(47),
        "uncompressed_flag": bytes([comp[0] & 0x7F]) + comp[1:],
    }


def _g2_encodings():
    good = m.pt_mul(m.G2_OPS, m.G2_GEN, _scalar(b"g2"))
    off = (5, 5)
    while m._sqrt_fq2(m.f2_add(m.f2_mul(m.f2_sqr(off), off), m.G2_B)):
        off = (off[0] + 1, off[1])
    off_curve = bytearray(off[1].to_bytes(48, "big") +
                          off[0].to_bytes(48, "big"))
    off_curve[0] |= 0x80
    comp = m.g2_compress(good)
    return {
        "valid": comp,
        "valid_other_y": m.g2_compress(m.pt_neg(m.G2_OPS, good)),
        "non_subgroup": m.g2_compress(_off_subgroup_g2()),
        "off_curve": bytes(off_curve),
        "infinity": bytes([0xC0]) + bytes(95),
        "bad_infinity": bytes([0xC0]) + bytes(94) + b"\x01",
        "uncompressed_flag": bytes([comp[0] & 0x7F]) + comp[1:],
    }


def _uncompress_outcome(fn, unraw, data):
    try:
        pt = fn(data)
    except ValueError:
        return "ValueError"
    return unraw(pt) if isinstance(pt, bytes) else pt


def test_g1_uncompress_matches_plain_and_reference():
    for name, data in _g1_encodings().items():
        got = _uncompress_outcome(nat.g1_uncompress, m._g1_unraw, data)
        plain = _uncompress_outcome(m.g1_uncompress, None, data)
        ref = _uncompress_outcome(r_m.g1_uncompress, None, data)
        assert got == plain == ref, name


def test_g2_uncompress_matches_plain_and_reference():
    for name, data in _g2_encodings().items():
        got = _uncompress_outcome(nat.g2_uncompress, m._g2_unraw, data)
        plain = _uncompress_outcome(m.g2_uncompress, None, data)
        ref = _uncompress_outcome(r_m.g2_uncompress, None, data)
        assert got == plain == ref, name


def test_subgroup_checks_match_plain_and_reference():
    g1 = m.pt_mul(m.G1_OPS, m.G1_GEN, _scalar(b"sg1"))
    g2 = m.pt_mul(m.G2_OPS, m.G2_GEN, _scalar(b"sg2"))
    off_curve_g1 = (g1[0], (g1[1] + 1) % m.P)
    cases_g1 = [g1, _off_subgroup_g1(), off_curve_g1, None]
    for pt in cases_g1:
        got = nat.g1_in_subgroup(m._g1_raw(pt))
        assert got == m.g1_in_subgroup(pt) == r_m.g1_in_subgroup(pt)
    assert [nat.g1_in_subgroup(m._g1_raw(p)) for p in cases_g1] == \
        [True, False, False, True]
    cases_g2 = [g2, _off_subgroup_g2(), None]
    for pt in cases_g2:
        got = nat.g2_in_subgroup(m._g2_raw(pt))
        assert got == m.g2_in_subgroup(pt) == r_m.g2_in_subgroup(pt)
    assert [nat.g2_in_subgroup(m._g2_raw(p)) for p in cases_g2] == \
        [True, False, True]


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_sum_and_mul_match_plain_and_reference(group):
    ops, gen, raw, rraw = (
        (m.G1_OPS, m.G1_GEN, m._g1_raw, r_m._g1_raw) if group == "g1" else
        (m.G2_OPS, m.G2_GEN, m._g2_raw, r_m._g2_raw))
    rops = r_m.G1_OPS if group == "g1" else r_m.G2_OPS
    nsum = nat.g1_sum if group == "g1" else nat.g2_sum
    nmul = nat.g1_mul if group == "g1" else nat.g2_mul
    a = m.pt_mul(ops, gen, _scalar(b"a" + group.encode()))
    b = m.pt_mul(ops, gen, _scalar(b"b" + group.encode()))
    off = _off_subgroup_g1() if group == "g1" else _off_subgroup_g2()
    sets = [[a], [a, b], [a, a, b], [a, m.pt_neg(ops, a)],
            [a, b, m.pt_neg(ops, a), off], [b, b, b, b, b]]
    for pts in sets:
        got = nsum(b"".join(raw(p) for p in pts))
        assert got == raw(m.pt_sum(ops, pts)) == rraw(r_m.pt_sum(rops, pts))
    for pt in (a, off):
        for k in (1, 2, _scalar(b"k"), m.R_ORDER, m.R_ORDER - 1, 0):
            got = nmul(raw(pt), k)
            assert got == raw(m.pt_mul(ops, pt, k)) == \
                rraw(r_m.pt_mul(rops, pt, k)), (k, pt is off)
    assert nmul(b"", 5) == b""
    assert nsum(b"") == b""


def test_pairings_products_match_plain_and_reference():
    a, b = _scalar(b"pa"), _scalar(b"pb")
    h = m.hash_to_g2(b"pairing", p_bls.DST)
    g1a = m.pt_mul(m.G1_OPS, m.G1_GEN, a)
    g1b = m.pt_mul(m.G1_OPS, m.G1_GEN, b)
    g1ab = m.pt_neg(m.G1_OPS, m.pt_mul(m.G1_OPS, m.G1_GEN, (a + b) % m.R_ORDER))
    true_pairs = [(g1a, h), (g1b, h), (g1ab, h)]
    false_pairs = [(g1a, h), (g1a, h), (g1ab, h)]
    with_infinity = [(None, h), (g1a, None), (g1a, h),
                     (m.pt_neg(m.G1_OPS, g1a), h)]
    for pairs, want in ((true_pairs, True), (false_pairs, False),
                        (with_infinity, True)):
        got = nat.pairings_product_is_one(
            [(m._g1_raw(p), m._g2_raw(q)) for p, q in pairs])
        assert got is want
        assert r_m.pairings_product_is_one(pairs) is want
    assert m.pairings_product_is_one(true_pairs) is True
    assert m.pairings_product_is_one(false_pairs) is False
    assert nat.pairings_product_is_one([]) is True


def test_out_of_range_coordinates_raise():
    big = m.P.to_bytes(48, "big") * 2
    with pytest.raises(ValueError, match="coordinate"):
        nat.g1_in_subgroup(big)
    with pytest.raises(ValueError, match="length"):
        nat.g1_in_subgroup(bytes(95))
    with pytest.raises(ValueError, match="multiple of 96"):
        nat.g1_sum(bytes(97))


# -- no fallback ----------------------------------------------------------

def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "HOST_FLAGS",
                        (*_build.HOST_FLAGS, "--no-such-flag"))
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        _build.build_bls()
    assert not list(tmp_path.glob("cometbft_bls-*.so"))


def test_failed_selftest_raises(monkeypatch):
    real = ctypes.CDLL(str(_build.build_bls()))

    class Broken:
        def __getattr__(self, name):
            return getattr(real, name)

    broken = Broken()
    broken.bls_selftest = lambda: 0
    monkeypatch.setattr(_build, "_bls_lib", None)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: broken)
    with pytest.raises(RuntimeError, match="self-test"):
        _build.load_bls()
    assert _build._bls_lib is None


def test_plain_formulas_are_on_no_path(monkeypatch):
    from cometbft_tpu_torch.libs.bits import BitArray
    from cometbft_tpu_torch.types import validation as pv
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.commit import AggregateCommit
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet

    def boom(*_a, **_k):
        raise AssertionError("a plain BLS formula was called")

    for name, obj in list(vars(m).items()):
        if callable(obj) and getattr(obj, "__module__", "") == m.__name__:
            monkeypatch.setattr(m, name, boom)
    pv.reset_aggregate_caches()
    privs = [p_bls.gen_priv_key_from_secret(b"no-path-%d" % i)
             for i in range(4)]
    pubs = [p.pub_key() for p in privs]
    sigs = [p.sign(b"m") for p in privs]
    assert all(pk.verify_signature(b"m", s) for pk, s in zip(pubs, sigs))
    agg = p_bls.aggregate_signatures(sigs)
    assert p_bls.verify_aggregate(p_bls.aggregate_pub_keys(pubs), b"m", agg)
    assert p_bls.fast_aggregate_verify(pubs, b"m", agg)
    msgs = [b"m%d" % i for i in range(4)]
    assert p_bls.aggregate_verify(pubs, msgs, p_bls.aggregate_signatures(
        [p.sign(x) for p, x in zip(privs, msgs)]))
    bv = p_bls.Bls12381BatchVerifier()
    for p, x in zip(privs, msgs):
        bv.add(p.pub_key(), x, p.sign(x if x != b"m2" else b"forged"))
    assert bv.verify() == (False, [True, True, False, True])

    vals = ValidatorSet([Validator.new(pk, 10) for pk in pubs])
    bid = BlockID(b"h" * 32, PartSetHeader(1, b"p" * 32))
    commit = AggregateCommit(height=3, round=0, block_id=bid,
                             signers=BitArray.from_indices(4, range(4)))
    sb = commit.vote_sign_bytes("c")
    by_addr = {pk.address(): p for pk, p in zip(pubs, privs)}
    commit.signature = p_bls.aggregate(
        [by_addr[v.address].sign(sb) for v in vals.validators])
    assert vals.hash()
    pv.verify_commit("c", vals, bid, 3, commit, device="cpu")
    pv.verify_commit_light_trusting("c", vals, commit, pv.Fraction(1, 3),
                                    signer_vals=vals, device="cpu")


# -- the batch verifier (tests/test_batch_grouped.py:43-88,
#    tests/test_aggregate_commit.py:742-776) ------------------------------

def _keys(n, tag=b"grouped-%d"):
    return ([r_bls.gen_priv_key_from_secret(tag % i) for i in range(n)],
            [p_bls.gen_priv_key_from_secret(tag % i) for i in range(n)])


def _both_masks(n, bad=(), garbage=(), tag=b"grouped-%d"):
    """Each package's (ok, mask) on the same triples."""
    out = []
    for privs, mod in zip(_keys(n, tag), (r_bls, p_bls)):
        bv = mod.Bls12381BatchVerifier()
        for i, p in enumerate(privs):
            msg = b"vote %d" % i
            sig = p.sign(b"forged" if i in bad else msg)
            if i in garbage:
                sig = b"\xff" * 96
            bv.add(p.pub_key(), msg, sig)
        ok, mask = bv.verify()
        out.append((ok, list(mask)))
    return out


@pytest.mark.parametrize("n, bad, garbage, want", [
    (3, (), (), [True, True, True]),             # test_all_valid
    (3, (1,), (), [True, False, True]),          # flags exactly the bad one
    (2, (), (1,), [True, False]),                # garbage signature bytes
    (1, (), (), [True]),                         # single item
    (9, (1, 4, 8), (),                           # exact multi-bad mask
     [i not in (1, 4, 8) for i in range(9)]),
])
def test_batch_verifier_matches_reference(n, bad, garbage, want):
    ref, port = _both_masks(n, bad, garbage)
    assert port == ref == (all(want), want)


def test_batch_verifier_empty():
    assert p_bls.Bls12381BatchVerifier().verify() == \
        r_bls.Bls12381BatchVerifier().verify() == (False, [])


def test_bisection_skips_good_subtrees(monkeypatch):
    """One bad signature among 8: exactly two per-signature checks (the
    failing leaf and its pair sibling), as in the reference."""
    _, privs = _keys(8)
    bv = p_bls.Bls12381BatchVerifier()
    for i, p in enumerate(privs):
        msg = b"m%d" % i
        bv.add(p.pub_key(), msg, p.sign(b"bad" if i == 5 else msg))
    singles = []
    orig = p_bls.Bls12381PubKey.verify_signature
    monkeypatch.setattr(p_bls.Bls12381PubKey, "verify_signature",
                        lambda self, msg, sig: singles.append(1) or
                        orig(self, msg, sig))
    ok, mask = bv.verify()
    assert not ok and mask == [True] * 5 + [False] + [True] * 2
    assert len(singles) == 2


def test_dispatch_creates_bls_verifier():
    pk = _keys(1)[1][0].pub_key()
    assert p_batch.supports_batch_verifier(pk)
    bv = p_batch.create_batch_verifier(pk, device="cpu")
    assert isinstance(bv, p_batch.TracedBatchVerifier)
    assert isinstance(bv._inner, p_bls.Bls12381BatchVerifier)
    assert bv._backend == "bls_native"
    assert p_bls.KEY_TYPE == r_bls.KEY_TYPE


def test_csrc_holds_verbatim_copies_of_the_headers():
    """bls12381.hpp and its SHA-256 headers are copies of native/'s, so
    the library computes what the reference's native module does."""
    repo = Path(__file__).resolve().parents[1]
    for name in ("bls12381.hpp", "sha256.hpp", "sha256_ni.hpp"):
        assert (repo / "cometbft_tpu_torch/ops/csrc" / name).read_bytes() \
            == (repo / "native" / name).read_bytes()
