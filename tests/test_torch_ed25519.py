"""The port's batch ed25519 verification against the ZIP-215 golden
model (cometbft_tpu/crypto/_ed25519_ref.py) and the JAX package's host
prep and constants: verify_cols_plain (the CUDA kernel's plain version)
and verify_batch(device="cpu") on the cases of tests/test_ops_ed25519.py
(TestVerifyKernel / TestPallasKernel).  Inputs come from a seeded numpy
generator; verdicts are booleans, so tolerance is exact equality.

The kernel itself is held to the plain version on the card by the
``cuda``-marked test below (skipped without a GPU) and by chip_smoke.py.
"""
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_ref as ref
from cometbft_tpu.ops import ed25519_jax as ej
from cometbft_tpu.ops import ed25519_pallas as ep
from cometbft_tpu.ops import field24 as f24
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field as F
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CPU = "cpu"


class _Gen:
    """Seeded signatures and edge-case encodings."""

    def __init__(self, seed):
        self.rng = np.random.default_rng(seed)

    def bytes(self, n):
        return self.rng.bytes(n)

    def sig(self, msg=None):
        seed = self.bytes(32)
        msg = self.bytes(37) if msg is None else msg
        return ref.public_key(seed), msg, ref.sign(seed, msg)

    def small_order_point(self):
        while True:
            pt = ref.decompress(self.bytes(32))
            if pt is None:
                continue
            tor = ref.scalar_mult(ref.L, pt)
            if tor != (0, 1):
                return tor


def _golden(items):
    return [ref.verify(p, m, s) for p, m, s in items]


def _plain(items):
    """verify_cols_plain on the port's own prep, one bucket."""
    m = oe._bucket(len(items))
    a, r, s, k, bad = oe.prep_arrays(items, m)
    dev = torch.device(CPU)
    ok = ek.verify_cols_plain(oe.to_cols(a, dev), oe.to_cols(r, dev),
                              oe.to_cols(s, dev), oe.to_cols(k, dev))
    ok = ok.numpy()[:len(items)].copy()
    ok[bad[:len(items)]] = False
    return ok.tolist(), ok


def _cases(name):
    g = _Gen({"valid_and_corrupted": 1, "non_canonical_s": 2,
              "small_order": 3, "non_canonical_y": 4, "random_mix": 5,
              "negative_zero": 6}[name])
    if name == "valid_and_corrupted":
        items = [g.sig() for _ in range(3)]
        pub, msg, sig = items[0]
        items += [
            (pub, msg, sig[:10] + bytes([sig[10] ^ 0xFF]) + sig[11:]),
            (pub, b"wrong message", sig),
            (pub, msg, sig[:32] + bytes(32)),          # s = 0
            (pub, msg, bytes([sig[0] ^ 1]) + sig[1:]),
        ]
    elif name == "non_canonical_s":
        pub, msg, sig = g.sig()
        s = int.from_bytes(sig[32:], "little") + ref.L
        items = [(pub, msg, sig[:32] + s.to_bytes(32, "little")),
                 (pub, msg, sig)]
    elif name == "small_order":
        a = ref.compress(g.small_order_point())
        r = ref.compress(g.small_order_point())
        items = [(a, m, r + bytes(32)) for m in (b"", b"arbitrary")]
    elif name == "non_canonical_y":
        enc = (F.P + 1).to_bytes(32, "little")   # y = p+1 == identity
        a = ref.compress(g.small_order_point())
        items = [(a, b"m", enc + bytes(32))]
    elif name == "negative_zero":
        # x = 0 with the sign bit set: the identity and the order-2
        # point (0, -1), both accepted by ZIP-215
        neg_ident = bytearray((1).to_bytes(32, "little"))
        neg_ident[31] |= 0x80
        neg_two = bytearray((F.P - 1).to_bytes(32, "little"))
        neg_two[31] |= 0x80
        items = [(bytes(neg_two), b"m", bytes(neg_ident) + bytes(32)),
                 (bytes(neg_ident), b"x", bytes(neg_two) + bytes(32))]
    else:
        items = []
        for i in range(10):
            pub, msg, sig = g.sig()
            if i % 3 == 2:
                sig = sig[:32] + g.bytes(32)
            if i % 4 == 3:
                pub = g.bytes(32)
            items.append((pub, msg, sig))
    return items


CASES = ["valid_and_corrupted", "non_canonical_s", "small_order",
         "non_canonical_y", "negative_zero", "random_mix"]


@pytest.mark.parametrize("name", CASES)
def test_verify_batch_matches_golden(name):
    items = _cases(name)
    golden = _golden(items)
    ok, mask = oe.verify_batch(items, device=CPU)
    assert mask == golden
    assert ok == all(golden)
    if name == "small_order":
        assert golden == [True, True]          # cofactored: must accept
    if name == "valid_and_corrupted":
        assert golden == [True] * 3 + [False] * 4


def test_verify_cols_plain_matches_golden_on_mixed_lanes():
    items = (_cases("valid_and_corrupted") + _cases("negative_zero") +
             _cases("non_canonical_y"))
    assert _plain(items)[0] == _golden(items)


def test_padding_lanes_verify_trivially():
    """1 real item in a 64-lane bucket: the 63 padding lanes (A = B,
    R = identity, s = k = 0) verify true and leave the real lane's
    verdict alone."""
    item = _Gen(8).sig()
    a, r, s, k, bad = oe.prep_arrays([item], 64)
    dev = torch.device(CPU)
    ok = ek.verify_cols_plain(oe.to_cols(a, dev), oe.to_cols(r, dev),
                              oe.to_cols(s, dev), oe.to_cols(k, dev))
    assert ok.tolist() == [True] * 64
    assert not bad.any()


def test_empty_batch():
    assert oe.verify_batch([], device=CPU) == (True, [])


def test_batch_spanning_two_tiles(monkeypatch):
    """n = 70 at tile 64 plans two balanced 35-lane tiles; the mask is
    the per-signature golden mask, malformed lanes included, and the
    CPU path launches no kernel."""
    g = _Gen(9)
    items, golden = [], []
    base = [g.sig() for _ in range(4)]
    for i in range(70):
        pub, msg, sig = base[i % 4]
        if i in (3, 41):
            sig = sig[:32] + bytes(32)              # S = 0
        if i == 50:
            msg = msg + b"tampered"
        if i == 66:
            pub = b"short"
        items.append((pub, msg, sig))
        golden.append(ref.verify(pub, msg, sig))
    monkeypatch.setenv("COMETBFT_TPU_TORCH_VERIFY_TILE", "64")
    before = ek.launches
    ok, mask = oe.verify_batch(items, device=CPU)
    assert mask == golden and not ok
    assert ek.launches == before


def test_prep_arrays_byte_identical_to_reference():
    g = _Gen(10)
    items = [g.sig() for _ in range(5)]
    pub, msg, sig = items[0]
    s_big = (int.from_bytes(sig[32:], "little") + ref.L).to_bytes(32, "little")
    items += [(pub, msg, sig[:32] + s_big),              # S >= L
              (pub, msg, sig[:32] + ref.L.to_bytes(32, "little")),
              (b"short", msg, sig), (pub, msg, sig[:63]),
              (pub, b"", sig)]
    for m in (16, 64):
        got = oe.prep_arrays(items, m)
        want = ej.prep_arrays(items, m)
        for x, y in zip(got, want):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert np.array_equal(x, y)


def test_b_table_matches_pallas_constants():
    """The kernel's affine i·B table equals ed25519_pallas._B_TABLE_NP
    entry by entry as integers mod p."""
    assert len(ek.B_TABLE) == 16
    for i in range(16):
        for c in range(3):
            want = f24.from_limbs(ep._B_TABLE_NP[i, c, :, 0])
            assert F.from_limbs(ek.B_TABLE[i][c]) == want, (i, c)
    consts = ek.CONSTS
    assert F.from_limbs(consts[0:10]) == ref.D
    assert F.from_limbs(consts[10:20]) == 2 * ref.D % ref.P
    assert F.from_limbs(consts[20:30]) == ref.SQRT_M1


def test_window_layout_matches_reference():
    rng = np.random.default_rng(12)
    scalars = rng.integers(0, 256, size=(9, 32), dtype=np.uint8)
    assert np.array_equal(oe._windows_u8(scalars), ej._windows_u8(scalars))
    assert oe._BASE_BUCKETS == ej._BASE_BUCKETS
    for n in (1, 64, 65, 4096, 4097, 10000, 20000):
        assert oe._bucket(n) == ej._bucket(n)


@pytest.mark.cuda
def test_kernel_matches_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    items = (_cases("valid_and_corrupted") + _cases("negative_zero") +
             _cases("small_order") + _cases("random_mix"))
    a, r, s, k, bad = oe.prep_arrays(items, 64)
    dev = torch.device("cuda")
    cols = [oe.to_cols(x, dev) for x in (a, r, s, k)]
    before = ek.launches
    got = ek.verify_cols(*cols)
    torch.cuda.synchronize()
    assert ek.launches == before + 1
    assert torch.equal(got, ek.verify_cols_plain(*cols))
    mask = got.cpu().numpy()[:len(items)].copy()
    mask[bad[:len(items)]] = False
    assert mask.tolist() == _golden(items)
