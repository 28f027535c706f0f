"""The four-threads-a-signature schedule of the second CUDA verifier
(ops/csrc/ed25519_verify8.cu, B2) on its own 16-limb field, on the CPU.

  * The round helpers of ops/ed25519_kernel8.py (_quad_double, _quad_add,
    _quad_entry) against the _ext_* formulas of B2's plain verifier and
    the golden model's group law, mod p, as projective equality through
    field16.canonical.
  * The kernel's constant block: the B entries with 2d·T, laid out
    [limb][entry][coord].
  * A model of the kernel's whole schedule built from those helpers (the
    lane table of (X, Y, Z, 2d·T) entries, 64 windows, the tail) against
    verify_cols_plain and the ZIP-215 golden model.
  * The overflow rule: every operand of every product in the schedule is
    a sum of at most field16.MAX_LAZY resting values.

Inputs come from seeded numpy generators; every result is an integer or
a bool, so the tolerance is exact equality.  The ``cuda``-marked test
holds the kernel to verify_cols_plain on partial quads, warps and blocks;
it skips without a card.
"""
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_ref as jref
from cometbft_tpu_torch.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
from cometbft_tpu_torch.ops import field16 as F
from torch_helpers import Lazy
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

P = F.P
L = F.LIMBS
TWO_D = torch.tensor(F.balanced(2 * ref.D % P), dtype=torch.int64)


# --- points ------------------------------------------------------------------

def _torsion():
    """The 8 points of order dividing 8, from L·(a decodable point)."""
    rng = np.random.default_rng(40)
    while True:
        pt = ref.decompress(rng.bytes(32))
        if pt is None:
            continue
        t = ref.scalar_mult(ref.L, pt)
        pts = {ref.scalar_mult(k, t) for k in range(8)}
        if len(pts) == 8:
            return sorted(pts)


def _points(seed, n):
    """n random multiples of B, the identity and the 8 torsion points,
    each in extended coordinates with a random Z (resting limbs)."""
    rng = np.random.default_rng(seed)
    affine = [ref.scalar_mult(int(rng.integers(1, 2**62)), ref.B)
              for _ in range(n)] + [(0, 1)] + _torsion()
    rows = []
    for x, y in affine:
        z = int.from_bytes(rng.bytes(32), "little") % (P - 1) + 1
        rows.append([F.balanced(v) for v in
                     (x * z % P, y * z % P, z, x * y * z % P)])
    t = torch.tensor(rows, dtype=torch.int64)            # [m, 4, 16]
    return tuple(t.unbind(1)), affine


def _affine(p):
    """Extended (X, Y, Z, T) tensors -> [(x, y)] as ints, with the
    extended invariant X·Y == Z·T checked."""
    X, Y, Z, T = (F.canonical(c) for c in p)
    out = []
    for xr, yr, zr, tr in zip(X, Y, Z, T):
        x, y, z, t = (F.from_limbs(r) for r in (xr, yr, zr, tr))
        assert z != 0 and x * y % P == z * t % P
        zi = pow(z, P - 2, P)
        out.append((x * zi % P, y * zi % P))
    return out


def _same_points(p, q):
    """Projective equality, X1·Z2 == X2·Z1 etc., through canonical."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    for a, b in ((X1, X2), (Y1, Y2), (T1, T2)):
        assert F.eq(F.mul(a, Z2), F.mul(b, Z1)).all()


# --- the round helpers against the _ext_* formulas ---------------------------

def test_quad_double_is_ext_double():
    p, affine = _points(1, 64)
    got = ek8._quad_double(p)
    _same_points(got, ek8._ext_double(p))
    assert _affine(got) == [ref.point_add(a, a) for a in affine]


def test_quad_add_is_ext_add():
    p, affine = _points(2, 64)
    # pair each point with a shifted copy of the list: random + random,
    # random + identity, torsion + torsion, and p + p, p + (-p)
    q = tuple(torch.roll(c, 5, 0) for c in p)
    q_affine = affine[-5:] + affine[:-5]
    got = ek8._quad_add(p, ek8._quad_entry(q, TWO_D))
    _same_points(got, ek8._ext_add(p, q, TWO_D))
    assert _affine(got) == [ref.point_add(a, b)
                            for a, b in zip(affine, q_affine)]
    neg_p = (-p[0], p[1], p[2], -p[3])
    for q, want in ((p, [ref.point_add(a, a) for a in affine]),
                    (neg_p, [(0, 1)] * len(affine))):
        assert _affine(ek8._quad_add(p, ek8._quad_entry(q, TWO_D))) == want


def test_quad_entry_carries_two_d_t():
    p, _ = _points(3, 16)
    X, Y, Z, T = p
    got = ek8._quad_entry(p, TWO_D)
    assert all(torch.equal(a, b) for a, b in zip(got[:3], (X, Y, Z)))
    want = [2 * ref.D * F.from_limbs(t) % P for t in T]
    assert [F.from_limbs(v) for v in got[3]] == want


def test_identity_entry_is_neutral():
    """Entry 0 of the kernel's lane table, (0, 1, 1, 0)."""
    p, affine = _points(4, 64)
    m = p[0].shape[0]
    zero = torch.zeros(m, L, dtype=torch.int64)
    one = zero.clone()
    one[:, 0] = 1
    assert _affine(ek8._quad_add(p, (zero, one, one, zero))) == affine


def _kernel_b_table():
    """The B entries as the kernel reads them from its constant block:
    [entry][coord][limb] from the [limb][entry][coord] layout."""
    kc = torch.tensor(ek8.KERNEL_CONSTS[3 * L:], dtype=torch.int64)
    return kc.reshape(L, 16, 4).permute(1, 2, 0)


def test_kernel_constants():
    """D, 2D and sqrt(-1) lead as in CONSTS; then i·B = (x, y, 1, 2d·xy)
    for i = 0..15, identity first."""
    assert len(ek8.KERNEL_CONSTS) == 3 * L + 16 * 4 * L
    assert ek8.KERNEL_CONSTS[:3 * L] == ek8.CONSTS[:3 * L]
    tab = _kernel_b_table()
    for i in range(16):
        x, y = (0, 1) if i == 0 else ref.scalar_mult(i, ref.B)
        want = (x, y, 1, 2 * ref.D * x * y % P)
        assert tuple(F.from_limbs(tab[i, c]) for c in range(4)) == want, i
        assert tab[i].tolist() == ek8.B_TABLE_2DT[i]
    assert tab.abs().max() <= max(F.RESTING)


def test_quad_add_of_b_entries():
    p, affine = _points(5, 64)
    m = p[0].shape[0]
    idx = np.random.default_rng(6).integers(0, 16, size=m)
    q = _kernel_b_table()[torch.as_tensor(idx)].unbind(1)
    q_affine = [(0, 1) if i == 0 else ref.scalar_mult(int(i), ref.B)
                for i in idx]
    assert _affine(ek8._quad_add(p, q)) == [
        ref.point_add(a, b) for a, b in zip(affine, q_affine)]


# --- the kernel's whole schedule, modelled on the helpers ---------------------

def _quad_verify(a_cols, r_cols, s_win, k_win):
    """The kernel's steps in its order, on the round helpers: A and R
    decompressed, -P = (-x, y, 1, -x·y) and its entry with 2d·T, the lane
    table i·(-A) built by unified adds of entry 1 (each entry one more
    product), 64 windows of 4 doublings, an add of the B entry and an add
    of the lane entry, then -R and 3 doublings."""
    n = a_cols.shape[1]
    kc = torch.tensor(ek8.KERNEL_CONSTS, dtype=torch.int64)
    d_const, two_d, sqrt_m1 = kc[0:L], kc[L:2 * L], kc[2 * L:3 * L]
    b_tab = _kernel_b_table()
    zero = torch.zeros(n, L, dtype=torch.int64)
    one = zero.clone()
    one[:, 0] = 1
    ax, ay, a_ok = ek8._decompress(a_cols.t().long(), d_const, sqrt_m1, one)
    rx, ry, r_ok = ek8._decompress(r_cols.t().long(), d_const, sqrt_m1, one)

    def neg_point(x, y):
        t = F.mul(-x, y)
        return (-x, y, one, t), (-x, y, one, F.mul(t, two_d))

    acc, entry1 = neg_point(ax, ay)
    entries = [(zero, one, one, zero), entry1]
    for _ in range(14):
        acc = ek8._quad_add(acc, entry1)
        entries.append(ek8._quad_entry(acc, two_d))
    tab = torch.stack([torch.stack(e, 1) for e in entries])  # [16, n, 4, 16]
    lanes = torch.arange(n)

    acc = (zero, one, one, zero)
    for j in range(ek8.WINDOWS):
        w = ek8.WINDOWS - 1 - j
        for _ in range(4):
            acc = ek8._quad_double(acc)
        acc = ek8._quad_add(acc, b_tab[s_win[w].long() & 15].unbind(1))
        acc = ek8._quad_add(acc, tab[k_win[w].long() & 15, lanes].unbind(1))
    _, neg_r = neg_point(rx, ry)
    acc = ek8._quad_add(acc, neg_r)
    for _ in range(3):
        acc = ek8._quad_double(acc)
    X, Y, Z, _ = acc
    return F.is_zero(X) & F.eq(Y, Z) & a_ok & r_ok


def _edge_items():
    """21 items: valid, S = 0 and wrong-message signatures, small-order A
    and R, y >= p, x = -0 and random bytes."""
    rng = np.random.default_rng(60)
    items = []
    for i in range(10):
        seed, msg = rng.bytes(32), rng.bytes(20)
        pub, sig = ref.public_key(seed), ref.sign(seed, msg)
        if i % 4 == 1:
            sig = sig[:32] + bytes(32)                 # S = 0
        if i % 4 == 2:
            msg += b"!"
        items.append((pub, msg, sig))
    small = [ref.compress(t) for t in _torsion()]
    for i in range(8):                                 # small order A, R
        items.append((small[i], b"m", small[7 - i] + bytes(32)))
    enc = (P + 1).to_bytes(32, "little")               # y >= p
    items.append((small[3], b"y", enc + bytes(32)))
    neg_one = bytearray((1).to_bytes(32, "little"))
    neg_one[31] |= 0x80                                # x = -0
    items.append((bytes(neg_one), b"z", bytes(neg_one) + bytes(32)))
    items.append((rng.bytes(32), b"r", rng.bytes(64)))
    return items


def test_quad_schedule_matches_plain_and_golden():
    items = _edge_items()
    a, r, s, k, bad = oe.prep_arrays(items, 32)
    cols = [oe.to_cols(x, torch.device("cpu")) for x in (a, r, s, k)]
    got = _quad_verify(*cols)
    assert torch.equal(got, ek8.verify_cols_plain(*cols))
    mask = got.numpy()[:len(items)].copy()
    mask[bad[:len(items)]] = False
    assert mask.tolist() == [jref.verify(*it) for it in items]
    assert mask.sum() >= 8 and not mask.all()


# --- the overflow rule, round by round ---------------------------------------

def test_every_product_operand_is_within_max_lazy(monkeypatch):
    """The schedule of _quad_verify on abstract values: decompressed
    coordinates, products and constants are 1 resting value; sums add
    up.  Every operand of every product must stay within MAX_LAZY, and
    the point arithmetic takes exactly 3,234 products."""
    seen = []

    def mul(f, g):
        seen.append(max(f.k, g.k))
        return Lazy(1)

    monkeypatch.setattr(ek8, "_products",
                        lambda lhs, rhs: tuple(map(mul, lhs, rhs)))
    monkeypatch.setattr(ek8, "_squares",
                        lambda xs: tuple(mul(x, x) for x in xs))
    monkeypatch.setattr(F, "mul", mul)
    R = Lazy(1)

    def neg_point():
        x, y = -R, R
        t = mul(x, y)
        return (x, y, R, t), (x, y, R, mul(t, R))

    acc, entry1 = neg_point()
    entries = [(R, R, R, R), entry1]
    for _ in range(14):
        acc = ek8._quad_add(acc, entry1)
        entries.append(ek8._quad_entry(acc, R))
    worst = tuple(Lazy(max(e[c].k for e in entries)) for c in range(4))
    assert [w.k for w in worst] == [1, 1, 1, 1]
    acc = (R, R, R, R)
    for _ in range(ek8.WINDOWS):
        for _ in range(4):
            acc = ek8._quad_double(acc)
        acc = ek8._quad_add(acc, (R, R, R, R))         # the B entry
        acc = ek8._quad_add(acc, worst)
    _, neg_r = neg_point()
    acc = ek8._quad_add(acc, neg_r)
    for _ in range(3):
        acc = ek8._quad_double(acc)
    assert max(seen) <= F.MAX_LAZY
    assert max(seen) == 4                              # F of a doubling
    assert len(seen) == 2 + 14 * 9 + ek8.WINDOWS * 48 + 2 + 8 + 3 * 8
    assert len(seen) == 3234


# --- on the card --------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 3, 4, 5, 31, 33, 64, 1023])
def test_kernel_matches_plain_on_partial_quads(n):
    """Lane counts that leave a partial quad, warp or block: the kernel
    runs every thread to the end and stores only real lanes."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    rng = np.random.default_rng(n)
    items = []
    for i in range(n):
        seed, msg = rng.bytes(32), rng.bytes(16)
        sig = ref.sign(seed, msg)
        if i % 3 == 1:
            sig = sig[:32] + bytes(32)
        items.append((ref.public_key(seed), msg, sig))
    a, r, s, k, _ = oe.prep_arrays(items, n)
    dev = torch.device("cuda")
    cols = [oe.to_cols(x, dev) for x in (a, r, s, k)]
    before = ek8.launches
    got = ek8.verify_cols(*cols)
    torch.cuda.synchronize()
    assert ek8.launches == before + 1
    assert torch.equal(got, ek8.verify_cols_plain(*cols))
