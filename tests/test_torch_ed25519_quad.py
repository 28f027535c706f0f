"""The four-threads-a-signature schedule of the CUDA verifier
(ops/csrc/ed25519_verify.cu) and its dedicated squaring, on the CPU.

  * The round helpers of ops/ed25519_kernel.py (_quad_double,
    _quad_add_cached, _quad_madd, _cached) against the _ext_* formulas of
    the plain verifier and the golden model's group law, mod p, as
    projective equality through field.canonical.
  * A model of the kernel's whole schedule built from those helpers
    (table in cached form, 64 windows, the tail) against
    verify_cols_plain and the ZIP-215 golden model.
  * The overflow rule: every operand of every product in the schedule is
    a sum of at most MAX_LAZY resting values.
  * The 55-product squaring written out as the CUDA loop runs it, limb
    for limb equal to field.mul(f, f) up to the lazy bound.

Inputs come from seeded numpy generators; every result is an integer or
a bool, so the tolerance is exact equality.  The ``cuda``-marked test
holds the kernel to verify_cols_plain on partial quads and blocks; it
skips without a card.
"""
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_ref as jref
from cometbft_tpu_torch.crypto import _ed25519_ref as ref
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field as F
from torch_helpers import Lazy
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

P = F.P
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
    t = torch.tensor(rows, dtype=torch.int64)            # [m, 4, 10]
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
    got = ek._quad_double(p)
    _same_points(got, ek._ext_double(p))
    assert _affine(got) == [ref.point_add(a, a) for a in affine]


def test_quad_add_cached_is_ext_add():
    p, affine = _points(2, 64)
    # pair each point with a shifted copy of the list: random + random,
    # random + identity, torsion + torsion, and p + p, p + (-p)
    q = tuple(torch.roll(c, 5, 0) for c in p)
    q_affine = affine[-5:] + affine[:-5]
    got = ek._quad_add_cached(p, ek._cached(q, TWO_D))
    _same_points(got, ek._ext_add(p, q, TWO_D))
    assert _affine(got) == [ref.point_add(a, b)
                            for a, b in zip(affine, q_affine)]
    neg_p = (-p[0], p[1], p[2], -p[3])
    for q, want in ((p, [ref.point_add(a, a) for a in affine]),
                    (neg_p, [(0, 1)] * len(affine))):
        assert _affine(ek._quad_add_cached(p, ek._cached(q, TWO_D))) == want


def test_cached_identity_entry_is_neutral():
    """Entry 0 of the kernel's lane table, (1, 1, 0, 2)."""
    p, affine = _points(3, 64)
    m = p[0].shape[0]
    one = torch.zeros(m, F.LIMBS, dtype=torch.int64)
    one[:, 0] = 1
    entry0 = (one, one, torch.zeros_like(one), one + one)
    assert _affine(ek._quad_add_cached(p, entry0)) == affine


@pytest.mark.parametrize("which", ["b_table", "random"])
def test_quad_madd_is_madd_affine(which):
    p, affine = _points(4, 64)
    m = p[0].shape[0]
    rng = np.random.default_rng(5)
    if which == "b_table":
        idx = rng.integers(0, 16, size=m)
        q3 = tuple(torch.tensor([ek.B_TABLE[i][c] for i in idx],
                                dtype=torch.int64) for c in range(3))
        q_affine = [(0, 1) if i == 0 else ref.scalar_mult(int(i), ref.B)
                    for i in idx]
    else:
        q_affine = [ref.scalar_mult(int(rng.integers(1, 2**62)), ref.B)
                    for _ in range(m)]
        q3 = tuple(torch.tensor([F.balanced(v) for v in vals],
                                dtype=torch.int64) for vals in zip(
            *[((y - x) % P, (y + x) % P, 2 * ref.D * x * y % P)
              for x, y in q_affine]))
    got, t2d = ek._quad_madd(p, q3, TWO_D)
    _same_points(got, ek._madd_affine(p, q3))
    assert _affine(got) == [ref.point_add(a, b)
                            for a, b in zip(affine, q_affine)]
    assert F.eq(t2d, F.mul(p[3], TWO_D)).all()


# --- the kernel's whole schedule, modelled on the helpers ---------------------

def _quad_verify(a_cols, r_cols, s_win, k_win):
    """The kernel's steps in its order, on the round helpers: A and R
    decompressed, the lane table i·(-A) in cached form built by mixed
    adds of -A (each returning the 2d·T of the entry before), 64 windows
    of 4 doublings, a mixed add of the B-table entry and an add of the
    lane-table entry, then -R and 3 doublings."""
    n = a_cols.shape[1]
    consts = torch.tensor(ek.CONSTS, dtype=torch.int64)
    d_const, two_d, sqrt_m1 = consts[0:10], consts[10:20], consts[20:30]
    b_tab = consts[30:].reshape(16, 3, F.LIMBS)
    zero = torch.zeros(n, F.LIMBS, dtype=torch.int64)
    one = zero.clone()
    one[:, 0] = 1
    ax, ay, a_ok = ek._decompress(a_cols.t().long(), d_const, sqrt_m1, one)
    rx, ry, r_ok = ek._decompress(r_cols.t().long(), d_const, sqrt_m1, one)

    def affine_neg(x, y):
        t2d = F.mul(F.mul(-x, y), two_d)
        return (-x, y, one, F.mul(-x, y)), (y + x, y - x, t2d)

    neg_a, neg_a3 = affine_neg(ax, ay)
    entries = [(one, one, zero, one + one)]
    acc = neg_a
    for _ in range(14):
        prev = acc
        acc, t2d = ek._quad_madd(acc, neg_a3, two_d)
        X, Y, Z, _ = prev
        entries.append((Y - X, Y + X, t2d, Z + Z))
    entries.append(ek._cached(acc, two_d))
    tab = torch.stack([torch.stack(e, 1) for e in entries])  # [16, n, 4, 10]
    lanes = torch.arange(n)

    acc = (zero, one, one, zero)
    for j in range(ek.WINDOWS):
        w = ek.WINDOWS - 1 - j
        for _ in range(4):
            acc = ek._quad_double(acc)
        acc, _ = ek._quad_madd(acc, b_tab[s_win[w].long() & 15].unbind(1),
                               two_d)
        acc = ek._quad_add_cached(
            acc, tab[k_win[w].long() & 15, lanes].unbind(1))
    _, neg_r3 = affine_neg(rx, ry)
    acc, _ = ek._quad_madd(acc, neg_r3, two_d)
    for _ in range(3):
        acc = ek._quad_double(acc)
    X, Y, Z, _ = acc
    return F.is_zero(X) & F.eq(Y, Z) & a_ok & r_ok


def _edge_items():
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
    assert torch.equal(got, ek.verify_cols_plain(*cols))
    mask = got.numpy()[:len(items)].copy()
    mask[bad[:len(items)]] = False
    assert mask.tolist() == [jref.verify(*it) for it in items]
    assert mask.sum() >= 8 and not mask.all()


# --- the overflow rule, round by round ---------------------------------------

def test_every_product_operand_is_within_max_lazy(monkeypatch):
    """The schedule of _quad_verify on abstract values: decompressed
    coordinates, products and constants are 1 resting value; sums add
    up.  Every operand of every product must stay within MAX_LAZY."""
    seen = []

    def mul(f, g):
        seen.append(max(f.k, g.k))
        return Lazy(1)

    monkeypatch.setattr(ek, "_products",
                        lambda lhs, rhs: tuple(map(mul, lhs, rhs)))
    monkeypatch.setattr(ek, "_squares",
                        lambda xs: tuple(mul(x, x) for x in xs))
    monkeypatch.setattr(F, "mul", mul)
    R = Lazy(1)
    x, y = -R, R                                       # -A: (-x, y)
    neg_a3 = (y - x, y + x, mul(mul(x, y), R))
    entries = [(R, R, R, R + R)]                       # (1, 1, 0, 2)
    acc = (x, y, R, mul(x, y))
    for _ in range(14):
        prev = acc
        acc, t2d = ek._quad_madd(acc, neg_a3, R)
        entries.append((prev[1] - prev[0], prev[1] + prev[0], t2d,
                        prev[2] + prev[2]))
    entries.append(ek._cached(acc, R))
    worst = tuple(Lazy(max(e[c].k for e in entries)) for c in range(4))
    assert [w.k for w in worst] == [2, 2, 1, 2]
    acc = (R, R, R, R)
    for _ in range(2):                                 # a fixpoint after 1
        for _ in range(4):
            acc = ek._quad_double(acc)
        acc, _ = ek._quad_madd(acc, (R, R, R), R)
        acc = ek._quad_add_cached(acc, worst)
    acc, _ = ek._quad_madd(acc, neg_a3, R)             # -R, same shape
    for _ in range(3):
        acc = ek._quad_double(acc)
    assert max(seen) <= F.MAX_LAZY
    assert max(seen) == 4                              # F of a doubling
    assert len(seen) == 3 + 14 * 8 + 1 + 2 * 12 * 4 + 8 + 3 * 8


# --- the dedicated squaring, written out as the CUDA loop runs it -----------

def _sqr_55(f):
    """ed25519_field.cuh fe_sqr on Python ints: 10 diagonal and 45 cross
    products against f2 = 2f, odd x odd terms once more doubled, summed
    into lo/hi, folded at 19 and carried.  Returns (limbs, products)."""
    f2 = [2 * v for v in f]
    lo, hi = [0] * F.LIMBS, [0] * F.LIMBS
    terms = 0
    for i in range(F.LIMBS):
        for j in range(i, F.LIMBS):
            if i == j:
                p = (f2[i] if i & 1 else f[i]) * f[i]
            else:
                p = f2[i] * (f2[j] if (i & 1) and (j & 1) else f[j])
            assert -2**63 <= p < 2**63
            if i + j < F.LIMBS:
                lo[i + j] += p
            else:
                hi[i + j - F.LIMBS] += p
            terms += 1
    h = [lo[k] + 19 * hi[k] for k in range(F.LIMBS)]
    assert all(abs(v) < F.MUL_ACC_LIMIT for v in h)
    return F._carry_ints(h), terms


@pytest.mark.parametrize("case", ["lazy_bound", "random"])
def test_dedicated_squaring_is_mul_limb_for_limb(case):
    rng = np.random.default_rng(70)
    lazy = np.asarray([F.MAX_LAZY * r for r in F.RESTING])
    if case == "lazy_bound":
        signs = rng.choice([-1, 1], size=(64, F.LIMBS))
        signs[0], signs[1] = 1, -1
        rows = signs * lazy
    else:
        rows = rng.integers(-lazy, lazy + 1, size=(64, F.LIMBS))
    f = torch.tensor(rows, dtype=torch.int64)
    want = F.mul(f, f).tolist()
    assert (f * 2).abs().max() < 2**31                   # f2 in int32
    for row, w in zip(rows.tolist(), want):
        got, terms = _sqr_55(row)
        assert terms == 55
        assert got == w


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
    before = ek.launches
    got = ek.verify_cols(*cols)
    torch.cuda.synchronize()
    assert ek.launches == before + 1
    assert torch.equal(got, ek.verify_cols_plain(*cols))
