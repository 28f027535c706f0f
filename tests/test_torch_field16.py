"""The second kernel's GF(2^255-19) arithmetic
(cometbft_tpu_torch/ops/field16.py: 16 limbs of 16 bits, fold 38 at
2^256) against Python ints mod p and against the JAX package's fold-38
field (cometbft_tpu/ops/field.py, the field of ed25519_pallas8) on the
same seeded inputs, plus the int64 overflow bound the CUDA kernel
ed25519_verify8.cu relies on.  All results are integers: tolerance is
exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cometbft_tpu.ops import field as jfield
from cometbft_tpu_torch.ops import field16 as F

P = F.P


def _rand_ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _limbs(xs):
    return torch.tensor([F.to_limbs(x) for x in xs], dtype=torch.int64)


def _vals(t):
    return [F.from_limbs(row) for row in t]


def _digits(xs):
    """Raw 16-bit digits of non-negative ints below 2^256 (no reduction)."""
    return torch.tensor([[(x >> (16 * i)) & 0xFFFF for i in range(F.LIMBS)]
                         for x in xs], dtype=torch.int64)


def _jax_limbs(xs):
    return jnp.asarray(np.stack([jfield.to_limbs(x) for x in xs]))


def _jax_vals(a):
    return [jfield.from_limbs(row) for row in np.asarray(a)]


# --- the schedule and its bound ----------------------------------------------

def test_limb_layout_is_radix_16_with_fold_38():
    assert F.LIMBS * F.BITS == 256
    assert 2**256 % P == F.FOLD and 2**255 % P == F.FOLD255
    assert sum(t << (16 * i) for i, t in enumerate(F.TWO_P)) == 2 * P
    x = 2**256 - 1 - 12345
    assert F.from_limbs(_digits([x])[0]) == x % P


def test_resting_bound_is_closed_under_mul():
    """Operands of up to MAX_LAZY resting values keep every int64
    accumulator under MUL_ACC_LIMIT, and carry() of anything under the
    limit is resting again — the discipline cannot drift."""
    lazy = [F.MAX_LAZY * r for r in F.RESTING]
    acc = F.mul_acc_bound(lazy, lazy)
    assert max(acc) <= F.MUL_ACC_LIMIT < 2**63
    assert all(a <= b for a, b in zip(F.carry_bound(acc), F.RESTING))
    # the carry in flight never leaves int64 either
    assert F.MUL_ACC_LIMIT + (F.MUL_ACC_LIMIT >> 16) * F.FOLD < 2**63


def test_int32_storage_bounds():
    """The kernel stores limbs in int32 and doubles a limb in its
    squaring before the 32x32->64 product."""
    for r in F.RESTING:
        assert 2 * F.MAX_LAZY * r < 2**31
    assert F.RESTING[0] == 2**15 and all(
        r == 2**15 for i, r in enumerate(F.RESTING) if i != 1)
    assert F.RESTING[1] < 2**18


def test_canonical_precondition():
    """After carry |value| < 2p, so value + 2p is positive and below
    2^257: two 255-bit sweeps (each folding bit 255 at 19) and one
    conditional subtract reach [0, p)."""
    v_max = sum(r << (16 * i) for i, r in enumerate(F.RESTING))
    assert v_max < 2 * P
    assert v_max + 2 * P < 2**257


def test_balanced_constants_are_resting():
    from cometbft_tpu_torch.ops import ed25519_kernel8 as k8
    vals = np.asarray(k8.CONSTS).reshape(-1, F.LIMBS)
    assert vals.shape == (3 + 16 * 4, F.LIMBS)
    assert (np.abs(vals) <= np.asarray(F.RESTING)).all()


# --- arithmetic against Python ints ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mul_sqr_add_sub_vs_python(seed):
    xs, ys = _rand_ints(seed, 16), _rand_ints(seed + 100, 16)
    a, b = _limbs(xs), _limbs(ys)
    assert _vals(F.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert _vals(F.sqr(a)) == [x * x % P for x in xs]
    assert _vals(F.mul(a + b, a - b)) == [
        (x + y) * (x - y) % P for x, y in zip(xs, ys)]
    assert (F.mul(a, b).abs() <= torch.tensor(F.RESTING)).all()


def test_mul_at_the_lazy_bound():
    """Operands at +-MAX_LAZY x RESTING in every limb, all sign
    patterns of a seeded draw: no int64 overflow, exact value."""
    rng = np.random.default_rng(7)
    lazy = np.asarray([F.MAX_LAZY * r for r in F.RESTING])
    signs = rng.choice([-1, 1], size=(64, 2, F.LIMBS))
    signs[0] = 1
    signs[1] = -1
    f = torch.tensor(signs[:, 0] * lazy, dtype=torch.int64)
    g = torch.tensor(signs[:, 1] * lazy, dtype=torch.int64)
    for out in (F.mul(f, g), F.sqr(f)):
        assert (out.abs() <= torch.tensor(F.RESTING)).all()
    for fr, gr, o, s in zip(f, g, F.mul(f, g), F.sqr(f)):
        assert F.from_limbs(o) == F.from_limbs(fr) * F.from_limbs(gr) % P
        assert F.from_limbs(s) == F.from_limbs(fr) ** 2 % P


def test_carry_matches_host_copy():
    rng = np.random.default_rng(3)
    h = rng.integers(-2**44, 2**44, size=(32, F.LIMBS), dtype=np.int64)
    out = F.carry(torch.from_numpy(h))
    for row, o in zip(h.tolist(), out.tolist()):
        assert o == F._carry_ints(row)
        assert F.from_limbs(o) == F.from_limbs(row)


def test_pow_p58_vs_python():
    xs = _rand_ints(11, 4) + [0, 1, P - 1]
    got = _vals(F.pow_p58(_limbs(xs)))
    assert got == [pow(x, (P - 5) // 8, P) for x in xs]


@pytest.mark.parametrize("case", ["random", "edges", "redundant", "bit255"])
def test_canonical_parity_is_zero(case):
    if case == "random":
        xs = _rand_ints(5, 32)
        t = _limbs(xs)
    elif case == "edges":
        xs = [0, 1, 2, 18, 19, P - 1, P - 2, 2**255 - 20, 12345]
        t = _limbs(xs)
    elif case == "redundant":
        # the same values as lazy differences near the bound
        xs = _rand_ints(6, 16)
        noise = torch.tensor(np.random.default_rng(6).integers(
            -2**14, 2**14, size=(16, F.LIMBS)), dtype=torch.int64)
        t = _limbs(xs) + noise - noise.flip(-1)
        xs = [F.from_limbs(r) for r in t]
    else:
        # raw digits with bit 255 set: the value reaches 2^256 in this
        # radix, and bit 255 must fold at 19 before the compare with p
        raw = [2**255, 2**255 + 18, 2**255 + 19, P + 2**255,
               2**256 - 1, 2**256 - 38, 2**256 - 39, 2 * P, 2 * P - 1]
        t = _digits(raw)
        xs = [v % P for v in raw]
    canon = F.canonical(t)
    assert canon.tolist() == [F.to_limbs(x) for x in xs]
    assert F.parity(t).tolist() == [x % P & 1 for x in xs]
    assert F.is_zero(t).tolist() == [x % P == 0 for x in xs]
    assert F.eq(t, _limbs(xs)).all()


def test_zero_in_redundant_forms():
    two_p = torch.tensor([F.TWO_P], dtype=torch.int64)
    p_limbs = _digits([P])
    for z in (two_p, p_limbs, -p_limbs, two_p - p_limbs - p_limbs,
              _digits([2 * P])):
        assert F.is_zero(z).item()
        assert F.canonical(z).tolist() == [[0] * F.LIMBS]


def test_from_bytes_keeps_all_256_bits():
    vals = [P + 1, 2**255 - 1, P, 0, 2**254 + 12345, 2**256 - 1,
            2**255 + 7]
    rows = [list(v.to_bytes(32, "little")) for v in vals]
    limbs = F.from_bytes(torch.tensor(rows, dtype=torch.int64))
    for v, row in zip(vals, limbs.tolist()):
        assert sum(x << (16 * i) for i, x in enumerate(row)) == v
        assert all(0 <= x < 2**16 for x in row)
        assert F.from_limbs(row) == v % P
    assert F.canonical(limbs).tolist() == [F.to_limbs(v) for v in vals]


# --- against the JAX package's fold-38 field (B2's field) -------------------

@pytest.mark.parametrize("op", ["mul", "sqr", "sub_mul", "pow_p58"])
def test_arithmetic_vs_jax_field(op):
    xs, ys = _rand_ints(21, 8), _rand_ints(22, 8)
    a, b = _limbs(xs), _limbs(ys)
    ja, jb = _jax_limbs(xs), _jax_limbs(ys)
    if op == "mul":
        got, want = F.mul(a, b), jfield.mul(ja, jb)
    elif op == "sqr":
        got, want = F.sqr(a), jfield.sqr(ja)
    elif op == "sub_mul":
        got, want = F.mul(a - b, a + b), jfield.mul(ja - jb, ja + jb)
    else:
        got, want = F.pow_p58(a), jfield.pow_p58(ja)
    assert _vals(got) == _jax_vals(want)


def test_canonical_parity_is_zero_vs_jax_field():
    xs = _rand_ints(31, 8) + [0, P - 1]
    ys = xs[:5] + _rand_ints(32, 5)
    a, b = _limbs(xs), _limbs(ys)
    ja, jb = _jax_limbs(xs), _jax_limbs(ys)
    assert [jfield.from_limbs(r) for r in np.asarray(
        jfield.canonical(ja))] == _vals(F.canonical(a))
    # JAX's canonical limbs are the value's bytes; ours its 16-bit digits
    assert np.asarray(jfield.canonical(ja)).tolist() == [
        list(F.from_limbs(r).to_bytes(32, "little")) for r in F.canonical(a)]
    assert np.asarray(jfield.parity(ja)).tolist() == F.parity(a).tolist()
    assert np.asarray(jfield.eq(ja, jb)).tolist() == F.eq(a, b).tolist()
    assert np.asarray(jfield.is_zero(ja)).tolist() == \
        F.is_zero(a).tolist()
