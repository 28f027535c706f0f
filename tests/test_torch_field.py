"""The port's GF(2^255-19) arithmetic (cometbft_tpu_torch/ops/field.py)
against Python ints mod p and against the JAX package's field module
(cometbft_tpu/ops/field.py) on the same seeded inputs, plus the int64
overflow bound of the radix-2^25.5 schedule the CUDA kernel shares.
All results are integers: tolerance is exact equality."""
import numpy as np
import jax.numpy as jnp
import pytest
import torch

from cometbft_tpu.ops import field as jfield
from cometbft_tpu_torch.ops import field as F
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

P = F.P


def _rand_ints(seed, n):
    rng = np.random.default_rng(seed)
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def _limbs(xs):
    return torch.tensor([F.to_limbs(x) for x in xs], dtype=torch.int64)


def _vals(t):
    return [F.from_limbs(row) for row in t]


def _jax_vals(a):
    return [jfield.from_limbs(row) for row in np.asarray(a)]


def _jax_limbs(xs):
    return jnp.asarray(np.stack([jfield.to_limbs(x) for x in xs]))


# --- the schedule and its bound ----------------------------------------------

def test_limb_layout_is_radix_25_5():
    assert F.OFFSETS[0] == 0 and F.OFFSETS[F.LIMBS] == 255
    for i in range(F.LIMBS):
        assert F.OFFSETS[i] == -(-51 * i // 2)          # ceil(25.5 i)
        assert F.SIZES[i] == F.OFFSETS[i + 1] - F.OFFSETS[i]


def test_product_weights_match_offsets():
    """2^(off_i + off_j - off_k) (times 2^-255 -> 19 on wrap) is the
    weight mul gives f_i * g_j in limb k = (i + j) mod 10."""
    for i in range(F.LIMBS):
        for j in range(F.LIMBS):
            k = (i + j) % F.LIMBS
            e = F.OFFSETS[i] + F.OFFSETS[j] - F.OFFSETS[k]
            weight = (2 ** e) % P if e < 255 else (2 ** (e - 255)) * 19
            assert weight == F._coef(i, j), (i, j)


def test_resting_bound_is_closed_under_mul():
    """Operands of up to MAX_LAZY resting values keep every int64
    accumulator under MUL_ACC_LIMIT, and carry() of anything under the
    limit is resting again — the discipline cannot drift."""
    lazy = [F.MAX_LAZY * r for r in F.RESTING]
    acc = F.mul_acc_bound(lazy, lazy)
    assert max(acc) <= F.MUL_ACC_LIMIT < 2**63
    assert all(a <= b for a, b in zip(F.carry_bound(acc), F.RESTING))
    # 2^62 plus the largest carry in flight stays inside int64
    assert F.MUL_ACC_LIMIT + (F.MUL_ACC_LIMIT >> 25) * 19 < 2**63


def test_int32_storage_bounds():
    """The kernel stores limbs in int32 and doubles odd operand limbs
    before the 32x32->64 product."""
    for i, r in enumerate(F.RESTING):
        assert F.MAX_LAZY * r < 2**31
        assert 2 * F.MAX_LAZY * r < 2**31
    assert F.RESTING[0] == 2**25 and all(
        r <= 2**24 + 2**16 for r in F.RESTING[1::2])


def test_canonical_precondition():
    """After carry, |value| < 2p, so value + 2p is positive and the two
    sweeps plus one conditional subtract reach [0, p)."""
    v_max = sum(r << F.OFFSETS[i] for i, r in enumerate(F.RESTING))
    assert v_max < 2 * P
    assert sum(t << F.OFFSETS[i] for i, t in enumerate(F._TWO_P)) == 2 * P


def test_balanced_constants_are_resting():
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    vals = np.asarray(ek.CONSTS).reshape(-1, F.LIMBS)
    assert (np.abs(vals) <= np.asarray(F.RESTING)).all()


# --- arithmetic against Python ints ----------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mul_sqr_add_sub_vs_python(seed):
    xs, ys = _rand_ints(seed, 16), _rand_ints(seed + 100, 16)
    a, b = _limbs(xs), _limbs(ys)
    assert _vals(F.mul(a, b)) == [x * y % P for x, y in zip(xs, ys)]
    assert _vals(F.sqr(a)) == [x * x % P for x in xs]
    # lazy sums/differences feed mul directly
    assert _vals(F.mul(a + b, a - b)) == [
        (x + y) * (x - y) % P for x, y in zip(xs, ys)]


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
    out = F.mul(f, g)
    assert (out.abs() <= torch.tensor(F.RESTING)).all()
    for fr, gr, o in zip(f, g, out):
        assert F.from_limbs(o) == F.from_limbs(fr) * F.from_limbs(gr) % P


def test_carry_matches_host_copy():
    rng = np.random.default_rng(3)
    h = rng.integers(-2**62, 2**62, size=(32, F.LIMBS), dtype=np.int64)
    out = F.carry(torch.from_numpy(h))
    for row, o in zip(h.tolist(), out.tolist()):
        assert o == F._carry_ints(row)
        assert F.from_limbs(o) == F.from_limbs(row)


def test_pow_p58_vs_python():
    xs = _rand_ints(11, 4) + [0, 1, P - 1]
    got = _vals(F.pow_p58(_limbs(xs)))
    assert got == [pow(x, (P - 5) // 8, P) for x in xs]


@pytest.mark.parametrize("case", ["random", "edges", "redundant"])
def test_canonical_parity_is_zero(case):
    if case == "random":
        xs = _rand_ints(5, 32)
        t = _limbs(xs)
    elif case == "edges":
        xs = [0, 1, 2, 18, 19, P - 1, P - 2, 2**255 - 20, 12345]
        t = _limbs(xs)
    else:
        # the same values as lazy differences at the bound
        xs = _rand_ints(6, 16)
        noise = torch.tensor(np.random.default_rng(6).integers(
            -2**24, 2**24, size=(16, F.LIMBS)), dtype=torch.int64)
        t = _limbs(xs) + noise - noise.flip(-1)
        xs = [F.from_limbs(r) for r in t]
    canon = F.canonical(t)
    assert canon.tolist() == [F.to_limbs(x) for x in xs]
    assert F.parity(t).tolist() == [x % P & 1 for x in xs]
    assert F.is_zero(t).tolist() == [x % P == 0 for x in xs]
    assert F.eq(t, _limbs(xs)).all()


def test_zero_in_redundant_forms():
    two_p = torch.tensor([F._TWO_P], dtype=torch.int64)
    p_limbs = torch.tensor([[(P >> F.OFFSETS[i]) & ((1 << F.SIZES[i]) - 1)
                             for i in range(F.LIMBS)]], dtype=torch.int64)
    for z in (two_p, p_limbs, -p_limbs, two_p - p_limbs - p_limbs):
        assert F.is_zero(z).item()
        assert F.canonical(z).tolist() == [[0] * F.LIMBS]


def test_from_bytes_keeps_non_canonical_y_and_drops_sign():
    vals = [P + 1, 2**255 - 1, P, 0, 2**254 + 12345]
    rows = []
    for v in vals:
        b = bytearray(v.to_bytes(32, "little"))
        b[31] |= 0x80                      # sign bit must be dropped
        rows.append(list(b))
    limbs = F.from_bytes(torch.tensor(rows, dtype=torch.int64))
    for v, row in zip(vals, limbs.tolist()):
        assert sum(x << F.OFFSETS[i] for i, x in enumerate(row)) == v
        assert all(0 <= x < (1 << F.SIZES[i]) for i, x in enumerate(row))


# --- against the JAX package's field module -------------------------------

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
    assert np.asarray(jfield.parity(ja)).tolist() == F.parity(a).tolist()
    assert np.asarray(jfield.eq(ja, jb)).tolist() == F.eq(a, b).tolist()
    assert np.asarray(jfield.is_zero(ja)).tolist() == \
        F.is_zero(a).tolist()
