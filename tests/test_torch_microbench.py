"""The port's microbenchmarks (cometbft_tpu_torch/ops/microbench.py, B3)
against the JAX package's: for every op, the plain version's chain on
8 seeded lanes equals, mod p, the same chain built from the JAX
package's own primitives (ed25519_pallas: _from_bytes, _norm, _mul_nn,
_make_sqr, _ext_double, _ext_add, _madd_affine; microbench._where_tree)
with its packed constants sliced as _unpack_consts slices them.  The
formulas are the same on both sides (dbl-2008-hwcd, add-2008-hwcd-3,
madd-2008-hwcd), so every coordinate agrees as an integer mod p.  The
plain version runs the point ops on the kernel's four-thread rounds;
the yardstick, the JAX kernel's single-point formulas on Python ints,
equals the JAX chain, and the plain version equals it at the full REPS,
where the rounds' operands are also checked against the overflow rule.
The work chip_smoke.py counts each bound on is pinned op by op.  All
results are integers: tolerance is exact equality."""
import functools
import importlib.util
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cometbft_tpu.crypto import _ed25519_ref as ref
from cometbft_tpu.ops import ed25519_pallas as ep
from cometbft_tpu.ops import field24 as f24
from cometbft_tpu.ops import microbench as jmb
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.ops import field
from cometbft_tpu_torch.ops import microbench as mb
from torch_helpers import Lazy
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

P = field.P
TWO_D = 2 * ref.D % P
REPO = Path(__file__).resolve().parents[1]


def _x(seed=7, lanes=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (32, lanes), dtype=np.int32)
    x[31, 0] |= 0x80                 # bit 255 set on at least one lane
    x[31, 1] &= 0x7F
    return x


def _vals(out, lanes):
    assert out.dtype == torch.int32 and out.shape == (10, lanes)
    return [field.from_limbs(out[:, lane]) for lane in range(lanes)]


def _port_vals(x, op, reps):
    return _vals(mb.bench_cols_plain(torch.from_numpy(x), op, reps),
                 x.shape[1])


def _jax_vals(x, op, reps):
    """The JAX kernel's chain (_make_kernel, :87-171) on its primitives,
    eagerly on the CPU."""
    L = ep.LIMBS
    consts = jnp.asarray(ep._CONSTS_NP)
    two_d = consts[L:2 * L]
    pats = (consts[4 * L:5 * L], consts[5 * L:6 * L])
    b_tab = consts[6 * L:].reshape(16, 3, L, 1)
    xb = jnp.asarray(x)
    lanes = x.shape[1]
    xv = ep._norm(ep._from_bytes(xb), 2)
    yv = ep._norm(xv + xv, 2)
    one = jnp.concatenate([jnp.ones((1, lanes), jnp.int32),
                           jnp.zeros((L - 1, lanes), jnp.int32)], axis=0)
    p = (xv, yv, one, ep._mul(xv, yv, pats, 0, 0))
    w0 = xb[0:1] & 0xF
    if op == "noop":
        v = xv
    elif op == "carry":
        v = xv
        for _ in range(reps):
            v = ep._carry(v)
    elif op == "mul":
        v, w = xv, yv
        for _ in range(reps):
            v, w = ep._mul_nn(v, w, pats), v
    elif op == "sqr":
        sqr = ep._make_sqr(pats)
        v = xv
        for _ in range(reps):
            v = sqr(v)
    elif op == "select16":
        v = jnp.zeros((L, lanes), jnp.int32)
        for j in range(reps):
            v = v + jmb._where_tree((w0 + j) & 0xF,
                                    [b_tab[i, 0] for i in range(16)])
    else:
        q = p
        lane_rows = [jnp.concatenate(p, axis=0)] * 16
        for j in range(reps):
            if op == "double":
                q = ep._ext_double(q, pats)
            elif op == "add":
                q = ep._ext_add(q, p, two_d, pats)
            elif op == "madd":
                q = ep._madd_affine(q, (b_tab[3, 0], b_tab[3, 1],
                                        b_tab[3, 2]), pats)
            else:
                for i in range(4):
                    q = ep._ext_double(q, pats, need_t=(i == 3))
                w = (w0 + j) & 0xF
                bsel = tuple(jmb._where_tree(w, [b_tab[i, c]
                                                 for i in range(16)])
                             for c in range(3))
                q = ep._madd_affine(q, bsel, pats)
                lsel = jmb._where_tree(w, lane_rows)
                q = ep._ext_add(q, (lsel[0:L], lsel[L:2 * L],
                                    lsel[2 * L:3 * L], lsel[3 * L:]),
                                two_d, pats)
        v = q[0]
    v = np.asarray(v)
    return [f24.from_limbs(v[:, lane]) for lane in range(lanes)]


@pytest.mark.parametrize("op", list(mb.REPS))
def test_plain_matches_jax_primitives(op):
    x = _x()
    assert _port_vals(x, op, 2) == _jax_vals(x, op, 2)


@pytest.mark.parametrize("op", list(mb.REPS))
def test_yardstick_matches_jax_primitives(op):
    """The yardstick on Python ints is the JAX kernel's chain."""
    x = _x()
    assert _python_chain(x, op, 2) == _jax_vals(x, op, 2)


@pytest.mark.parametrize("reps", ["2", "full"])
@pytest.mark.parametrize("op", mb.POINT_OPS)
def test_quad_chain_equals_yardstick_mod_p(op, reps):
    """The kernel's four-thread rounds and the single-point formulas give
    the same X mod p, short and at the full REPS."""
    x = _x(seed=13, lanes=4)
    k = 2 if reps == "2" else mb.REPS[op]
    assert _port_vals(x, op, k) == _python_chain(x, op, k)


@pytest.mark.parametrize("op", mb.POINT_OPS)
def test_quad_chain_operands_within_max_lazy(op, monkeypatch):
    """The kernel's point chain at the full REPS on abstract values (the
    tracker of test_torch_ed25519_quad): the seed's coordinates, products
    and constants are 1 resting value, sums add up, and every operand of
    every product stays within MAX_LAZY."""
    seen = []

    def mul(f, g):
        seen.append(max(f.k, g.k))
        return Lazy(1)

    monkeypatch.setattr(ek, "_products",
                        lambda lhs, rhs: tuple(map(mul, lhs, rhs)))
    monkeypatch.setattr(ek, "_squares",
                        lambda xs: tuple(mul(x, x) for x in xs))
    monkeypatch.setattr(field, "mul", mul)
    R = Lazy(1)
    reps = mb.REPS[op]
    mb._quad_chain(op, (R, R, R, R), reps, R, lambda j: (R, R, R))
    rounds = {"double": 2, "add": 2, "madd": 2, "window": 12}[op]
    cached = op in ("add", "window")          # p's cached form, once
    assert len(seen) == cached + 4 * rounds * reps
    assert max(seen) <= field.MAX_LAZY
    # F = G - 2·ZZ of a doubling; F, G = 2·Z1 ± C of a mixed add
    assert max(seen) == {"double": 4, "add": 2, "madd": 3, "window": 4}[op]


@functools.cache
def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  REPO / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@functools.cache
def _work():
    return _chip_smoke()._mb_work_per_lane()


# (multiplies, squarings, carries) a lane that each op's output reads
@pytest.mark.parametrize("op, work", [
    ("noop", (0, 0, 1)),                     # x = carry(raw)
    ("carry", (0, 0, 1 + 4096)),
    ("mul", (1024, 0, 2)),                   # x and y; x·y is not read
    ("sqr", (0, 1024, 1)),
    ("select16", (0, 0, 1)),                 # the sum's carry, no seed
    # no doubling reads T: 3 products a step, the last step X alone
    ("double", (3 * 127 + 1, 4 * 128, 2)),
    # x·y and 2d·T once, 8 a step, the last step 4 + X
    ("add", (2 + 8 * 127 + 5, 0, 2)),
    # round 1's 2d·T1 is not read: 7 a step, the last step 3 + X
    ("madd", (1 + 7 * 127 + 4, 0, 2)),
    # a step: doublings 3 + 3 + 3 + 4 (the madd reads the last T), madd
    # 3 + 4, add 4 + 3 (the next doublings read no T); the last add 4 + X
    ("window", (2 + 27 * 15 + 25, 16 * 16, 2)),
])
def test_bound_counts_the_work_the_output_reads(op, work):
    """chip_smoke.py counts each op's bound on the products and carries
    its output reads, from a symbolic run of the plain chain."""
    cs = _chip_smoke()
    ops, *counted = _work()[op]
    assert tuple(counted) == work
    assert ops == cs._mb_ops(*work, op, mb.REPS[op])


def test_bound_counts_stay_on_the_yardstick():
    """chip_smoke.py prints PR 3's bound beside the bound: every product
    of the JAX kernel's single-point chain, seed included.  Its counts
    and 16,384-lane bounds of the point ops are the ones the kernels
    were measured against before the point ops moved to the quad rounds,
    so old and new times stand against one yardstick."""
    cs = _chip_smoke()
    ops = {op: cs._mb_ops(*work, op, mb.REPS[op])
           for op, work in cs.MB_YARDSTICK_WORK.items()}
    assert ops == {
        "noop": 504, "carry": 360952, "mul": 336376, "sqr": 244216,
        "double": 290296, "add": 378360, "madd": 294392, "select16": 10832,
        "window": 213624}
    bounds = {op: f"{cs._mb_bound(16384, ops[op])[0]:.4f}"
              for op in mb.POINT_OPS}
    assert bounds == {"add": "0.1853", "madd": "0.1442", "double": "0.1422",
                      "window": "0.1046"}


def test_reps_and_m_default_match_jax():
    assert mb.REPS == jmb.REPS
    assert list(mb.REPS) == list(jmb.REPS)
    assert mb.M_DEFAULT == jmb.M_DEFAULT


def _finish(e, f, g, h):
    return e * f % P, g * h % P, f * g % P, e * h % P


def _dbl(p):
    """dbl-2008-hwcd, a = -1."""
    X, Y, Z, _ = p
    a, b, zz = X * X, Y * Y, Z * Z
    g = b - a
    return _finish((X + Y) ** 2 - a - b, g - 2 * zz, g, -(a + b))


def _add(p, q):
    """add-2008-hwcd-3: T1·T2, then ·2d."""
    X1, Y1, Z1, T1 = p
    X2, Y2, Z2, T2 = q
    a, b = (Y1 - X1) * (Y2 - X2), (Y1 + X1) * (Y2 + X2)
    c, d = T1 * T2 % P * TWO_D, 2 * Z1 * Z2
    return _finish(b - a, d - c, d + c, b + a)


def _madd(p, entry):
    """madd-2008-hwcd of an affine entry (y-x, y+x, 2d·x·y)."""
    X1, Y1, Z1, T1 = p
    ymx, ypx, t2d = entry
    a, b, c, d = (Y1 - X1) * ymx, (Y1 + X1) * ypx, T1 * t2d, 2 * Z1
    return _finish(b - a, d - c, d + c, b + a)


def _python_chain(x, op, reps):
    """The yardstick: each op's chain on Python ints, the point ops on
    the JAX kernel's single-point formulas; the value, or X, mod p."""
    out = []
    b_tab = [tuple(field.from_limbs(c) % P for c in e) for e in ek.B_TABLE]
    for lane in range(x.shape[1]):
        v = int.from_bytes(bytes(int(b) for b in x[:, lane]), "little") % P
        w0 = int(x[0, lane]) & 15
        p = q = (v, 2 * v % P, 1, 2 * v * v % P)
        if op == "mul":
            u, w = v, 2 * v % P
            for _ in range(reps):
                u, w = u * w % P, u
            v = u
        elif op == "sqr":
            v = pow(v, 2 ** reps, P)
        elif op == "select16":
            v = sum(b_tab[(w0 + j) & 15][0] for j in range(reps)) % P
        elif op in mb.POINT_OPS:
            for j in range(reps):
                if op == "double":
                    q = _dbl(q)
                elif op == "add":
                    q = _add(q, p)
                elif op == "madd":
                    q = _madd(q, b_tab[3])
                else:
                    for _ in range(4):
                        q = _dbl(q)
                    q = _add(_madd(q, b_tab[(w0 + j) & 15]), p)
            v = q[0]
        out.append(v)
    return out


@pytest.mark.parametrize("op", ["carry", "mul", "sqr", "select16"])
def test_long_chains_match_python_ints(op):
    """At the full REPS the plain chain stays exact (no int64 overflow,
    no drift out of the resting bound)."""
    x = _x(seed=11, lanes=4)
    assert _port_vals(x, op, mb.REPS[op]) == _python_chain(x, op,
                                                           mb.REPS[op])


def test_point_chain_is_the_curve_group_law():
    """The point functions the double, add and window chains run, on a
    real curve point (the seed (x, 2x) is not on the curve): three
    doublings of B and an add of B give 9·B."""
    two_d = torch.tensor(field.balanced(2 * ref.D % ref.P),
                         dtype=torch.int64)
    bx, by = ref.B

    def to(v):
        return torch.tensor([field.balanced(v)], dtype=torch.int64)

    p = (to(bx), to(by), to(1), to(bx * by % P))
    q = p
    for _ in range(3):
        q = ek._ext_double(q)
    q = ek._ext_add(q, p, two_d)
    X, Y, Z = (field.from_limbs(c[0]) for c in q[:3])
    want = ref.scalar_mult(9, ref.B)
    zi = pow(Z, P - 2, P)
    assert (X * zi % P, Y * zi % P) == want


def test_run_suite_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        mb.run_suite()
    with pytest.raises(ValueError, match="on the card"):
        mb.run_suite(device="cpu", m=64)


def test_module_main_fails_without_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "-m", "cometbft_tpu_torch.ops.microbench",
         "--m", "64"], cwd=REPO, capture_output=True, text=True,
        timeout=120)
    assert out.returncode != 0
    assert out.stdout == ""
    assert "CUDA is not available" in out.stderr


@pytest.mark.parametrize("fault", ["dtype", "rows", "layout", "op", "reps",
                                   "device", "not_tensor"])
def test_wrapper_rejects_bad_inputs(fault):
    x = torch.zeros(32, 4, dtype=torch.int32)
    op, reps, exc = "mul", 3, ValueError
    if fault == "dtype":
        x, exc = x.long(), TypeError
    elif fault == "rows":
        x = torch.zeros(31, 4, dtype=torch.int32)
    elif fault == "layout":
        x = torch.zeros(4, 32, dtype=torch.int32).t()
    elif fault == "op":
        op = "pairing"
    elif fault == "reps":
        reps = -1
    elif fault == "device":
        x = x.to("meta")
    else:
        x, exc = x.numpy(), TypeError
    before = dict(mb.launches)
    with pytest.raises(exc):
        mb.bench_cols(x, op, reps)
    assert mb.launches == before


def test_wrapper_runs_plain_version_on_cpu_tensors():
    x = torch.from_numpy(_x(lanes=3))
    before = dict(mb.launches)
    got = mb.bench_cols(x, "window", 1)
    assert torch.equal(got, mb.bench_cols_plain(x, "window", 1))
    assert mb.launches == before


def test_suite_input_is_seeded_bytes():
    x = mb.suite_input(64, "cpu")
    assert x.dtype == torch.int32 and x.shape == (32, 64)
    assert x.is_contiguous()
    assert torch.equal(x, mb.suite_input(64, "cpu"))
    assert 0 <= int(x.min()) and int(x.max()) <= 255


def _sass_function(op_index, body, name="mb_kernel"):
    """A cuobjdump-style function: two setup lines, a loop of ``body``
    opcodes closed by a backward branch, then EXIT."""
    lines = [f"\t\tFunction : _ZN4anon{name}ILi{op_index}EEEvPKiS2_iiPi",
             "        /*0000*/                   LDC R1, c[0x0][0x28] ;",
             "        /*0010*/                   S2R R0, SR_TID.X ;"]
    addr = 0x20
    for opc in body:
        lines.append(f"        /*{addr:04x}*/              {opc} R2, R3 ;")
        addr += 0x10
    lines.append(f"        /*{addr:04x}*/              @P0   BRA 0x20 ;")
    lines.append(f"        /*{addr + 0x10:04x}*/                   EXIT ;")
    return "\n".join(lines)


def test_sass_loop_bodies_counts_the_backward_branch_span():
    ops = list(mb.REPS)
    sass = "\n".join([
        _sass_function(ops.index("mul"), ["IMAD.WIDE"] * 5 + ["IADD3"] * 2),
        _sass_function(ops.index("sqr"), ["IMAD"] * 3),
        _sass_function(ops.index("noop"), ["MOV"]),
        _sass_function(ops.index("carry"), ["SHF.R.S64"], name="other"),
        _sass_function(ops.index("double"),
                       ["SHFL.IDX"] * 4 + ["IMAD.WIDE.U32"] * 2),
        _sass_function(ops.index("window"), ["SHFL.IDX"]),
    ])
    got = mb.sass_loop_bodies(sass)
    # the loop is the body plus its branch; setup and EXIT are outside it
    assert got == {"mul": (8, [("IMAD.WIDE", 5), ("IADD3", 2), ("BRA", 1)]),
                   "sqr": (4, [("IMAD", 3), ("BRA", 1)]),
                   "double": (7, [("SHFL.IDX", 4), ("IMAD.WIDE.U32", 2),
                                  ("BRA", 1)])}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    # 96 lanes, and lane counts that leave the point ops (a quad a lane,
    # 16 lanes a block) a partial quad, warp or block
    for lanes in (96, 1, 3, 5, 33):
        x = torch.from_numpy(_x(seed=lanes, lanes=max(lanes, 2))[:, :lanes]
                             .copy()).cuda()
        for op in mb.REPS:
            before = mb.launches[op]
            got = mb.bench_cols(x, op, 3)
            torch.cuda.synchronize()
            assert mb.launches[op] == before + 1
            assert torch.equal(got, mb.bench_cols_plain(x, op, 3)), (op,
                                                                     lanes)
