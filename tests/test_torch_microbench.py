"""The port's microbenchmarks (cometbft_tpu_torch/ops/microbench.py, B3)
against the JAX package's: for every op, the plain version's chain on
8 seeded lanes equals, mod p, the same chain built from the JAX
package's own primitives (ed25519_pallas: _from_bytes, _norm, _mul_nn,
_make_sqr, _ext_double, _ext_add, _madd_affine; microbench._where_tree)
with its packed constants sliced as _unpack_consts slices them.  The
formulas are the same on both sides (dbl-2008-hwcd, add-2008-hwcd-3,
madd-2008-hwcd), so every coordinate agrees as an integer mod p.  Long
chains at the full REPS are held to Python ints.  All results are
integers: tolerance is exact equality."""
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

P = field.P
REPO = Path(__file__).resolve().parents[1]


def _x(seed=7, lanes=8):
    rng = np.random.default_rng(seed)
    x = rng.integers(0, 256, (32, lanes), dtype=np.int32)
    x[31, 0] |= 0x80                 # bit 255 set on at least one lane
    x[31, 1] &= 0x7F
    return x


def _port_vals(x, op, reps):
    out = mb.bench_cols_plain(torch.from_numpy(x), op, reps)
    assert out.dtype == torch.int32 and out.shape == (10, x.shape[1])
    return [field.from_limbs(out[:, lane]) for lane in range(x.shape[1])]


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


def test_reps_and_m_default_match_jax():
    assert mb.REPS == jmb.REPS
    assert list(mb.REPS) == list(jmb.REPS)
    assert mb.M_DEFAULT == jmb.M_DEFAULT


def _python_chain(x, op, reps):
    """The value chain of carry, mul, sqr and select16 on Python ints."""
    out = []
    b_tab = [field.from_limbs(e[0]) for e in ek.B_TABLE]     # y - x
    for lane in range(x.shape[1]):
        v = int.from_bytes(bytes(int(b) for b in x[:, lane]), "little") % P
        if op == "mul":
            u, w = v, 2 * v % P
            for _ in range(reps):
                u, w = u * w % P, u
            v = u
        elif op == "sqr":
            v = pow(v, 2 ** reps, P)
        elif op == "select16":
            w0 = int(x[0, lane]) & 15
            v = sum(b_tab[(w0 + j) & 15] for j in range(reps)) % P
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
    ])
    got = mb.sass_loop_bodies(sass)
    # the loop is the body plus its branch; setup and EXIT are outside it
    assert got == {"mul": (8, [("IMAD.WIDE", 5), ("IADD3", 2), ("BRA", 1)]),
                   "sqr": (4, [("IMAD", 3), ("BRA", 1)])}


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("no CUDA device")
    x = torch.from_numpy(_x(lanes=96)).cuda()
    for op in mb.REPS:
        before = mb.launches[op]
        got = mb.bench_cols(x, op, 3)
        torch.cuda.synchronize()
        assert mb.launches[op] == before + 1
        assert torch.equal(got, mb.bench_cols_plain(x, op, 3)), op
