"""Per-primitive microbenchmarks of the batch ed25519 verifier on the
card: the floor analysis.

Counterpart of cometbft_tpu/ops/microbench.py (``_make_kernel``, :82,
launched by ``_bench_call``, :178).  Each op runs ``reps`` iterations of
one primitive of the verify kernel (ops/csrc/ed25519_field.cuh, the
same device functions ed25519_verify.cu runs, not copies) per lane, so a
record gives the card's cost of a carry, a field multiply, a squaring,
a doubling, the two addition forms, the 16-entry B-table select and one
full ladder window.  The kernels are ops/csrc/microbench.cu.

The seed of every lane is x = its 32 input bytes as a field element
(all 256 bits, as the JAX kernel reads them), y = 2x and the point
p = (x, y, 1, xy); values are bounded limb vectors, not curve points,
and the cost of a primitive does not depend on them.

Where the JAX kernel writes an 8-row sink of 8 of its 24 limbs, the
kernel here writes the whole result, ``[10, n]`` int32 (the limbs of the
value, or of X): ten limbs hold the whole value, so the tests can check
it mod p.  ``bench_cols`` launches the kernel for CUDA tensors and runs
``bench_cols_plain`` (the same chain on ops/field.py and
ops/ed25519_kernel's point functions, limb for limb) for CPU tensors.

The JAX module's ``generate()`` exports its kernels ahead of time for
the TPU; here the nvcc build of ops/_build.py takes its place, so there
is no counterpart.

    python -m cometbft_tpu_torch.ops.microbench [--m N] [--reps-timing K]
                                                [--sass]

runs the suite on the card and prints one JSON record per line; with
``--sass`` it also prints, for ``carry``, ``mul`` and ``sqr``, the
instructions of the kernel's loop body (cuobjdump's SASS of the built
library) and the rate at which the card issued them in the timed run.
"""
from __future__ import annotations

import argparse
import collections
import ctypes
import json
import re
import statistics
import subprocess
from pathlib import Path

import numpy as np
import torch

from ..device import resolve
from . import ed25519_kernel as ek
from . import field

M_DEFAULT = 16384

# repetitions per primitive (the JAX module's, unchanged)
REPS = {
    "noop": 1,
    "carry": 4096,
    "mul": 1024,
    "sqr": 1024,
    "double": 128,
    "add": 128,
    "madd": 128,
    "select16": 512,
    "window": 16,
}

# Wrapper launches of each op's CUDA kernel in this process (plain
# integers; callers reset them to 0 to count the launches of one run).
launches = dict.fromkeys(REPS, 0)

_OP_INDEX = {op: i for i, op in enumerate(REPS)}    # microbench.cu's enum
_OUT_ROWS = field.LIMBS


def _check(x_cols, op, reps) -> None:
    if not isinstance(x_cols, torch.Tensor):
        raise TypeError("x_cols must be a torch.Tensor")
    if x_cols.dtype != torch.int32:
        raise TypeError(f"x_cols must be int32, got {x_cols.dtype}")
    if x_cols.dim() != 2 or x_cols.shape[0] != 32:
        raise ValueError(f"x_cols must have shape [32, n], got "
                         f"{list(x_cols.shape)}")
    if not x_cols.is_contiguous():
        raise ValueError("x_cols must be contiguous")
    if op not in REPS:
        raise ValueError(f"unknown op {op!r}; expected one of {list(REPS)}")
    if not isinstance(reps, int) or not 0 <= reps < 2**31:
        raise ValueError(f"reps must be an int in [0, 2^31), got {reps!r}")


# --- plain version ----------------------------------------------------------

def bench_cols_plain(x_cols: torch.Tensor, op: str, reps: int
                     ) -> torch.Tensor:
    """The plain PyTorch version of the kernel, on any device.  Same
    arguments and result as ``bench_cols``."""
    _check(x_cols, op, reps)
    dev = x_cols.device
    consts = torch.tensor(ek.CONSTS, dtype=torch.int64, device=dev)
    two_d = consts[10:20]
    b_tab = consts[30:].reshape(16, 3, field.LIMBS)
    b = x_cols.t().long() & 0xFF                        # [n, 32]
    raw = field.from_bytes(b)
    raw[:, 0] += 19 * (b[:, 31] >> 7)                   # bit 255 at 19
    x = field.carry(raw)
    y = field.carry(x + x)
    one = torch.zeros_like(x)
    one[:, 0] = 1
    p = (x, y, one, field.mul(x, y))
    w0 = b[:, 0] & 15

    if op == "noop":
        res = x
    elif op == "carry":
        res = x
        for _ in range(reps):
            res = field.carry(res)
    elif op == "mul":
        res, w = x, y
        for _ in range(reps):
            res, w = field.mul(res, w), res
    elif op == "sqr":
        res = x
        for _ in range(reps):
            res = field.sqr(res)
    elif op == "select16":
        acc = torch.zeros_like(x)
        for j in range(reps):
            acc = acc + b_tab[(w0 + j) & 15, 0]
        res = field.carry(acc)
    else:
        q = p
        for j in range(reps):
            if op == "double":
                q = ek._ext_double(q)
            elif op == "add":
                q = ek._ext_add(q, p, two_d)
            elif op == "madd":
                q = ek._madd_affine(q, b_tab[3].unbind(0))
            else:                                       # window
                for i in range(4):
                    q = ek._ext_double(q, need_t=(i == 3))
                w = (w0 + j) & 15
                q = ek._madd_affine(q, b_tab[w].unbind(1))
                q = ek._ext_add(q, p, two_d)            # lane entry w = p
        res = q[0]
    return res.t().to(torch.int32).contiguous()


# --- the CUDA kernel's wrapper ----------------------------------------------

def bench_cols(x_cols: torch.Tensor, op: str, reps: int) -> torch.Tensor:
    """``[10, n]`` int32 result of ``reps`` iterations of ``op`` per lane
    of ``x_cols`` (``[32, n]`` int32 bytes).  CUDA tensors launch the
    kernel on the current stream (and raise if it cannot be built or
    launched); CPU tensors run ``bench_cols_plain``."""
    _check(x_cols, op, reps)
    dev = x_cols.device
    if dev.type == "cpu":
        return bench_cols_plain(x_cols, op, reps)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    n = x_cols.shape[1]
    out = torch.empty(_OUT_ROWS, n, dtype=torch.int32, device=dev)
    if n == 0:
        return out
    from ._build import load
    lib = load()
    consts = ek._device_consts(dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = lib.microbench_launch(
            _OP_INDEX[op], x_cols.data_ptr(), consts.data_ptr(), n, reps,
            out.data_ptr(), ctypes.c_void_p(stream))
    if rc != 0:
        raise RuntimeError(
            f"microbench {op} launch failed: "
            f"{lib.ed25519_error_string(rc).decode()} ({rc})")
    launches[op] += 1
    return out


def suite_input(m: int, device) -> torch.Tensor:
    """The ``[32, m]`` int32 seed bytes ``run_suite`` times on (seed 7)."""
    rng = np.random.default_rng(7)
    return torch.from_numpy(rng.integers(0, 256, (32, m), dtype=np.int32)
                            ).to(device)


def run_suite(device=None, m: int = M_DEFAULT, reps_timing: int = 5
              ) -> list[dict]:
    """Time every op on ``suite_input(m)`` once warm and then
    ``reps_timing`` times with CUDA events; one record per op.  Runs on
    the card only: a failing op raises."""
    dev = resolve(device)
    if dev.type != "cuda":
        raise ValueError(f"run_suite times kernels on the card, not {dev}")
    x = suite_input(m, dev)
    name = torch.cuda.get_device_name(dev)
    records = []
    with torch.cuda.device(dev):
        for op, k in REPS.items():
            bench_cols(x, op, k)                        # warm
            torch.cuda.synchronize(dev)
            runs = []
            for _ in range(reps_timing):
                e0 = torch.cuda.Event(enable_timing=True)
                e1 = torch.cuda.Event(enable_timing=True)
                e0.record()
                bench_cols(x, op, k)
                e1.record()
                e1.synchronize()
                runs.append(e0.elapsed_time(e1))
            med = statistics.median(runs)
            records.append(dict(metric=f"mb_{op}", bucket=m, value_ms=med,
                                reps=k, per_op_us=med * 1e3 / k, runs=runs,
                                device=name))
    return records


# --- SASS loop bodies --------------------------------------------------------

_SASS_LINE = re.compile(r"\s*/\*([0-9a-f]{4,})\*/\s+(?:@!?U?P\w+\s+)?"
                        r"([A-Z][A-Z0-9_.]*)(.*)")
# H100 SXM: 132 SMs at 1.98 GHz boost; each SM issues at most 4
# warp-instructions (128 lane-instructions) a clock
SM_CLOCKS_PER_S = 132 * 1.98e9


def sass_loop_bodies(sass: str, ops=("carry", "mul", "sqr")) -> dict:
    """{op: (instructions, [(opcode, count), ...])} of the largest loop
    body (the span of a backward branch) in ``mb_kernel<op>``, from
    ``cuobjdump -sass`` text: what the card issues per iteration."""
    names = list(REPS)
    out = {}
    for func in sass.split("Function : ")[1:]:
        m = re.search(r"mb_kernelILi(\d+)E", func.split("\n", 1)[0])
        if not m or names[int(m.group(1))] not in ops:
            continue
        code = [(int(a, 16), opc, rest) for a, opc, rest in
                (mm.groups() for mm in map(_SASS_LINE.match,
                                           func.split("\n")) if mm)]
        best = []
        for addr, opc, rest in code:
            tgt = re.search(r"0x([0-9a-f]+)", rest)
            if opc.startswith("BRA") and tgt and int(tgt.group(1), 16) < addr:
                body = [o for a, o, _ in code
                        if int(tgt.group(1), 16) <= a <= addr]
                best = max(best, body, key=len)
        out[names[int(m.group(1))]] = (
            len(best), collections.Counter(best).most_common())
    return out


def _library_sass() -> str:
    from . import _build
    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    return subprocess.run([str(cuobjdump), "-sass", str(_build.build())],
                          capture_output=True, text=True, check=True).stdout


def main() -> int:
    ap = argparse.ArgumentParser(description="ed25519 primitive "
                                 "microbenchmarks on the card")
    ap.add_argument("--m", type=int, default=M_DEFAULT, help="lanes")
    ap.add_argument("--reps-timing", type=int, default=5)
    ap.add_argument("--sass", action="store_true",
                    help="also print the carry/mul/sqr loop bodies")
    args = ap.parse_args()
    records = run_suite(m=args.m, reps_timing=args.reps_timing)
    for rec in records:
        print(json.dumps(rec), flush=True)
    if args.sass:
        by_op = {r["metric"][3:]: r for r in records}
        for op, (n, mix) in sass_loop_bodies(_library_sass()).items():
            rec = by_op[op]
            rate = (n * rec["reps"] * args.m / (rec["value_ms"] * 1e-3) /
                    SM_CLOCKS_PER_S)
            print(json.dumps(dict(
                metric=f"sass_mb_{op}", bucket=args.m, loop_instructions=n,
                opcodes=dict(mix), lane_instructions_per_sm_clock=rate,
                issue_limit=128, device=rec["device"])), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
