"""Smoke run of cometbft_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from the sources in this checkout (one library:
ed25519_verify.cu, ed25519_verify8.cu, microbench.cu), holds each
against its plain PyTorch version and the golden model on edge-case
lanes, then verifies a 10,000-validator commit through the port's entry
points (types/validation -> crypto/batch -> ops/ed25519 -> the kernel),
once with the default kernel (B1) and once with
COMETBFT_TPU_TORCH_KERNEL=cuda8 (B2), counting each kernel's launches on
that path.  It times both kernels, their plain versions and the
end-to-end call, traces one verify_commit with torch.profiler for the
device's busy share, and runs the microbenchmark suite (B3) at 16,384
and 262,144 lanes, holding each of its nine kernels to its plain version
on the suite's own inputs.  Any failure exits non-zero.  The last three
lines are the kernels JSON, the card's name and power limit, and
{"ok": true, "device": {...}}.  Signatures are made from --seed with the
golden model in a pool of worker processes.
"""
from __future__ import annotations

import argparse
import contextlib
import hashlib
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

CHAIN_ID = "chip-smoke"
HEIGHT = 1000
VALIDATORS = 10_000
# H100 SXM peaks (NVIDIA data sheet / Hopper white paper): HBM3 bytes/s,
# and integer issue = 132 SMs x 128 lanes x 1.98 GHz boost: each SM
# issues at most 4 warp-instructions (128 lanes) a clock, integer
# multiply-adds run on the FP32 datapath beside the 64 INT32 lanes, and
# the float32 figure of the data sheet (67 TFLOP/s, an FMA counting 2)
# is the same rate.  64 INT32 lanes alone is not a ceiling: the carry
# and mul microbenchmarks at 262,144 lanes run faster than that allows.
HBM_BYTES_PER_S = 3.35e12
SM_CLOCKS_PER_S = 132 * 1.98e9
INT32_OPS_PER_S = 128 * SM_CLOCKS_PER_S
# int32 operations a field multiply needs: 100 limb products into 64-bit
# sums (2 each: low and high halves; an IMAD.WIDE takes two issue
# slots), 10 folds of the upper sum at weight 19 (4 each), 11 carry
# steps of 64-bit add, shift, multiply-subtract and add (8 each).  A
# squaring needs only 55 products (10 diagonal, 45 cross terms taken
# once against a doubled operand) and the same fold and carry.
# Additions, subtractions, doublings and selects between multiplies are
# not counted: a lower bound.
OPS_PER_FIELD_MUL = 2 * 100 + 4 * 10 + 8 * 11
OPS_PER_FIELD_SQR = 2 * 55 + 4 * 10 + 8 * 11
OPS_PER_CARRY = 8 * 11
# B2's own count, for context only (its bound is B1's: same function):
# 256 products (136 in a squaring), 15 folds at 38, 17 carry steps
OPS_PER_FIELD16_MUL = 2 * 256 + 4 * 15 + 8 * 17
OPS_PER_FIELD16_SQR = 2 * 136 + 4 * 15 + 8 * 17
# a select16 step adds one 10-limb table entry into int64 sums
OPS_PER_SELECT_STEP = 2 * 10
# bytes per lane the function must move: A, R (32 B each) and the s, k
# windows (64 B each) as prep_arrays makes them, one verdict byte out
IN_BYTES_PER_LANE = 32 + 32 + 64 + 64
OUT_BYTES_PER_LANE = 1
CONST_BYTES = 510 * 4
# microbench: [32, m] int32 seed bytes in, [10, m] int32 limbs out
MB_IN_BYTES_PER_LANE = 32 * 4
MB_OUT_BYTES_PER_LANE = 10 * 4
MB_BIG = 262_144


def _sign_job(job):
    """Worker: (seed, msg) -> (pub, sig) with the golden model."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    seed, msg = job
    return ref.public_key(seed), ref.sign(seed, msg)


def _seed(base: int, i: int) -> bytes:
    return hashlib.sha256(b"chip-smoke/%d/%d" % (base, i)).digest()


def _log(*a):
    print(*a, flush=True)


def _phase(name):
    _log(f"== {name}")


def _cuda_ms(fn, reps=5):
    """Median of ``reps`` CUDA-event timings after one warm-up."""
    import torch
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        fn()
        e1.record()
        torch.cuda.synchronize()
        times.append(e0.elapsed_time(e1))
    return statistics.median(times)


def _edge_items(rng_seed, pool):
    """~900 (pub, msg, sig) items covering the ZIP-215 edge cases."""
    import numpy as np
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    rng = np.random.default_rng(rng_seed)
    P = ref.P
    msgs = [rng.bytes(40) for _ in range(256)]
    signed = pool.map(_sign_job, [(_seed(rng_seed + 7, i), m)
                                  for i, m in enumerate(msgs)])
    valid = [(pub, m, sig) for (pub, sig), m in zip(signed, msgs)]

    # the 8-torsion subgroup, from L·(random point)
    torsion = set()
    while len(torsion) < 8:
        pt = ref.decompress(rng.bytes(32))
        if pt is not None:
            t = ref.scalar_mult(ref.L, pt)
            for k in range(8):
                torsion.add(ref.scalar_mult(k, t))
    small = [ref.compress(t) for t in sorted(torsion)]

    def neg_zero(y):
        b = bytearray(y.to_bytes(32, "little"))
        b[31] |= 0x80
        return bytes(b)

    items = list(valid)                                   # 256 valid
    for i, (pub, m, sig) in enumerate(valid[:128]):       # 128 corrupted
        kind = i % 4
        if kind == 0:
            sig = sig[:i % 32] + bytes([sig[i % 32] ^ 0x10]) + sig[i % 32 + 1:]
        elif kind == 1:
            j = 32 + i % 32
            sig = sig[:j] + bytes([sig[j] ^ 0x01]) + sig[j + 1:]
        elif kind == 2:
            m = m + b"!"
        else:
            sig = sig[:32] + bytes(32)                    # S = 0
        items.append((pub, m, sig))
    for i in range(32):                                    # S >= L
        pub, m, sig = valid[i]
        s = int.from_bytes(sig[32:], "little") + ref.L
        items.append((pub, m, sig[:32] + s.to_bytes(32, "little")))
    for i in range(128):                                   # small order
        a, r = small[i % 8], small[(i // 8) % 8]
        s = bytes(32) if i % 3 else rng.bytes(31) + b"\x00"
        items.append((a, rng.bytes(9), r + s))
    for k in range(64):                                    # y >= p
        enc = (P + k % 19).to_bytes(32, "little")
        a = small[k % 8] if k % 2 else valid[k][0]
        items.append((a, b"y", enc + bytes(32)))
        items.append((enc, b"y", small[k % 8] + bytes(32)))
    for k in range(16):                                    # x = -0
        a = neg_zero(1 if k % 2 else P - 1)
        r = neg_zero(P - 1 if k % 2 else 1)
        items.append((a, rng.bytes(5), r + bytes(32)))
        items.append((valid[k][0], valid[k][1], r + valid[k][2][32:]))
    for _ in range(128):                                   # random bytes
        items.append((rng.bytes(32), rng.bytes(12), rng.bytes(64)))
    return items


@contextlib.contextmanager
def _counting(module, names):
    """Replace module.<name> for each name by a wrapper that counts its
    calls; yields the counts and restores the originals."""
    counts = dict.fromkeys(names, 0)
    orig = {name: getattr(module, name) for name in names}

    def wrap(name):
        def wrapped(*a):
            counts[name] += 1
            return orig[name](*a)
        return wrapped

    for name in names:
        setattr(module, name, wrap(name))
    try:
        yield counts
    finally:
        for name in names:
            setattr(module, name, orig[name])


def _field_ops_per_lane():
    """(general multiplies, squarings) one lane of the kernel does,
    counted by running the plain version (which repeats the kernel step
    by step, with the same data-independent control flow) on one lane
    with counting wrappers around field.mul and field.sqr."""
    import torch
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import field
    z32 = torch.zeros(32, 1, dtype=torch.int32)
    z64 = torch.zeros(64, 1, dtype=torch.int32)
    with _counting(field, ("mul", "sqr")) as counts:
        ek.verify_cols_plain(z32, z32, z64, z64)
    # field.sqr goes through field.mul, so every squaring counted twice
    return counts["mul"] - counts["sqr"], counts["sqr"]


def _field16_ops_per_lane():
    """(general multiplies, squarings) one lane of the second kernel
    does, counted the same way on its plain version (field16.sqr does
    not go through field16.mul)."""
    import torch
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    from cometbft_tpu_torch.ops import field16
    z32 = torch.zeros(32, 1, dtype=torch.int32)
    z64 = torch.zeros(64, 1, dtype=torch.int32)
    with _counting(field16, ("mul", "sqr")) as counts:
        ek8.verify_cols_plain(z32, z32, z64, z64)
    return counts["mul"], counts["sqr"]


def _mb_ops_per_lane():
    """{op: (int32 ops, multiplies, squarings, carries)} one lane of each
    microbench op does at its REPS, seed included, counted on the plain
    version (one lane; the control flow does not depend on the data).
    field.mul carries once and field.sqr goes through field.mul, so
    carries outside a multiply are carry calls less mul calls."""
    import torch
    from cometbft_tpu_torch.ops import field
    from cometbft_tpu_torch.ops import microbench as mb
    x = torch.zeros(32, 1, dtype=torch.int32)
    out = {}
    for op, reps in mb.REPS.items():
        with _counting(field, ("mul", "sqr", "carry")) as c:
            mb.bench_cols_plain(x, op, reps)
        muls, sqrs = c["mul"] - c["sqr"], c["sqr"]
        carries = c["carry"] - c["mul"]
        ops = (muls * OPS_PER_FIELD_MUL + sqrs * OPS_PER_FIELD_SQR +
               carries * OPS_PER_CARRY)
        if op == "select16":
            ops += reps * OPS_PER_SELECT_STEP
        out[op] = (ops, muls, sqrs, carries)
    return out


def _roofline(ops, nbytes):
    """(bound_ms, bound_by): the larger of ops over the int32 issue rate
    and bytes over the memory rate."""
    ops_ms = ops / INT32_OPS_PER_S * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), "operations" if ops_ms >= bytes_ms \
        else "bytes"


def _bound(lanes, muls, sqrs):
    """(bound_ms, bound_by, ops, nbytes) for one launch over ``lanes``."""
    ops = (muls * OPS_PER_FIELD_MUL + sqrs * OPS_PER_FIELD_SQR) * lanes
    nbytes = lanes * (IN_BYTES_PER_LANE + OUT_BYTES_PER_LANE) + CONST_BYTES
    return (*_roofline(ops, nbytes), ops, nbytes)


def _mb_bound(lanes, ops_per_lane):
    """(bound_ms, bound_by) of one microbench launch over ``lanes``."""
    nbytes = lanes * (MB_IN_BYTES_PER_LANE + MB_OUT_BYTES_PER_LANE) + \
        CONST_BYTES
    return _roofline(ops_per_lane * lanes, nbytes)


def _reject_corrupted(validation, vals, block_id, commit, bad_idx=7777):
    """verify_commit must reject the commit with signature #bad_idx
    flipped, naming the index; the commit is restored after."""
    from cometbft_tpu_torch.types.commit import CommitSig
    good = commit.signatures[bad_idx]
    flipped = good.signature[:40] + bytes([good.signature[40] ^ 1]) + \
        good.signature[41:]
    commit.signatures[bad_idx] = CommitSig(
        good.block_id_flag, good.validator_address, good.timestamp, flipped)
    try:
        validation.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
    except validation.VerificationError as e:
        if not str(e).startswith(f"wrong signature (#{bad_idx}): "):
            raise AssertionError(f"wrong rejection: {e}") from e
        _log(f"corrupted #{bad_idx} rejected: {str(e)[:40]}...")
    else:
        raise AssertionError(f"corrupted signature #{bad_idx} accepted")
    finally:
        commit.signatures[bad_idx] = good


def _device_busy(fn):
    """Run fn once under torch.profiler; returns (window_ms, busy_ms,
    kernel_ms, device_events): the host-clock window of the call, the
    union of all device activity in it, and the time in the verify
    kernel.  busy_ms is None when the profiler saw no device event."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        window_ms = (time.perf_counter() - t0) * 1e3
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not dev:
        return window_ms, None, None, 0
    busy_us, end = 0.0, float("-inf")
    for s0, s1 in sorted((e.time_range.start, e.time_range.end)
                         for e in dev):
        if s1 > end:
            busy_us += s1 - max(s0, end)
            end = s1
    kernel_us = sum(e.time_range.end - e.time_range.start for e in dev
                    if "ed25519_verify_kernel" in e.name)
    return window_ms, busy_us / 1e3, kernel_us / 1e3, len(dev)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t_start = time.perf_counter()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    from cometbft_tpu_torch.ops import _build
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    from cometbft_tpu_torch.ops import microbench as mb
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.canonical import (
        PRECOMMIT_TYPE, vote_sign_bytes_template)
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    from cometbft_tpu_torch.types.vote import BLOCK_ID_FLAG_COMMIT

    # phase 3 drives the default kernel; phase 3b sets cuda8 itself
    os.environ.pop(oe.KERNEL_ENV, None)
    dev = torch.device("cuda")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    _log("torch", torch.__version__, "cuda", torch.version.cuda,
         "device", torch.cuda.get_device_name(0))

    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 4) as pool:
        # -- 1. build -------------------------------------------------------
        _phase("1 build")
        t0 = time.perf_counter()
        _build.load()
        _log(f"build_seconds {time.perf_counter() - t0:.3f} "
             f"(nvcc {_build.build_info['seconds']:.3f} s wall for "
             f"{', '.join(_build.SOURCES)}, compiled in parallel and "
             f"linked into one library, "
             f"cached={_build.build_info['cached']})")
        _log(_build.build_info["ptxas"].strip())

        # -- 2. kernel vs plain on edge-case lanes --------------------------
        _phase("2 kernel vs plain, 1024 edge-case lanes")
        items = _edge_items(args.seed, pool)
        a, r, s, k, pre_bad = oe.prep_arrays(items, 1024)
        cols = [oe.to_cols(x, dev) for x in (a, r, s, k)]
        got = ek.verify_cols(*cols)
        torch.cuda.synchronize()
        plain = ek.verify_cols_plain(*cols)
        torch.cuda.synchronize()
        max_abs_err = int((got.int() - plain.int()).abs().max().item())
        if not torch.equal(got, plain):
            raise AssertionError(
                f"kernel != plain on {int((got != plain).sum())} of 1024 "
                f"lanes")
        if not bool(got[len(items):].all()):
            raise AssertionError("a padding lane did not verify")
        mask = got.cpu().numpy()[:len(items)].copy()
        mask[pre_bad[:len(items)]] = False
        subset = list(range(0, len(items), max(1, len(items) // 128)))[:128]
        golden = [ref.verify(*items[i]) for i in subset]
        if mask[subset].tolist() != golden:
            raise AssertionError("kernel disagrees with the golden model")
        _log(f"lanes {len(items)} real + {1024 - len(items)} padding; "
             f"valid {int(mask.sum())}; kernel == plain on all 1024; "
             f"golden subset {len(subset)} agrees "
             f"({sum(golden)} valid); max_abs_err {max_abs_err}")

        # -- 2b. second kernel vs its plain version and the first -----------
        _phase("2b second kernel (B2) vs plain and B1, same 1024 lanes")
        got8 = ek8.verify_cols(*cols)
        torch.cuda.synchronize()
        plain8 = ek8.verify_cols_plain(*cols)
        torch.cuda.synchronize()
        max_abs_err8 = int((got8.int() - plain8.int()).abs().max().item())
        if not torch.equal(got8, plain8):
            raise AssertionError(
                f"B2 kernel != B2 plain on {int((got8 != plain8).sum())} of "
                f"1024 lanes")
        if not torch.equal(got8, got):
            raise AssertionError(
                f"B2 kernel != B1 kernel on {int((got8 != got).sum())} of "
                f"1024 lanes")
        mask8 = got8.cpu().numpy()[:len(items)].copy()
        mask8[pre_bad[:len(items)]] = False
        if mask8[subset].tolist() != golden:
            raise AssertionError("B2 kernel disagrees with the golden model")
        _log(f"B2 kernel == B2 plain == B1 kernel on all 1024 lanes; "
             f"golden subset {len(subset)} agrees; max_abs_err "
             f"{max_abs_err8}")

        # -- 3. main path at full size --------------------------------------
        n = VALIDATORS
        _phase(f"3 main path: {n}-validator commit")
        block_id = BlockID(hashlib.sha256(b"block").digest(),
                           PartSetHeader(2, hashlib.sha256(b"p").digest()))
        make = vote_sign_bytes_template(CHAIN_ID, PRECOMMIT_TYPE, HEIGHT, 0,
                                        block_id)
        stamps = [Timestamp.from_unix_ns(1_700_000_000_000_000_000 + j)
                  for j in range(n)]
        t0 = time.perf_counter()
        signed = pool.map(_sign_job, [(_seed(args.seed, j), make(stamps[j]))
                                      for j in range(n)], chunksize=64)
        _log(f"signed {n} votes in {time.perf_counter() - t0:.1f} s")
    # the pool is closed: nothing below forks or spawns

    keys = [Ed25519PubKey(pub) for pub, _ in signed]
    vals = ValidatorSet([Validator.new(pk, 10) for pk in keys])
    slot = {pk.address(): j for j, pk in enumerate(keys)}
    sigs = []
    for v in vals.validators:
        j = slot[v.address]
        sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, stamps[j],
                              signed[j][1]))
    commit = Commit(height=HEIGHT, round=0, block_id=block_id,
                    signatures=sigs)
    tiles_all = len(tile_plan(n, DEFAULT_TILE))
    tiles_light = len(tile_plan(n * 2 // 3 + 1, DEFAULT_TILE))

    ek.launches = 0
    t0 = time.perf_counter()
    validation.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
    first_ms = (time.perf_counter() - t0) * 1e3
    main_launches = ek.launches
    if main_launches != tiles_all:
        raise AssertionError(f"verify_commit launched the kernel "
                             f"{main_launches} times, expected {tiles_all}")
    ek.launches = 0
    validation.verify_commit_light(CHAIN_ID, vals, block_id, HEIGHT, commit)
    light_launches = ek.launches
    if light_launches != tiles_light:
        raise AssertionError(f"verify_commit_light launched "
                             f"{light_launches}, expected {tiles_light}")
    _log(f"verify_commit ok ({main_launches} launches, first call "
         f"{first_ms:.1f} ms); verify_commit_light ok "
         f"({light_launches} launches)")

    _reject_corrupted(validation, vals, block_id, commit)

    # -- 3b. the same commit through the second kernel --------------------
    _phase(f"3b main path with {oe.KERNEL_ENV}=cuda8: {n}-validator commit")
    os.environ[oe.KERNEL_ENV] = "cuda8"
    try:
        ek.launches = ek8.launches = 0
        validation.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
        main8_launches, b1_under_cuda8 = ek8.launches, ek.launches
        if (main8_launches, b1_under_cuda8) != (tiles_all, 0):
            raise AssertionError(
                f"cuda8 verify_commit launched B2 {main8_launches} and B1 "
                f"{b1_under_cuda8} times, expected {tiles_all} and 0")
        ek8.launches = 0
        validation.verify_commit_light(CHAIN_ID, vals, block_id, HEIGHT,
                                       commit)
        light8_launches = ek8.launches
        if light8_launches != tiles_light or ek.launches != 0:
            raise AssertionError(
                f"cuda8 verify_commit_light launched B2 {light8_launches} "
                f"and B1 {ek.launches} times, expected {tiles_light} and 0")
        _log(f"cuda8 verify_commit ok ({main8_launches} B2 launches, 0 B1); "
             f"verify_commit_light ok ({light8_launches} B2 launches)")
        _reject_corrupted(validation, vals, block_id, commit)
    finally:
        os.environ.pop(oe.KERNEL_ENV, None)

    # -- 4. times ---------------------------------------------------------
    _phase("4 times")
    entries = [(vals.validators[i].pub_key.bytes(),
                commit.vote_sign_bytes(CHAIN_ID, i), cs.signature)
               for i, cs in enumerate(commit.signatures)]
    e2e = []
    for _ in range(3):
        t0 = time.perf_counter()
        validation.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
        e2e.append((time.perf_counter() - t0) * 1e3)
    prep = []
    for _ in range(3):
        t0 = time.perf_counter()
        for lo, hi in tile_plan(n, DEFAULT_TILE):
            oe.prep_arrays(entries[lo:hi], oe._bucket(hi - lo))
        prep.append((time.perf_counter() - t0) * 1e3)

    vb = []
    for _ in range(3):
        t0 = time.perf_counter()
        oe.verify_batch(entries)
        vb.append((time.perf_counter() - t0) * 1e3)

    # kernel times per bucket; at the main path's tile (its first tile of
    # real signatures, padded to 4096) and at 10240 lanes the kernel is
    # also held to the plain version — exact equality, verdicts are bools
    plan = tile_plan(n, DEFAULT_TILE)
    lo, hi = plan[0]
    tile_lanes = oe._bucket(hi - lo)
    timings, plain_times = {}, {}
    for m, chunk in ((1024, entries[:1024]), (tile_lanes, entries[lo:hi]),
                     (10240, entries)):
        a, r, s, k, _ = oe.prep_arrays(chunk, m)
        cols = [oe.to_cols(x, dev) for x in (a, r, s, k)]
        timings[m] = _cuda_ms(lambda: ek.verify_cols(*cols))
        if m == 1024:
            continue
        got = ek.verify_cols(*cols)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        plain = ek.verify_cols_plain(*cols)
        torch.cuda.synchronize()
        plain_times[m] = (time.perf_counter() - t0) * 1e3
        if not torch.equal(got, plain):
            raise AssertionError(f"kernel != plain at {m} lanes")
        max_abs_err = max(max_abs_err, int(
            (got.int() - plain.int()).abs().max().item()))

    # the kernel's share of one commit: the main path's launches, back
    # to back on already-prepped tiles
    tiles = []
    for t_lo, t_hi in plan:
        a, r, s, k, _ = oe.prep_arrays(entries[t_lo:t_hi],
                                       oe._bucket(t_hi - t_lo))
        tiles.append([oe.to_cols(x, dev) for x in (a, r, s, k)])
    commit_kernel_ms = _cuda_ms(
        lambda: [ek.verify_cols(*cols) for cols in tiles])

    muls, sqrs = _field_ops_per_lane()
    bounds = {m: _bound(m, muls, sqrs) for m in (tile_lanes, 10240)}
    commit_bound_ms = sum(_bound(oe._bucket(t_hi - t_lo), muls, sqrs)[0]
                          for t_lo, t_hi in plan)

    # -- 4b. second kernel times; held to its plain version at the tile --
    # and to the first kernel at 10240 lanes
    _phase("4b times, second kernel (B2)")
    timings8 = {}
    for m, chunk in ((tile_lanes, entries[lo:hi]), (10240, entries)):
        a, r, s, k, _ = oe.prep_arrays(chunk, m)
        cols = [oe.to_cols(x, dev) for x in (a, r, s, k)]
        timings8[m] = _cuda_ms(lambda: ek8.verify_cols(*cols))
        got8 = ek8.verify_cols(*cols)
        torch.cuda.synchronize()
        if m == tile_lanes:
            t0 = time.perf_counter()
            plain8 = ek8.verify_cols_plain(*cols)
            torch.cuda.synchronize()
            plain8_tile_ms = (time.perf_counter() - t0) * 1e3
            if not torch.equal(got8, plain8):
                raise AssertionError(f"B2 kernel != plain at {m} lanes")
            max_abs_err8 = max(max_abs_err8, int(
                (got8.int() - plain8.int()).abs().max().item()))
        elif not torch.equal(got8, ek.verify_cols(*cols)):
            raise AssertionError(f"B2 kernel != B1 kernel at {m} lanes")
    commit8_kernel_ms = _cuda_ms(
        lambda: [ek8.verify_cols(*cols) for cols in tiles])
    muls8, sqrs8 = _field16_ops_per_lane()
    own8_ops = muls8 * OPS_PER_FIELD16_MUL + sqrs8 * OPS_PER_FIELD16_SQR

    # -- 5. device busy share of one verify_commit, traced ----------------
    _phase("5 profile one verify_commit")
    window_ms, busy_ms, traced_kernel_ms, n_dev = _device_busy(
        lambda: validation.verify_commit(CHAIN_ID, vals, block_id, HEIGHT,
                                         commit))
    if busy_ms is None:
        _log(f"profiler: no device events in a {window_ms:.2f} ms window; "
             f"device busy share not measured")
    else:
        _log(f"profiled_verify_commit window_ms {window_ms:.2f} (host clock, "
             f"under the profiler); device_busy_ms {busy_ms:.4f} "
             f"({n_dev} device events; ed25519_verify_kernel "
             f"{traced_kernel_ms:.4f} ms); device_idle_share "
             f"{1 - busy_ms / window_ms:.4f}")

    _log(f"card: {card}")
    _log(f"kernel_ms_per_10240_bucket {timings[10240]:.4f} "
         f"(median of 5, CUDA events); kernel_ms_per_{tile_lanes}_bucket "
         f"{timings[tile_lanes]:.4f}; kernel_ms_per_1024_bucket "
         f"{timings[1024]:.4f}")
    _log(f"kernel_ms_per_commit {commit_kernel_ms:.4f} ({len(plan)} "
         f"launches of {tile_lanes} lanes, back to back, median of 5); "
         f"bound {commit_bound_ms:.4f} ms")
    _log(f"verify_commit_e2e_ms {statistics.median(e2e):.2f} "
         f"(median of 3: {', '.join(f'{x:.2f}' for x in e2e)}; "
         f"{n} signatures, {tiles_all} tiles)")
    _log(f"verify_batch_ms {statistics.median(vb):.2f} (median of 3: "
         f"prep, copies and kernels of the {n} signatures, no commit "
         f"walk)")
    _log(f"host_prep_ms {statistics.median(prep):.2f} (median of 3, "
         f"{tiles_all} tiles)")
    _log(f"plain_ms_per_10240_bucket {plain_times[10240]:.1f} (one run); "
         f"plain_ms_per_{tile_lanes}_bucket {plain_times[tile_lanes]:.1f}; "
         f"kernel == plain (exact) at {tile_lanes} (main-path tile, "
         f"{hi - lo} real lanes) and 10240 lanes")
    for m, (b_ms, b_by, ops, nbytes) in bounds.items():
        _log(f"bound_ms_{m} {b_ms:.4f} ({b_by}) = max(ops {ops:.4g} / "
             f"{INT32_OPS_PER_S:.4g} int32/s, bytes {nbytes} / "
             f"{HBM_BYTES_PER_S:.3g} B/s); kernel at "
             f"{timings[m] / b_ms:.2f}x its bound")
    _log(f"per lane: {muls} field multiplies x {OPS_PER_FIELD_MUL} + "
         f"{sqrs} squarings x {OPS_PER_FIELD_SQR} int32 ops; "
         f"{IN_BYTES_PER_LANE} B in, {OUT_BYTES_PER_LANE} B out")
    _log(f"B2 kernel_ms_per_{tile_lanes}_bucket {timings8[tile_lanes]:.4f} "
         f"(median of 5, CUDA events; "
         f"{timings8[tile_lanes] / bounds[tile_lanes][0]:.2f}x the "
         f"B1-formula bound {bounds[tile_lanes][0]:.4f} ms); "
         f"kernel_ms_per_10240_bucket {timings8[10240]:.4f} "
         f"({timings8[10240] / bounds[10240][0]:.2f}x "
         f"{bounds[10240][0]:.4f} ms)")
    _log(f"B2 kernel_ms_per_commit {commit8_kernel_ms:.4f} ({len(plan)} "
         f"launches of {tile_lanes} lanes, back to back, median of 5); "
         f"bound {commit_bound_ms:.4f} ms (same work as B1)")
    _log(f"B2 plain_ms_per_{tile_lanes}_bucket {plain8_tile_ms:.1f} (one "
         f"run); B2 kernel == B2 plain (exact) at {tile_lanes}, == B1 "
         f"kernel at 10240")
    _log(f"B2 per lane (context, not the bound): {muls8} field multiplies "
         f"x {OPS_PER_FIELD16_MUL} + {sqrs8} squarings x "
         f"{OPS_PER_FIELD16_SQR} = {own8_ops} int32 ops, against B1's "
         f"{muls * OPS_PER_FIELD_MUL + sqrs * OPS_PER_FIELD_SQR}")

    # -- 6. microbench: the suite, then each kernel vs plain on its input
    mb_ops = _mb_ops_per_lane()
    mb_runs = {}
    for m in (mb.M_DEFAULT, MB_BIG):
        _phase(f"6 microbench suite at {m} lanes")
        for op in mb.REPS:
            mb.launches[op] = 0
        records = mb.run_suite(m=m)
        counts = dict(mb.launches)
        for op, count in counts.items():
            if count == 0:
                raise AssertionError(f"run_suite never launched mb_{op} at "
                                     f"{m} lanes")
        mb_runs[m] = ({r["metric"][3:]: r for r in records}, counts)
    # each kernel on the suite's own input at both sizes and the full
    # REPS, held to its plain version limb for limb (exact: integers)
    _phase(f"6b microbench kernels vs plain at {mb.M_DEFAULT} and {MB_BIG} "
           f"lanes, full REPS")
    mb_err, mb_plain_ms = dict.fromkeys(mb.REPS, 0), {}
    for m in (mb.M_DEFAULT, MB_BIG):
        x_suite = mb.suite_input(m, dev)
        for op, reps in mb.REPS.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            plain = mb.bench_cols_plain(x_suite, op, reps)
            torch.cuda.synchronize()
            mb_plain_ms[(op, m)] = (time.perf_counter() - t0) * 1e3
            got = mb.bench_cols(x_suite, op, reps)
            if not torch.equal(got, plain):
                raise AssertionError(
                    f"microbench {op} kernel != plain on "
                    f"{int((got != plain).any(0).sum())} of {m} lanes")
            mb_err[op] = max(mb_err[op], int(
                (got.long() - plain.long()).abs().max().item()))
            del got, plain
    _log(f"all {len(mb.REPS)} microbench kernels == plain limb for limb "
         f"([10, m] int32 each, m = {mb.M_DEFAULT} and {MB_BIG})")
    _log(f"mb bound per op = max(int32 ops per lane x lanes / "
         f"{INT32_OPS_PER_S:.4g}, lanes x "
         f"{MB_IN_BYTES_PER_LANE + MB_OUT_BYTES_PER_LANE} B / "
         f"{HBM_BYTES_PER_S:.3g} B/s); ops per lane = multiplies x "
         f"{OPS_PER_FIELD_MUL} + squarings x {OPS_PER_FIELD_SQR} + "
         f"carries x {OPS_PER_CARRY} (+ {OPS_PER_SELECT_STEP} per select16 "
         f"step), seed included")
    mb_bounds = {}
    for recs, _ in mb_runs.values():
        for op, rec in recs.items():
            lanes, reps = rec["bucket"], rec["reps"]
            ops, n_mul, n_sqr, n_carry = mb_ops[op]
            b_ms, b_by = _mb_bound(lanes, ops)
            mb_bounds[(op, lanes)] = (b_ms, b_by)
            _log(json.dumps(rec))
            _log(f"{rec['metric']} lanes {lanes} reps {reps}: ms "
                 f"{rec['value_ms']:.4f} per_op_us {rec['per_op_us']:.4f} "
                 f"per_lane_ns {rec['value_ms'] * 1e6 / (reps * lanes):.4f} "
                 f"plain_ms {mb_plain_ms[(op, lanes)]:.1f} "
                 f"bound_ms {b_ms:.4f} ({b_by}; {ops} ops/lane: {n_mul} mul, "
                 f"{n_sqr} sqr, {n_carry} carry) bound_share "
                 f"{b_ms / rec['value_ms']:.4f}")

    # -- 7. kernels line, card line, result line -----------------------------
    # ms, plain_ms and bound_ms are for one launch at the main path's
    # tile; the 10240-lane bucket and the whole commit ride beside them
    b_tile, b_10240 = bounds[tile_lanes], bounds[10240]
    kernels = {"kernels": [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "cometbft_tpu_torch/ops/csrc/ed25519_verify.cu",
        "replaces": "cometbft_tpu/ops/ed25519_pallas.py:379",
        "launches": main_launches,
        "max_abs_err": max_abs_err,
        "lanes": tile_lanes,
        "ms": timings[tile_lanes],
        "plain_ms": plain_times[tile_lanes],
        "bound_ms": b_tile[0],
        "bound_by": b_tile[1],
        "library_ms": None,
        "bucket_10240": {"ms": timings[10240],
                         "plain_ms": plain_times[10240],
                         "bound_ms": b_10240[0], "bound_by": b_10240[1]},
        "per_commit": {"launches": len(plan), "ms": commit_kernel_ms,
                       "bound_ms": commit_bound_ms},
    }, {
        "name": "ed25519_verify8",
        "route": "cuda",
        "source": "cometbft_tpu_torch/ops/csrc/ed25519_verify8.cu",
        "replaces": "cometbft_tpu/ops/ed25519_pallas8.py:247",
        "launches": main8_launches,
        "max_abs_err": max_abs_err8,
        "lanes": tile_lanes,
        "ms": timings8[tile_lanes],
        "plain_ms": plain8_tile_ms,
        "bound_ms": b_tile[0],
        "bound_by": b_tile[1],
        "library_ms": None,
        "bucket_10240": {"ms": timings8[10240], "bound_ms": b_10240[0],
                         "bound_by": b_10240[1]},
        "per_commit": {"launches": len(plan), "ms": commit8_kernel_ms,
                       "bound_ms": commit_bound_ms},
        "own_ops_per_lane": own8_ops,
    }]}
    (by_op, mb_launches), big = mb_runs[mb.M_DEFAULT], mb_runs[MB_BIG][0]
    for op, reps in mb.REPS.items():
        rec = by_op[op]
        b_ms, b_by = mb_bounds[(op, mb.M_DEFAULT)]
        kernels["kernels"].append({
            "name": f"mb_{op}",
            "route": "cuda",
            "source": "cometbft_tpu_torch/ops/csrc/microbench.cu",
            "replaces": "cometbft_tpu/ops/microbench.py:82",
            "launches": mb_launches[op],
            "max_abs_err": mb_err[op],
            "lanes": mb.M_DEFAULT,
            "reps": reps,
            "ms": rec["value_ms"],
            "plain_ms": mb_plain_ms[(op, mb.M_DEFAULT)],
            "bound_ms": b_ms,
            "bound_by": b_by,
            "library_ms": None,
            "per_op_us": rec["per_op_us"],
            f"lanes_{MB_BIG}": {
                "ms": big[op]["value_ms"],
                "plain_ms": mb_plain_ms[(op, MB_BIG)],
                "bound_ms": mb_bounds[(op, MB_BIG)][0],
                "bound_by": mb_bounds[(op, MB_BIG)][1]},
        })
    _log(f"chip_smoke_seconds {time.perf_counter() - t_start:.1f}")
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
