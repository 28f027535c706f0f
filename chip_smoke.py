"""Smoke run of cometbft_tpu_torch on one NVIDIA GPU.

    python3 chip_smoke.py [--seed N]

Builds the CUDA kernels from the sources in this checkout (one library:
ed25519_verify.cu, ed25519_verify8.cu, microbench.cu), the host prep
(ed25519_prep.cpp, g++, a library of its own), the host BLS12-381
library (bls_native.cpp, g++, self-tested at load), the host ed25519
(ed25519_host.cpp, g++, self-tested at load) and the secret connection's
ChaCha20-Poly1305 (chacha20poly1305.cpp, g++, self-tested at load on the
RFC 8439 vector), prints what ptxas says of
the two verifiers and of B3's four point-op kernels, holds the C prep
byte for byte to its plain version (numpy and hashlib) on edge-case
items, block-crossing message lengths and the commit's own entries, and
each verifier against its plain PyTorch version and the golden model on
edge-case lanes (B1 and B2, both four threads a signature, also at lane
counts that leave a partial quad, warp or block), then verifies a
10,000-validator commit through the port's entry points
(types/validation -> crypto/batch -> ops/ed25519's tile pipeline -> the
kernel), once with the default kernel (B1) and once with
COMETBFT_TPU_TORCH_KERNEL=cuda8 (B2), counting each kernel's launches on
that path.  It times verify_commit, verify_batch, the C prep and the
plain prep over 20 warm runs each (p50 and p90), splits the commit's
time into walk, packing, C prep and kernel wait from the port's own
spans, reads the pipeline's overlap ratio, times both kernels and their
plain versions, drives verify_async of the 10k batch under an asyncio
ticker for the longest event-loop stall, traces one verify_commit with
torch.profiler for the device's busy share, and runs the microbenchmark
suite (B3) at 16,384 and 262,144 lanes, holding each of its nine kernels
to its plain version on the suite's own inputs, and its four point ops
(four threads a lane on B1's own rounds) also at lane counts that leave
a partial quad, warp or block; it times the suite again at B1's tile
(4,096 lanes) for the cost of one of B1's rounds.  Phases 8a-8d take
the commit forms beyond ed25519 (BASELINE.json config 5): the BLS
library against its plain Python formulas byte for byte; a
10,000-validator mixed-key commit (secp256k1, bls12_381, ed25519 by
i % 3, i % 7) through verify_commit's grouped path, with B1's launches
on its ed25519 group counted and the time split into the ed25519
group, the BLS group and the inline secp256k1 walk; corrupted mixed
commits at 1,000 validators, each rejected naming the lowest bad index,
and the light and trusting calls; a 10,000-validator aggregate commit
cold and warm, its rejections (sub-quorum, wrong key, a rogue key in
the trusting call's signer set) and a 256-message aggregate_verify.
Phases 9a-9d drive the vote tally (types/vote, types/vote_set,
consensus/height_vote_set, consensus/messages, consensus/state): the
commit's 10,000 precommits as VoteMessage wire bytes in a shuffled
order, decoded into an asyncio.Queue and drained as the JAX package's
receive routine does, in bursts of 256, each pre-verified on B1 and then
tallied serially into a HeightVoteSet, with zero serial misses, 40 B1
launches and the made commit equal to the source and verified again,
traced once for the device's idle share, and one burst under cuda8
leaving the same memo; 1,024 extended precommits (extensions across
SHA-512 block edges and one of 1 MiB) and their restore from the
extended commit with cleared memos; rejections in a 256-message burst
(a corrupted signature, an equivocation, another height, a
VoteBatchMessage) and a burst of config 5's key mix; config 4's shape,
150 validators for 20 heights.
Phases 10a-10d drive the light client (light/verifier, light/store,
light/client over the port's db, every commit check on B1): BASELINE.json
config 3 (1,000 validators, hops from 1 to 11, 21, 31, 41), then a
skipping sync to the tip of a 1,000-height chain whose 1,000 validators
rotate a quarter every 100 heights, with two witnesses, on MemDB and on
SQLiteDB, its stored heights held to the JAX client's algorithm; 20
heights in sequential mode; one hop over the 10,000 keys of phase 3 with
a quarter replaced, under B1 and B2; and the rejections (a corrupted
signature, an expired root, clock drift, a lunatic witness with its
evidence) and backwards verification.  The providers sign a height's
commit on its first fetch, with a fixed-base table signer held byte for
byte to the golden model.
Phases 11a-11d drive the chain below consensus (types/block and its part
sets, params, genesis, the kvstore app over AppConns and its state tree,
the state and block stores, state/execution's BlockExecutor,
consensus/replay's Handshaker), every block's LastCommit verified on B1:
BASELINE.json config 4's 150 validators for 100 heights of 200
load-generator txs of 256 bytes, with validator updates at heights 25,
50 and 75, timed a height with its split (validate_block, FinalizeBlock,
the stores' saves) and traced for the device's busy share; the
Handshaker's replay of the 100 heights into a fresh app, and 20 heights
and their replay on SQLiteDB; a block whose LastCommit holds phase 3's
10,000 precommits, under B1 and under cuda8; and the blocks the executor
must refuse (a corrupted signature, a wrong app hash, a commit one
signature short, a proposer outside the set) and a block store that lost
a height.  Commits are signed with the fixed-base signer in the pool.
Phases 12a-12e drive the consensus state machine (consensus/state.py's
ConsensusState with its round state, ticker, timeouts and supervisor,
every consensus message through the wire codec, the EventBus, the WAL
and catchup_replay, the host ed25519): a full node fed 11a's chain, built
again by a twin executor, as each height's signed proposal, parts, 150
prevotes and 150 precommits in wire bytes, a height after the node's
NewBlock for the last, with the default timeouts, timed a height with its
split (decode, the burst pre-verification on B1, the tally, the WAL,
validate_block, the pipelined apply), the loop's longest stall, WAL bytes,
rounds and timeouts, traced for 20 heights, its stores held byte for byte
to the twin's; a crash at height 101 after its proposal and 80% of its
prevotes, restarts on the same stores under cuda8 and from a repaired
torn copy of the WAL (replayed only) and the real restart, which
catchup-replays to the same round state and commits the twin's block;
BASELINE.json config 1, four validators full-mesh through the wire codec
with the JAX package's test timeouts for 50 heights, their stores equal
and every commit verified; the host ed25519 held byte for byte to the
golden model on 1,000 seeded inputs and the ZIP-215 edge items, its
timings, the serial tally of a VoteBatchMessage; and what the state
machine must refuse (a non-proposer's proposal, a bad-proof part, a
conflicting vote, two WALs catchup_replay refuses) and a stand-in kernel
that raises in the receive routine, which must stop consensus without a
restart.
Phases 13a-13c drive p2p and the consensus reactor (p2p/'s secret
connection on the host AEAD, MConnection with its rate limiters, Switch,
and consensus/reactor.py's ConsensusReactor with its gossip routines):
BASELINE.json config 1 over sockets, four validators on 127.0.0.1 each
with a Switch, a ConsensusReactor and a ConsensusState, dialed full mesh
through the secret connection, the JAX package's test timeouts, 50
heights, timed a height beside 12c's in-process figure, with B1's
launches, serial host verifies, wire bytes by channel, the handshake and
the seal and open of a frame, the four stores equal and every commit
verified on B1; a full node restarted with a Switch and a reactor over
the stores phase 12 leaves (the twin's 150-validator chain) and a fresh
joiner from genesis that dials it and catches up the first 50 of its
100 heights by the reactor's gossip alone, its rows, State.bytes() and app hash held to the
twin's at every height; and the AEAD library against its plain version
on 1,000 seeded inputs, a tampered frame, a low-order X25519 key,
another network and a self-dial refused with the JAX texts, and a
stand-in kernel that raises in one socket node's receive routine, which
must stop that node's consensus without a restart while the other three
go on.
Any failure exits non-zero.  The last three lines are the kernels JSON,
the card's name and power limit, and {"ok": true, "device": {...}}.  Signatures are made
from --seed with the golden model in a pool of worker processes.
"""
from __future__ import annotations

import argparse
import asyncio
import collections
import contextlib
import hashlib
import json
import logging
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
# B1's main-path tile: 4,096 signatures, 512 warps, about one a scheduler
MB_TILE = 4096
# B1 and B2 run four threads a signature: these lane counts leave a
# partial quad, warp or block
PARTIAL_LANES = (1, 3, 4, 5, 31, 33, 64, 1023)
# warm runs of each timed call in phase 4
WARM_RUNS = 20
# message lengths around SHA-512 block edges of R || A || msg (64 + len
# bytes), and one over 128 blocks (the C prep's scalar path)
EDGE_MSG_LENS = (0, 47, 48, 111, 112, 175, 176, 17 * 1024)
# B3's point ops run a quad a lane, 16 lanes a block: these lane counts
# leave a partial quad, warp or block; MB_PARTIAL_REPS steps each
MB_PARTIAL_LANES = (1, 3, 5, 17, 33, 1023)
MB_PARTIAL_REPS = 3
# rounds of B1's four-thread schedule in one step of each point op: a
# doubling or an add is 2, a window 4 doublings and 2 adds
MB_ROUNDS = {"double": 2, "add": 2, "madd": 2, "window": 12}
# The bound PR 3 held the microbench kernels to, printed beside the
# bound for continuity: (multiplies, squarings, carries) a lane of every
# product and carry the JAX kernel's single-point chain computes, the seed
# (x, y = 2x, x·y) included.  A doubling is 4 squarings and 4 multiplies
# (_ext_double, T on every step), an add 9 multiplies (_ext_add, T1·T2
# then ·2d), a mixed add 7 (_madd_affine), a window 4 doublings (T on the
# last only), a mixed add and an add; the field ops are their REPS.
MB_YARDSTICK_WORK = {
    "noop": (1, 0, 2), "carry": (1, 0, 2 + 4096), "mul": (1 + 1024, 0, 2),
    "sqr": (1, 1024, 2), "double": (1 + 128 * 4, 128 * 4, 2),
    "add": (1 + 128 * 9, 0, 2), "madd": (1 + 128 * 7, 0, 2),
    "select16": (1, 0, 3), "window": (1 + 16 * 29, 16 * 16, 2)}


# phase 8: BASELINE.json config 5 ("stress: 10k-validator Commit +
# bls12381 aggregate-sig path, mixed key types"), sized as the JAX
# package's cometbft_tpu/tools/benchmarks.py:179-220 does at --full
MIXED_VALIDATORS = 10_000
# phase 8c's corrupted commits: the same mix at a tenth of the size
MIXED_SMALL = 1_000
AGG_VALIDATORS = 10_000
AGG_MESSAGES = 256
# a known RIPEMD-160 digest (of b"abc"): secp256k1 addresses need it
RIPEMD160_ABC = "8eb208f7e05d987a9b044a8e98c6b087f15a0bfc"

# phase 9: the vote tally.  The receive routine drains bursts of at most
# 256 queued messages (the JAX package's consensus/state.py:297)
BURST_MAX = 256
# 9b: extended votes, each non-nil precommit with an extension and a
# non-RP extension of a few dozen bytes; validator 0's extension is the
# 1 MiB cap (types/vote.MAX_VOTE_EXTENSION_SIZE)
EXT_VALIDATORS = 1024
# 9c: a 256-message burst with one corrupted signature, one
# equivocation, one vote of another height and one VoteBatchMessage
REJECT_GOOD = 253
REJECT_BATCH = 4
# 9d: BASELINE.json config 4's shape ("consensus replay: 150-validator
# WAL, VoteSet tally + Commit verify per height") without the WAL
REPLAY_VALIDATORS = 150
REPLAY_HEIGHTS = 20

# phase 10: the light client.  10a is BASELINE.json config 3
# ("light-client verifier: 1k-validator SignedHeader chain, skipping
# verification") at the JAX package's --full size
# (cometbft_tpu/tools/benchmarks.py:91-128): one set, a root at height
# 1, hops to 11, 21, 31, 41.  Then a real sync over a rotating chain:
# 1,000 heights 1 s apart, the 250 oldest of 1,000 validators replaced
# every 100 heights, a 168 h trusting period (the JAX config default)
# and a 10 s clock drift.
LIGHT_CHAIN_ID = "light-chip"
LIGHT_VALIDATORS = 1_000
LIGHT_HEIGHTS = 1_000
LIGHT_EVERY = 100
LIGHT_ROTATE = 250
LIGHT_POWER = 10
LIGHT_T0 = 1_700_000_000
LIGHT_TRUSTING_PERIOD_NS = 168 * 3600 * 10**9
LIGHT_DRIFT_NS = 10 * 10**9
CONFIG3_HOPS = (11, 21, 31, 41)
CONFIG3_PERIOD_NS = 365 * 24 * 3600 * 10**9
CONFIG3_DRIFT_NS = 10**9
# warm syncs timed after the first (which signs what it fetches)
LIGHT_SYNC_RUNS = 3
# 10b: sequential mode over 20 adjacent heights across the rotation at 101
LIGHT_SEQ_ROOT = 90
LIGHT_SEQ_TARGET = 110
# 10c: one hop over commit-10k's keys with a quarter of them replaced
HOP10K_REPLACE_EVERY = 4
# 10d: a lunatic fork signed by 700 of the common set; backwards
# verification 50 heights below a root at 151
FORK_HEIGHT = 41
FORK_SIGNERS = 700
BACKWARDS_ROOT = 151
BACKWARDS_DEPTH = 50


# phase 11: the chain below consensus.  11a is BASELINE.json config 4's
# set (150 validators) driven through the block executor for 100 heights,
# each block carrying 200 txs of the load generator's 256-byte form
EXEC_CHAIN_ID = "exec-chip"
EXEC_T0 = 1_700_000_000
EXEC_VALIDATORS = 150
EXEC_HEIGHTS = 100
EXEC_TXS = 200
EXEC_TX_BYTES = 256
EXEC_POWER = 10
# the heights whose block carries a val= tx: add, re-power, add
EXEC_UPDATES = (25, 50, 75)
# the last heights of 11a run under torch.profiler for the busy share
EXEC_PROFILED = 20
# 11b repeats the first heights on SQLiteDB stores
EXEC_SQLITE_HEIGHTS = 20
# 11d: the corrupted signature and the height the block store loses
EXEC_BAD_SIG = 7
EXEC_MISSING = 3

# phase 12: the consensus state machine.  12a and 12b feed a full node
# 11a's chain (config 4: EXEC_VALIDATORS validators, EXEC_TXS txs a
# height) from a twin executor; 12c is config 1 (4 validators)
CS_HEIGHTS = 100          # 12a's heights; 12b crashes at CS_HEIGHTS + 1
CS_CRASH_SHARE = 0.8      # 12b: the share of prevotes sent before the crash
CS_TRACED = 20            # 12a's heights under torch.profiler
CS_PEER = "twin"          # the peer id the harness's messages carry
NET_VALIDATORS = 4        # 12c
NET_HEIGHTS = 50
HOST_INPUTS = 1000        # 12d: seeded keys, signatures and verdicts
HOST_TIMED = 200          # 12d: timed sign and verify calls
# phase 13: p2p and the consensus reactor.  13a is BASELINE.json config 1
# over sockets; 13b catches a joiner up on phase 12's 150-validator chain
SOCK_VALIDATORS = 4       # 13a
SOCK_HEIGHTS = 50
# 13b: the joiner's depth, cut from the chain's 100 heights to keep phase 13
# inside its 60 s budget (at 100, phase 13 took 58-85 s on an NVIDIA H100
# 80GB HBM3 at 700 W, with the spread of the card's host)
CATCHUP_HEIGHTS = 50
AEAD_INPUTS = 1000        # 13c: seeded (key, nonce, aad, message) inputs
AEAD_LENS = (0, 3, 1023, 1024, 1028)   # 13c: message lengths among them


def _mixed_kind(i: int) -> str:
    """Config 5's key type of validator i (benchmarks.py:190-197)."""
    if i % 3 == 0:
        return "secp256k1"
    if i % 7 == 0:
        return "bls12_381"
    return "ed25519"


def _mixed_sign_job(job):
    """Worker: (key type, seed, msg) -> (pub, sig) with the port's keys
    (the BLS library is built by then; a worker loads it)."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto import bls12381, secp256k1
    kind, seed, msg = job
    if kind == "ed25519":
        return ref.public_key(seed), ref.sign(seed, msg)
    mod = secp256k1 if kind == "secp256k1" else bls12381
    priv = mod.gen_priv_key_from_secret(seed)
    return priv.pub_key().bytes(), priv.sign(msg)


def _bls_key_job(seed):
    """Worker: seed -> (BLS pubkey bytes, secret scalar)."""
    from cometbft_tpu_torch.crypto import bls12381
    priv = bls12381.gen_priv_key_from_secret(seed)
    return priv.pub_key().bytes(), int.from_bytes(priv.bytes(), "big")


def _sign_job(job):
    """Worker: (seed, msg) -> (pub, sig) with the golden model."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    seed, msg = job
    return ref.public_key(seed), ref.sign(seed, msg)


def _seed(base: int, i: int) -> bytes:
    return hashlib.sha256(b"chip-smoke/%d/%d" % (base, i)).digest()


def _log(*a):
    print(*a, flush=True)


def _pct(xs, q):
    """The q-quantile of xs by the nearest rank."""
    xs = sorted(xs)
    return xs[min(len(xs) - 1, max(0, round(q * len(xs)) - 1))]


def _p50_p90(xs):
    return f"p50 {_pct(xs, 0.5):.3f} p90 {_pct(xs, 0.9):.3f}"


def _same_prep(oe, items, m, what):
    """The C prep must equal the plain prep byte for byte."""
    import numpy as np
    got, want = oe.prep_arrays(items, m), oe.prep_arrays_plain(items, m)
    for name, x, y in zip(("a_b", "r_b", "s_w8", "k_w8", "pre_bad"), got,
                          want):
        if x.dtype != y.dtype or x.shape != y.shape or \
                not np.array_equal(x, y):
            raise AssertionError(f"C prep != plain prep ({name}) on {what}")


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


class _Sym:
    """A value of a symbolic run of the microbench chain: the operation
    that made it ("mul", "sqr", "carry"; None for a sum or an input) and
    its operands."""

    def __init__(self, kind=None, *args):
        self.kind, self.args = kind, args

    def __add__(self, other):
        return _Sym(None, self, other)

    __sub__ = __add__

    def __neg__(self):
        return _Sym(None, self)


def _mb_work_per_lane():
    """{op: (int32 ops, multiplies, squarings, carries)} one lane of each
    microbench op needs at its REPS: the plain chain (microbench._chain,
    seed included) run once on symbolic values, counting only the
    products and carries its output reads.  So a doubling's T3, the seed's
    x·y in a doubling chain, madd's 2d·T1 and the last step's Y, Z and T
    are computed by the kernel but are not work the function needs.
    field.mul carries inside its count; a select16 step adds one 10-limb
    entry into int64 sums."""
    from unittest import mock
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import field
    from cometbft_tpu_torch.ops import microbench as mb

    def made_by(kind):
        return lambda *args: _Sym(kind, *args)

    mul, sqr = made_by("mul"), made_by("sqr")
    leaf = _Sym()
    out = {}
    with mock.patch.object(field, "mul", mul), \
            mock.patch.object(field, "sqr", sqr), \
            mock.patch.object(field, "carry", made_by("carry")), \
            mock.patch.object(ek, "_products",
                              lambda lhs, rhs: tuple(map(mul, lhs, rhs))), \
            mock.patch.object(ek, "_squares",
                              lambda xs: tuple(map(sqr, xs))):
        for op, reps in mb.REPS.items():
            res = mb._chain(op, leaf, reps, leaf, leaf,
                            lambda j: (leaf, leaf, leaf), lambda j: leaf)
            seen, todo, kinds = set(), [res], collections.Counter()
            while todo:
                v = todo.pop()
                if id(v) not in seen:
                    seen.add(id(v))
                    kinds[v.kind] += 1
                    todo.extend(v.args)
            muls, sqrs, carries = kinds["mul"], kinds["sqr"], kinds["carry"]
            out[op] = (_mb_ops(muls, sqrs, carries, op, reps),
                       muls, sqrs, carries)
    return out


def _mb_ops(muls, sqrs, carries, op, reps):
    """int32 operations of a microbench lane's field work."""
    return (muls * OPS_PER_FIELD_MUL + sqrs * OPS_PER_FIELD_SQR +
            carries * OPS_PER_CARRY +
            (reps * OPS_PER_SELECT_STEP if op == "select16" else 0))


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


def _ptxas_summary(report, kernel):
    """{registers, stack, spill_stores, spill_loads, smem} of one entry
    function in nvcc -Xptxas -v output (mangled names hold the name
    followed by E)."""
    import re
    out, mine = {}, False
    for line in report.splitlines():
        if "Compiling entry function" in line or "Function properties" in line:
            mine = f"{kernel}E" in line
        elif mine and "stack frame" in line:
            nums = [int(x) for x in re.findall(r"(\d+) bytes", line)]
            out.update(stack=nums[0], spill_stores=nums[1],
                       spill_loads=nums[2])
        elif mine and "Used" in line and "registers" in line:
            out["registers"] = int(re.search(r"Used (\d+) registers",
                                             line).group(1))
            smem = re.search(r"(\d+) bytes smem", line)
            out["smem"] = int(smem.group(1)) if smem else 0
    return out


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


def _mixed_commit(kinds, signed, stamps, block_id):
    """The port's ValidatorSet (equal power, the consensus order) and a
    fully signed precommit commit from per-key (pub, sig) pairs."""
    from cometbft_tpu_torch.crypto.encoding import pub_key_from_type_and_bytes
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    from cometbft_tpu_torch.types.vote import BLOCK_ID_FLAG_COMMIT
    keys = [pub_key_from_type_and_bytes(kind, pub)
            for kind, (pub, _) in zip(kinds, signed)]
    vals = ValidatorSet([Validator.new(pk, 10) for pk in keys])
    slot = {pk.address(): j for j, pk in enumerate(keys)}
    sigs = []
    for v in vals.validators:
        j = slot[v.address]
        sigs.append(CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, stamps[j],
                              signed[j][1]))
    return vals, Commit(height=HEIGHT, round=0, block_id=block_id,
                        signatures=sigs)


def _corrupted(commit, idxs):
    """A copy of commit with bit 0 of each named slot's signature
    flipped."""
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    sigs = list(commit.signatures)
    for i in idxs:
        cs = sigs[i]
        sigs[i] = CommitSig(cs.block_id_flag, cs.validator_address,
                            cs.timestamp,
                            bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
    return Commit(height=commit.height, round=commit.round,
                  block_id=commit.block_id, signatures=sigs)


def _expect_rejection(fn, exc_type, text=None):
    """fn must raise exactly exc_type (with the text, when given);
    returns the message."""
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — checked below
        if type(e) is not exc_type or (text is not None and str(e) != text):
            raise AssertionError(f"expected {exc_type.__name__} "
                                 f"{text!r}, got {type(e).__name__}: "
                                 f"{e}") from e
        return str(e)
    raise AssertionError(f"expected {exc_type.__name__}, got acceptance")


def _bls_library_vs_plain(seed):
    """Phase 8a: the host BLS library against the plain formulas
    (crypto/_bls12381_math.py) on seeded inputs, byte for byte; returns
    the number of comparisons."""
    from cometbft_tpu_torch.crypto import _bls12381_math as m
    from cometbft_tpu_torch.crypto.bls12381 import DST
    from cometbft_tpu_torch.ops import bls_native as nat

    def scalar(tag):
        return int.from_bytes(hashlib.sha256(b"%d/%s" % (seed, tag))
                              .digest(), "big") % m.R_ORDER

    def outcome(fn, *args):
        try:
            return fn(*args)
        except ValueError:
            return "ValueError"

    checks = []

    def same(what, got, want):
        checks.append(what)
        if got != want:
            raise AssertionError(f"BLS library != plain formulas: {what}")

    for msg in (b"", b"chip-smoke %d" % seed):
        same(f"hash_to_g2({msg!r})", nat.hash_to_g2(msg, DST),
             m._g2_raw(m.hash_to_g2(msg, DST)))
    g1 = m.pt_mul(m.G1_OPS, m.G1_GEN, scalar(b"g1"))
    g2 = m.pt_mul(m.G2_OPS, m.G2_GEN, scalar(b"g2"))
    x = 4 + seed % 1000                      # off-curve and off-subgroup
    while m._sqrt_fq((x ** 3 + 4) % m.P) is not None:
        x += 1
    off_g1 = bytearray(x.to_bytes(48, "big"))
    off_g1[0] |= 0x80
    x += 1
    while m._sqrt_fq((x ** 3 + 4) % m.P) is None:
        x += 1
    non_sub_g1 = (x, m._sqrt_fq((x ** 3 + 4) % m.P))
    x2 = (x, 1)
    while m._sqrt_fq2(m.f2_add(m.f2_mul(m.f2_sqr(x2), x2), m.G2_B)) is None:
        x2 = (x2[0] + 1, 1)
    non_sub_g2 = (x2, m._sqrt_fq2(m.f2_add(m.f2_mul(m.f2_sqr(x2), x2),
                                           m.G2_B)))
    x2 = (x2[0] + 1, 1)
    while m._sqrt_fq2(m.f2_add(m.f2_mul(m.f2_sqr(x2), x2), m.G2_B)):
        x2 = (x2[0] + 1, 1)
    off_g2 = bytearray(x2[1].to_bytes(48, "big") + x2[0].to_bytes(48, "big"))
    off_g2[0] |= 0x80
    for name, data in (("valid", m.g1_compress(g1)),
                       ("non-subgroup", m.g1_compress(non_sub_g1)),
                       ("off-curve", bytes(off_g1))):
        got = outcome(nat.g1_uncompress, data)
        want = outcome(m.g1_uncompress, data)
        same(f"G1 uncompress {name}", got if isinstance(got, str)
             else m._g1_unraw(got), want)
    for name, data in (("valid", m.g2_compress(g2)),
                       ("non-subgroup", m.g2_compress(non_sub_g2)),
                       ("off-curve", bytes(off_g2))):
        got = outcome(nat.g2_uncompress, data)
        want = outcome(m.g2_uncompress, data)
        same(f"G2 uncompress {name}", got if isinstance(got, str)
             else m._g2_unraw(got), want)
    for name, pt in (("valid", g1), ("non-subgroup", non_sub_g1)):
        same(f"G1 subgroup {name}", nat.g1_in_subgroup(m._g1_raw(pt)),
             m.g1_in_subgroup(pt))
    for name, pt in (("valid", g2), ("non-subgroup", non_sub_g2)):
        same(f"G2 subgroup {name}", nat.g2_in_subgroup(m._g2_raw(pt)),
             m.g2_in_subgroup(pt))
    h = m.hash_to_g2(b"pairs %d" % seed, DST)
    a, b = scalar(b"a"), scalar(b"b")
    pa = m.pt_mul(m.G1_OPS, m.G1_GEN, a)
    pb = m.pt_mul(m.G1_OPS, m.G1_GEN, b)
    pab = m.pt_neg(m.G1_OPS, m.pt_mul(m.G1_OPS, m.G1_GEN, (a + b) % m.R_ORDER))
    for name, pairs in (("true", [(pa, h), (pb, h), (pab, h)]),
                        ("false", [(pa, h), (pa, h), (pab, h)])):
        got = nat.pairings_product_is_one(
            [(m._g1_raw(p), m._g2_raw(q)) for p, q in pairs])
        same(f"3-pair product ({name})", got,
             m.pairings_product_is_one(pairs))
        if got != (name == "true"):
            raise AssertionError(f"3-pair product ({name}) gave {got}")
    k = scalar(b"k")
    same("G1 sum", nat.g1_sum(b"".join(m._g1_raw(p) for p in (g1, pa, pb,
                                                              non_sub_g1))),
         m._g1_raw(m.pt_sum(m.G1_OPS, [g1, pa, pb, non_sub_g1])))
    same("G2 sum", nat.g2_sum(m._g2_raw(g2) + m._g2_raw(h) +
                              m._g2_raw(non_sub_g2)),
         m._g2_raw(m.pt_sum(m.G2_OPS, [g2, h, non_sub_g2])))
    same("G1 mul", nat.g1_mul(m._g1_raw(non_sub_g1), k),
         m._g1_raw(m.pt_mul(m.G1_OPS, non_sub_g1, k)))
    same("G2 mul", nat.g2_mul(m._g2_raw(g2), k),
         m._g2_raw(m.pt_mul(m.G2_OPS, g2, k)))
    return len(checks)


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


async def _loop_stalls(bv):
    """(ok, longest tick gap with verify() run on the loop, with
    verify_async() awaited, the awaited call's ms) under a 1 ms ticker;
    the verdicts of both calls must agree."""
    stop = asyncio.Event()
    gap = [0.0]

    async def ticker():
        last = time.perf_counter()
        while not stop.is_set():
            await asyncio.sleep(0.001)
            now = time.perf_counter()
            gap[0] = max(gap[0], now - last)
            last = now

    task = asyncio.ensure_future(ticker())
    await asyncio.sleep(0.05)
    gap[0] = 0.0
    await asyncio.sleep(0.002)
    sync = bv.verify()
    await asyncio.sleep(0.005)
    sync_gap = gap[0]
    await bv.verify_async()                   # warm the worker
    await asyncio.sleep(0.02)
    gap[0] = 0.0
    t0 = time.perf_counter()
    out = await asyncio.wait_for(bv.verify_async(), timeout=60)
    async_ms = (time.perf_counter() - t0) * 1e3
    await asyncio.sleep(0.005)
    async_gap = gap[0]
    stop.set()
    await task
    if tuple(out) != tuple(sync) and (out[0], list(out[1])) != \
            (sync[0], list(sync[1])):
        raise AssertionError("verify_async != verify")
    return out[0], sync_gap * 1e3, async_gap * 1e3, async_ms


def _config5_data(seed, make, stamps):
    """Phase 8's keys and signatures, made in a pool of worker processes
    that is closed before anything is timed: {size: (key types, [(pub,
    sig)])} for the two mixed commits, and (pub, secret) pairs of the
    aggregate's keys and of the 256-message aggregate's."""
    t0 = time.perf_counter()
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(os.cpu_count() or 4) as pool:
        mixed = {}
        for size, base in ((MIXED_VALIDATORS, 8), (MIXED_SMALL, 9)):
            kinds = [_mixed_kind(j) for j in range(size)]
            mixed[size] = (kinds, pool.map(_mixed_sign_job, [
                (kinds[j], _seed(seed + base, j), make(stamps[j]))
                for j in range(size)], chunksize=32))
        agg_keys = pool.map(_bls_key_job, [
            _seed(seed + 10, j) for j in range(AGG_VALIDATORS)], chunksize=64)
        msg_keys = pool.map(_bls_key_job, [
            _seed(seed + 11, j) for j in range(AGG_MESSAGES)])
    _log(f"phase 8 data: {MIXED_VALIDATORS} + {MIXED_SMALL} mixed-key votes "
         f"signed and {AGG_VALIDATORS} + {AGG_MESSAGES} BLS keys made in "
         f"{time.perf_counter() - t0:.1f} s")
    return mixed, agg_keys, msg_keys


def _config5_phases(seed, card, make, stamps, block_id):
    """Phases 8a-8d: the BLS library against its plain version, config 5's
    mixed-key commit (the grouped path, B1 on its ed25519 group),
    corrupted mixed commits, and the aggregate commit.  Returns B1's and
    B2's launches on the grouped commit, 8c's 1,000-validator mixed set
    and commit (phase 9c drains a burst of their votes), and 8d's BLS
    set with its secrets by address (phase 10c's aggregate hop)."""
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.libs.bits import BitArray
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.commit import AggregateCommit
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.signature_cache import SignatureCache
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet

    # -- 8a. the host BLS library against the plain formulas --------------
    _phase("8a BLS library vs plain formulas, on the card's host")
    t0 = time.perf_counter()
    n_checks = _bls_library_vs_plain(seed)
    _log(f"BLS library == plain formulas byte for byte on {n_checks} "
         f"checks (hash_to_g2, G1/G2 uncompress of valid, off-curve and "
         f"non-subgroup points, subgroup checks, 3-pair products true and "
         f"false, sums, muls) in {time.perf_counter() - t0:.1f} s")

    # -- 8b. config 5: a 10,000-validator mixed-key commit ---------------
    mixed, agg_keys, msg_keys = _config5_data(seed, make, stamps)
    nm = MIXED_VALIDATORS
    _phase(f"8b config 5: {nm}-validator mixed-key commit (grouped path)")
    kinds, signed_m = mixed[nm]
    t0 = time.perf_counter()
    mvals, mcommit = _mixed_commit(kinds, signed_m, stamps, block_id)
    by_kind = collections.Counter(v.pub_key.type() for v in mvals.validators)
    _log(f"set built in {time.perf_counter() - t0:.1f} s: "
         f"{dict(sorted(by_kind.items()))}; same type: "
         f"{mvals.all_keys_have_same_type()}")
    n_ed, n_bls = by_kind["ed25519"], by_kind["bls12_381"]
    tiles_grouped = len(tile_plan(n_ed, DEFAULT_TILE))
    bls_hist = crypto_batch.verify_seconds_histogram().with_labels(
        "bls_native", str(oe._bucket(n_bls)))
    grouped_hist = validation.commit_verify_histogram().with_labels("grouped")
    bls_sum0, g_sum0, g_n0 = bls_hist.sum, grouped_hist.sum, grouped_hist.count
    tracing.clear()
    ek.launches = ek8.launches = 0
    t0 = time.perf_counter()
    validation.verify_commit(CHAIN_ID, mvals, block_id, HEIGHT, mcommit)
    mixed_ms = (time.perf_counter() - t0) * 1e3
    grouped_launches, grouped_b2 = ek.launches, ek8.launches
    if (grouped_launches, grouped_b2) != (tiles_grouped, 0):
        raise AssertionError(
            f"the grouped commit launched B1 {grouped_launches} and B2 "
            f"{grouped_b2} times, expected {tiles_grouped} and 0")
    spans = collections.defaultdict(float)
    for ev in tracing.snapshot(category=tracing.CRYPTO):
        if ev["name"] == "batch_verify":
            spans[ev["attrs"]["backend"]] += ev["dur_ns"] / 1e6
    # two batches: the ed25519 group (backend: the device type) and BLS
    ed_backend = "".join(set(spans) - {"bls_native"})
    if len(spans) != 2 or "bls_native" not in spans:
        raise AssertionError(f"batch_verify spans: {dict(spans)}")
    if grouped_hist.count != g_n0 + 1:
        raise AssertionError("the mixed commit was not observed as grouped")
    walk_ms = mixed_ms - spans[ed_backend] - spans["bls_native"]
    _log(f"card: {card}")
    _log(f"config5_verify_commit_ms {mixed_ms:.1f} (one call, host clock; "
         f"{nm} signatures: {n_ed} ed25519 on B1 in {grouped_launches} "
         f"launches ({tiles_grouped} tiles), {n_bls} bls12_381 on the host "
         f"library, {by_kind['secp256k1']} secp256k1 inline)")
    _log(f"config5 split (ms): ed25519 group batch_verify span "
         f"{spans[ed_backend]:.2f} (backend {ed_backend}); BLS group batch_verify span "
         f"{spans['bls_native']:.2f} (crypto_batch_verify_seconds"
         f"{{backend=\"bls_native\"}} +{(bls_hist.sum - bls_sum0) * 1e3:.2f}"
         f" ms); rest of the walk (the inline secp256k1 checks) "
         f"{walk_ms:.1f}; consensus_commit_verify_seconds{{kind=\"grouped\"}}"
         f" +{(grouped_hist.sum - g_sum0) * 1e3:.1f} ms")

    window_ms, busy_ms, traced_kernel_ms, n_dev = _device_busy(
        lambda: validation.verify_commit(CHAIN_ID, mvals, block_id, HEIGHT,
                                         mcommit))
    if busy_ms is None:
        _log(f"profiler: no device events in a {window_ms:.0f} ms window; "
             f"device busy share of config 5 not measured")
    else:
        _log(f"config5 profiled verify_commit window_ms {window_ms:.1f} "
             f"(host clock, under the profiler); device_busy_ms "
             f"{busy_ms:.4f} ({n_dev} device events; ed25519_verify_kernel "
             f"{traced_kernel_ms:.4f} ms); device_idle_share "
             f"{1 - busy_ms / window_ms:.6f}")

    # -- 8c. corrupted mixed commits at 1,000 validators -------------------
    ns = MIXED_SMALL
    _phase(f"8c corrupted mixed-key commits, {ns} validators")
    svals, scommit = _mixed_commit(*mixed[ns], stamps, block_id)
    stypes = [v.pub_key.type() for v in svals.validators]

    def first(kind, start=0):
        return next(i for i in range(start, ns) if stypes[i] == kind)

    t0 = time.perf_counter()
    validation.verify_commit(CHAIN_ID, svals, block_id, HEIGHT, scommit)
    _log(f"honest verify_commit ok in {(time.perf_counter() - t0) * 1e3:.1f}"
         f" ms")
    ed_i, bls_i, secp_i = (first(k, ns // 2) for k in
                           ("ed25519", "bls12_381", "secp256k1"))
    inline_late = first("secp256k1", first("ed25519", ns // 4) + 1)
    deferred_late = first("bls12_381", first("secp256k1", ns // 4) + 1)
    cases = [("ed25519", (ed_i,)), ("bls12_381", (bls_i,)),
             ("secp256k1", (secp_i,)),
             ("deferred ed25519 below inline secp256k1",
              (first("ed25519", ns // 4), inline_late)),
             ("inline secp256k1 below deferred bls12_381",
              (first("secp256k1", ns // 4), deferred_late))]
    for what, idxs in cases:
        bad = _corrupted(scommit, idxs)
        want = min(idxs)
        t0 = time.perf_counter()
        _expect_rejection(
            lambda: validation.verify_commit(CHAIN_ID, svals, block_id,
                                             HEIGHT, bad),
            validation.VerificationError,
            f"wrong signature (#{want}): "
            f"{bad.signatures[want].signature.hex().upper()}")
        _log(f"corrupted {what} at {list(idxs)} rejected naming #{want} "
             f"in {(time.perf_counter() - t0) * 1e3:.1f} ms")
    t0 = time.perf_counter()
    validation.verify_commit_light(CHAIN_ID, svals, block_id, HEIGHT,
                                   scommit)
    light_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    validation.verify_commit_light_trusting(
        CHAIN_ID, svals, scommit, validation.Fraction(1, 3))
    trusting_ms = (time.perf_counter() - t0) * 1e3
    _log(f"verify_commit_light ok in {light_ms:.1f} ms; "
         f"verify_commit_light_trusting (1/3) ok in {trusting_ms:.1f} ms")

    # -- 8d. aggregate commit at 10,000 BLS validators ----------------------
    na = AGG_VALIDATORS
    _phase(f"8d aggregate commit, {na} BLS validators")
    t0 = time.perf_counter()
    apubs = [bls12381.Bls12381PubKey(pub) for pub, _ in agg_keys]
    avals = ValidatorSet([Validator.new(pk, 10) for pk in apubs])
    secret = {pk.address(): sk for pk, (_, sk) in zip(apubs, agg_keys)}
    abid = BlockID(hashlib.sha256(b"agg-block").digest(),
                   PartSetHeader(1, hashlib.sha256(b"agg-p").digest()))

    def aggregate_commit(signers, extra=0):
        """One signature over the zero-timestamp precommit by the sum of
        the signers' secrets, (sum sk_i)·H(m): the bytes of the sum of
        their signatures."""
        agg = AggregateCommit(height=HEIGHT, round=0, block_id=abid,
                              signers=BitArray.from_indices(na, signers))
        total = (sum(secret[avals.validators[i].address] for i in signers)
                 + extra) % bls12381.R_ORDER
        agg.signature = bls12381.Bls12381PrivKey(
            total.to_bytes(32, "big")).sign(agg.vote_sign_bytes(CHAIN_ID))
        return agg

    acommit = aggregate_commit(range(na))
    few = [bls12381.Bls12381PrivKey(sk.to_bytes(32, "big"))
           for _, sk in agg_keys[:8]]
    sb = acommit.vote_sign_bytes(CHAIN_ID)
    few_sum = sum(int.from_bytes(p.bytes(), "big") for p in few) % \
        bls12381.R_ORDER
    if bls12381.aggregate_signatures([p.sign(sb) for p in few]) != \
            bls12381.Bls12381PrivKey(few_sum.to_bytes(32, "big")).sign(sb):
        raise AssertionError("(sum sk)·H(m) != the sum of 8 signatures")
    _log(f"{na} keys checked and set built in "
         f"{time.perf_counter() - t0:.1f} s; (sum sk)·H(m) == the sum of "
         f"8 signatures")
    validation.reset_aggregate_caches()
    cache = SignatureCache()
    ek.launches = 0
    t0 = time.perf_counter()
    validation.verify_commit(CHAIN_ID, avals, abid, HEIGHT, acommit,
                             cache=cache)
    agg_cold_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    validation.verify_commit(CHAIN_ID, avals, abid, HEIGHT, acommit,
                             cache=cache)
    agg_memo_ms = (time.perf_counter() - t0) * 1e3
    agg_warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        validation.verify_commit(CHAIN_ID, avals, abid, HEIGHT, acommit)
        agg_warm.append((time.perf_counter() - t0) * 1e3)
    if ek.launches:
        raise AssertionError("the aggregate path launched B1")
    validation.verify_commit_light(CHAIN_ID, avals, abid, HEIGHT, acommit)
    validation.verify_commit_light_trusting(
        CHAIN_ID, avals, acommit, validation.Fraction(1, 3),
        signer_vals=avals)
    _log(f"aggregate verify_commit cold {agg_cold_ms:.2f} ms (set hash, "
         f"key sum, pairing); warm with the verdict memo "
         f"{agg_memo_ms:.3f} ms; warm without it (key-sum cache hit, "
         f"pairing) median {statistics.median(agg_warm):.2f} ms of 5; "
         f"verify_commit_light and verify_commit_light_trusting "
         f"(signer_vals) ok")
    quorum = na * 2 // 3
    msg = _expect_rejection(
        lambda: validation.verify_commit(
            CHAIN_ID, avals, abid, HEIGHT, aggregate_commit(range(quorum))),
        validation.NotEnoughVotingPowerError)
    _log(f"sub-quorum bitmap ({quorum} of {na}) rejected: {msg}")
    msg = _expect_rejection(
        lambda: validation.verify_commit(
            CHAIN_ID, avals, abid, HEIGHT, aggregate_commit(range(na), 1)),
        validation.VerificationError)
    _log(f"wrong-key aggregate rejected: {msg[:40]}...")
    rogue = bls12381.gen_priv_key_from_secret(b"rogue %d" % seed)
    swapped = [v.copy() for v in avals.validators]
    swapped[na // 2] = Validator.new(rogue.pub_key(), 10)
    rogue_signers = ValidatorSet(swapped)
    msg = _expect_rejection(
        lambda: validation.verify_commit_light_trusting(
            CHAIN_ID, avals, acommit, validation.Fraction(1, 3),
            signer_vals=rogue_signers),
        validation.NotEnoughVotingPowerError)
    _log(f"rogue key in signer_vals rejected by the trusting path: {msg}")

    # config 5's second half: one aggregate over distinct messages
    mprivs = [bls12381.Bls12381PrivKey(sk.to_bytes(32, "big"))
              for _, sk in msg_keys]
    mpubs = [bls12381.Bls12381PubKey(pub) for pub, _ in msg_keys]
    msgs = [b"block-%d" % i for i in range(AGG_MESSAGES)]
    magg = bls12381.aggregate_signatures(
        [p.sign(mm) for p, mm in zip(mprivs, msgs)])
    agg_verify_ms = []
    for _ in range(3):
        t0 = time.perf_counter()
        ok = bls12381.aggregate_verify(mpubs, msgs, magg)
        agg_verify_ms.append((time.perf_counter() - t0) * 1e3)
        if not ok:
            raise AssertionError("aggregate_verify rejected an honest "
                                 "aggregate")
    if bls12381.aggregate_verify(mpubs, msgs[:-1] + [b"other"], magg):
        raise AssertionError("aggregate_verify accepted a wrong message")
    _log(f"aggregate_verify of {AGG_MESSAGES} distinct messages "
         f"{statistics.median(agg_verify_ms):.1f} ms (median of 3; "
         f"{AGG_MESSAGES} hashes to G2, {AGG_MESSAGES + 1} Miller loops, "
         f"one final exponentiation); a wrong message rejected")
    _log(f"card: {card}")
    return grouped_launches, grouped_b2, (svals, scommit), (avals, secret)


# -- phase 9: the vote tally ---------------------------------------------------

def _ext_lengths(j: int) -> tuple[int, int]:
    """Extension and non-RP extension lengths of 9b's validator j: a few
    dozen bytes, sweeping the SHA-512 block edges of R || A || sign bytes
    (64 + 24 + len bytes for the extension's sign bytes at this chain id,
    64 + len for the non-RP extension's raw bytes), and the 1 MiB cap at
    j = 0."""
    if j == 0:
        return 1024 * 1024, 16
    return 16 + j % 64, 16 + (5 * j) % 48


def _replay_block_id(height: int):
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    return BlockID(hashlib.sha256(b"replay-%d" % height).digest(),
                   PartSetHeader(1, hashlib.sha256(b"rp-%d" % height)
                                 .digest()))


def _stamp(base: int, j: int):
    from cometbft_tpu_torch.types.timestamp import Timestamp
    return Timestamp.from_unix_ns(1_700_000_000_000_000_000 + base * 10**12
                                  + j * 1_000_003)


def _vote_data(seed, pool):
    """Phase 9's signatures, made in the pool with the golden model
    (_sign_job): 9b's three a validator (the vote, its extension, its
    non-RP extension) and 9d's 150 a height.  Returns {"ext": [(pub,
    vote sig, ext sig, non-RP sig)], "replay": [[(pub, sig)] a height]}."""
    from cometbft_tpu_torch.types import canonical
    t0 = time.perf_counter()
    ext_bid = _replay_block_id(0)
    jobs = []
    for j in range(EXT_VALIDATORS):
        key = _seed(seed + 20, j)
        ext_len, nrp_len = _ext_lengths(j)
        ext = hashlib.shake_256(b"ext-%d" % j).digest(ext_len)
        nrp = hashlib.shake_256(b"nrp-%d" % j).digest(nrp_len)
        jobs += [(key, canonical.vote_sign_bytes(
                     CHAIN_ID, canonical.PRECOMMIT_TYPE, HEIGHT, 0, ext_bid,
                     _stamp(20, j))),
                 (key, canonical.vote_extension_sign_bytes(
                     CHAIN_ID, HEIGHT, 0, ext)),
                 (key, nrp)]
    for h in range(1, REPLAY_HEIGHTS + 1):
        make = canonical.vote_sign_bytes_template(
            CHAIN_ID, canonical.PRECOMMIT_TYPE, h, 0, _replay_block_id(h))
        jobs += [(_seed(seed + 30, j), make(_stamp(30 + h, j)))
                 for j in range(REPLAY_VALIDATORS)]
    out = pool.map(_sign_job, jobs, chunksize=16)
    n_ext = 3 * EXT_VALIDATORS
    ext = [(out[i][0], out[i][1], out[i + 1][1], out[i + 2][1])
           for i in range(0, n_ext, 3)]
    replay = [out[n_ext + k * REPLAY_VALIDATORS:
                  n_ext + (k + 1) * REPLAY_VALIDATORS]
              for k in range(REPLAY_HEIGHTS)]
    _log(f"phase 9 data: {len(jobs)} signatures made in "
         f"{time.perf_counter() - t0:.1f} s")
    return {"ext": ext, "replay": replay}


@contextlib.contextmanager
def _serial_misses():
    """Count the calls of types/vote.checked_verify that find the triple
    in neither memo (each one verifies a signature on the host); yields
    a one-element list holding the count."""
    from cometbft_tpu_torch.types import vote as vote_mod
    real = vote_mod.checked_verify
    count = [0]

    def checked(pub_key, msg, sig):
        key = vote_mod._memo_key(pub_key, msg, sig)
        if key not in vote_mod._VERIFIED and key not in vote_mod._REJECTED:
            count[0] += 1
        return real(pub_key, msg, sig)

    vote_mod.checked_verify = checked
    try:
        yield count
    finally:
        vote_mod.checked_verify = real


@contextlib.contextmanager
def _timed(module, name):
    """Time each call of module.<name> while the block runs; yields the
    list of seconds."""
    real = getattr(module, name)
    seconds = []

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return real(*a, **kw)
        finally:
            seconds.append(time.perf_counter() - t)

    setattr(module, name, timed)
    try:
        yield seconds
    finally:
        setattr(module, name, real)


@contextlib.contextmanager
def _gc_pauses():
    """Time the garbage collector's passes while the block runs; yields
    a dict {generation: [count, seconds]} filled as they happen."""
    import gc
    pauses = {0: [0, 0.0], 1: [0, 0.0], 2: [0, 0.0]}
    started = [0.0]

    def callback(phase, info):
        if phase == "start":
            started[0] = time.perf_counter()
        else:
            rec = pauses[info["generation"]]
            rec[0] += 1
            rec[1] += time.perf_counter() - started[0]

    gc.callbacks.append(callback)
    try:
        yield pauses
    finally:
        gc.callbacks.remove(callback)


def _gc_line(pauses) -> str:
    return ", ".join(f"gen{g} {n} x {sec * 1e3:.1f} ms"
                     for g, (n, sec) in pauses.items())


def _clear_memos():
    """Empty the verified / rejected triple memos, as a node that
    restarts has them."""
    from cometbft_tpu_torch.types import vote as vote_mod
    vote_mod._VERIFIED.clear()
    vote_mod._REJECTED.clear()


def _vote_storm(chain_id, height, votes, vals, seed, burst_max=BURST_MAX,
                device=None, extensions=False, count_misses=True):
    """The live vote path as the JAX package's receive routine runs it
    (consensus/state.py:282-313): ``votes`` go out as VoteMessage wire
    bytes (encode_p2p) in an order shuffled from ``seed``, come back
    through decode_p2p into an asyncio.Queue, and are drained in bursts
    of at most ``burst_max`` messages: each burst pre-verified
    (preverify_burst: the batch on the staging worker), then tallied
    serially, in arrival order, into a HeightVoteSet.  Returns a dict:
    the precommit vote set, its extended commit and that commit stripped,
    the 2/3 block id, the burst count and sizes, each burst's
    pre-verification seconds, the decode, tally and end-to-end seconds
    (decode to made commit) and the serial misses (None when not
    counted)."""
    import random
    from cometbft_tpu_torch.consensus import messages
    from cometbft_tpu_torch.consensus import state as cstate
    from cometbft_tpu_torch.consensus.height_vote_set import HeightVoteSet
    wire = [messages.encode_p2p(messages.VoteMessage(v)) for v in votes]
    random.Random(seed).shuffle(wire)

    async def drain():
        queue = asyncio.Queue()
        t0 = time.perf_counter()
        for raw in wire:
            queue.put_nowait(("peer", messages.decode_p2p(raw), "storm"))
        decode_s = time.perf_counter() - t0
        hvs = HeightVoteSet(chain_id, height, vals,
                            extensions_enabled=extensions)
        pre_s, sizes, tally_s = [], [], 0.0
        while not queue.empty():
            burst = [await queue.get()]
            while len(burst) < burst_max:
                try:
                    burst.append(queue.get_nowait())
                except asyncio.QueueEmpty:
                    break
            t1 = time.perf_counter()
            if len(burst) > 1:
                await cstate.preverify_burst(burst, height, vals, chain_id,
                                             device)
            t2 = time.perf_counter()
            for i, (_, msg, peer) in enumerate(burst):
                if i:
                    await asyncio.sleep(0)
                hvs.add_vote(msg.vote, peer)
            tally_s += time.perf_counter() - t2
            pre_s.append(t2 - t1)
            sizes.append(len(burst))
        precommits = hvs.precommits(0)
        ec = precommits.make_extended_commit(height if extensions else 0)
        return {"vote_set": precommits, "extended_commit": ec,
                "commit": ec.to_commit(),
                "maj23": precommits.two_thirds_majority()[0],
                "bursts": len(sizes), "sizes": sizes, "preverify_s": pre_s,
                "decode_s": decode_s, "tally_s": tally_s,
                "e2e_s": time.perf_counter() - t0}

    with (_serial_misses() if count_misses
          else contextlib.nullcontext([None])) as misses:
        out = asyncio.run(drain())
    out["misses"] = misses[0]
    return out


def _storm_line(what, out, launches, card):
    n = sum(out["sizes"])
    pre_ms = [t * 1e3 for t in out["preverify_s"]]
    _log(f"{what}: e2e_ms {out['e2e_s'] * 1e3:.1f} ({n} votes, "
         f"{n / out['e2e_s']:.0f} votes/s, host clock); bursts "
         f"{out['bursts']} (sizes {min(out['sizes'])}..{max(out['sizes'])}); "
         f"burst preverify ms {_p50_p90(pre_ms)}, {sum(pre_ms):.1f} in all; "
         f"serial tally "
         f"{out['tally_s'] * 1e6 / n:.2f} us/vote; decode "
         f"{out['decode_s'] * 1e6 / n:.2f} us/vote; B1 launches {launches}; "
         f"card: {card}")


def _vote_phases(seed, card, vals, commit, slot, data, mixed_small):
    """Phases 9a-9d: the vote tally at full width (the live storm over
    phase 3's 10,000-validator commit), extended votes and their restore,
    rejections, and config 4's shape.  Returns B1's and B2's launches by
    path."""
    from cometbft_tpu_torch.consensus import messages
    from cometbft_tpu_torch.consensus import state as cstate
    from cometbft_tpu_torch.consensus.height_vote_set import HeightVoteSet
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.types import vote as vote_mod
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.canonical import PRECOMMIT_TYPE
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    from cometbft_tpu_torch.types.vote import Vote
    from cometbft_tpu_torch.types.vote_set import (
        ConflictingVoteError, VoteSet, VoteSetError)
    launches = {}
    n = commit.size()
    n_bursts = -(-n // BURST_MAX)

    # -- 9a. vote-storm-10k: the live path at full width -----------------
    _phase(f"9a vote-storm-10k: {n} precommits gossiped and drained in "
           f"bursts of {BURST_MAX}")
    votes = [commit.get_vote(i) for i in range(n)]
    _clear_memos()
    ek.launches = 0
    out = _vote_storm(CHAIN_ID, HEIGHT, votes, vals, seed)
    launches["vote_storm_10k"] = ek.launches
    if (out["bursts"], ek.launches) != (n_bursts, n_bursts):
        raise AssertionError(f"the storm ran {out['bursts']} bursts and "
                             f"{ek.launches} B1 launches, expected "
                             f"{n_bursts} of each")
    if out["misses"] != 0:
        raise AssertionError(f"the serial tally verified {out['misses']} "
                             f"signatures itself, expected 0")
    if out["maj23"] != commit.block_id:
        raise AssertionError("the storm's +2/3 is not the commit's block")
    if out["commit"].to_proto() != commit.to_proto():
        raise AssertionError("the made commit differs from the source")
    ek.launches = 0
    validation.verify_commit(CHAIN_ID, vals, commit.block_id, HEIGHT,
                             out["commit"])
    launches["vote_storm_made_commit"] = ek.launches
    if ek.launches != len(tile_plan(n, DEFAULT_TILE)):
        raise AssertionError(f"verify_commit of the made commit launched "
                             f"B1 {ek.launches} times, expected "
                             f"{len(tile_plan(n, DEFAULT_TILE))}")
    _log(f"storm: {out['bursts']} bursts, {launches['vote_storm_10k']} B1 "
         f"launches, 0 serial misses; +2/3 for the commit's block; made "
         f"commit == source field for field; its verify_commit ok "
         f"({launches['vote_storm_made_commit']} launches)")
    _storm_line("vote_storm_10k first run", out, launches["vote_storm_10k"],
                card)
    _clear_memos()
    tracing.clear()
    ek.launches = 0
    with _gc_pauses() as pauses:
        out = _vote_storm(CHAIN_ID, HEIGHT, votes, vals, seed,
                          count_misses=False)
    buckets = [ev["attrs"]["bucket"] for ev in
               tracing.snapshot(category=tracing.CRYPTO)
               if ev["name"] == "kernel_execute"]
    _storm_line("vote_storm_10k warm run (no miss counter)", out,
                ek.launches, card)
    _log(f"garbage collector passes in that run (encode included): "
         f"{_gc_line(pauses)}")
    _log(f"pad bucket of each burst: {buckets}")
    _clear_memos()
    window_ms, busy_ms, kernel_ms, n_dev = _device_busy(
        lambda: _vote_storm(CHAIN_ID, HEIGHT, votes, vals, seed,
                            count_misses=False))
    if busy_ms is None:
        _log(f"profiler: no device events in a {window_ms:.0f} ms window; "
             f"device idle share of the storm not measured")
    else:
        _log(f"vote_storm_10k profiled window_ms {window_ms:.1f} (host "
             f"clock, under the profiler, encode included); device_busy_ms "
             f"{busy_ms:.4f} ({n_dev} device events; ed25519_verify_kernel "
             f"{kernel_ms:.4f} ms); device_idle_share "
             f"{1 - busy_ms / window_ms:.6f}")
    # one burst again under cuda8: the memo must end the same
    burst = [("peer", messages.VoteMessage(v), "p")
             for v in votes[:BURST_MAX]]
    memos = []
    for choice in ("cuda", "cuda8"):
        _clear_memos()
        os.environ[oe.KERNEL_ENV] = choice
        try:
            ek.launches = ek8.launches = 0
            asyncio.run(cstate.preverify_burst(burst, HEIGHT, vals,
                                               CHAIN_ID))
        finally:
            os.environ.pop(oe.KERNEL_ENV, None)
        memos.append((list(vote_mod._VERIFIED), list(vote_mod._REJECTED),
                      ek.launches, ek8.launches))
    if memos[0][:2] != memos[1][:2] or len(memos[0][0]) != BURST_MAX:
        raise AssertionError("the cuda8 burst left another memo than B1's")
    if memos[1][2:] != (0, 1) or memos[0][2:] != (1, 0):
        raise AssertionError(f"burst launches (B1, B2): {memos[0][2:]} and "
                             f"{memos[1][2:]}, expected (1, 0) and (0, 1)")
    launches["vote_burst_cuda8"] = memos[1][3]
    _log(f"one {BURST_MAX}-vote burst under cuda8 (1 B2 launch, 0 B1): "
         f"the memo ends the same as under B1 ({len(memos[0][0])} verified, "
         f"0 rejected)")

    # -- 9b. extended votes, 1,024 validators ------------------------------
    ne = EXT_VALIDATORS
    _phase(f"9b vote-ext-1k: {ne} extended precommits, then the restore "
           f"from the extended commit with cleared memos")
    ext_bid = _replay_block_id(0)
    ekeys = [Ed25519PubKey(pub) for pub, *_ in data["ext"]]
    evals = ValidatorSet([Validator.new(pk, 10) for pk in ekeys])
    eslot = {pk.address(): j for j, pk in enumerate(ekeys)}
    evotes = []
    for i, v in enumerate(evals.validators):
        j = eslot[v.address]
        ext_len, nrp_len = _ext_lengths(j)
        _, sig, ext_sig, nrp_sig = data["ext"][j]
        evotes.append(Vote(
            type=PRECOMMIT_TYPE, height=HEIGHT, round=0, block_id=ext_bid,
            timestamp=_stamp(20, j), validator_address=v.address,
            validator_index=i, signature=sig,
            extension=hashlib.shake_256(b"ext-%d" % j).digest(ext_len),
            extension_signature=ext_sig,
            non_rp_extension=hashlib.shake_256(b"nrp-%d" % j).digest(nrp_len),
            non_rp_extension_signature=nrp_sig))
    sb_edges = sorted({64 + len(v.extension_sign_bytes(CHAIN_ID)) for v in
                       evotes if len(v.extension) < 1024} |
                      {64 + len(v.non_rp_extension) for v in evotes})
    _clear_memos()
    ek.launches = 0
    out = _vote_storm(CHAIN_ID, HEIGHT, evotes, evals, seed + 1,
                      extensions=True)
    launches["vote_ext_1k_bursts"] = ek.launches
    ext_bursts = -(-ne // BURST_MAX)
    if ek.launches != ext_bursts or out["misses"] != 0:
        raise AssertionError(f"extended storm: {ek.launches} launches, "
                             f"{out['misses']} misses; expected "
                             f"{ext_bursts} and 0")
    if out["maj23"] != ext_bid:
        raise AssertionError("the extended storm's +2/3 is wrong")
    ec = out["extended_commit"]
    ec.validate_basic()
    ec.ensure_extensions(True)
    if len(vote_mod._VERIFIED) != 3 * ne:
        raise AssertionError(f"{len(vote_mod._VERIFIED)} triples memoised, "
                             f"expected {3 * ne}")
    _storm_line(f"vote_ext_1k storm ({3 * ne} triples, "
                f"{3 * BURST_MAX} lanes a burst)", out, ek.launches, card)
    _log(f"R || A || message lengths of the extension triples cover "
         f"{len(sb_edges)} values in {sb_edges[0]}..{sb_edges[-1]} B "
         f"(SHA-512 block edges at 111/112 and 239/240), and one 1 MiB "
         f"extension")
    _clear_memos()
    tracing.clear()
    ek.launches = 0
    with _timed(cstate, "preverify_votes") as pre_s, \
            _timed(vote_mod, "preverify_signatures") as sig_s, \
            _serial_misses() as misses, _gc_pauses() as pauses:
        t0 = time.perf_counter()
        restored = cstate.vote_set_from_extended_commit(CHAIN_ID, ec, evals)
        restore_ms = (time.perf_counter() - t0) * 1e3
    batch_ms = sum(ev["dur_ns"] / 1e6 for ev in
                   tracing.snapshot(category=tracing.CRYPTO)
                   if ev["name"] == "batch_verify")
    launches["vote_ext_1k_restore"] = ek.launches
    if ek.launches != 1 or misses[0] != 0:
        raise AssertionError(f"restore: {ek.launches} launches, {misses[0]} "
                             f"misses; expected 1 and 0")
    if restored.make_extended_commit(HEIGHT).to_proto() != ec.to_proto():
        raise AssertionError("the restored set makes another extended "
                             "commit")
    _log(f"vote_ext_1k restore: vote_set_from_extended_commit "
         f"{restore_ms:.1f} ms (host clock, the miss counter on): "
         f"preverify_votes of {3 * ne} triples {pre_s[0] * 1e3:.1f} ms "
         f"(its entries {(pre_s[0] - sig_s[0]) * 1e3:.1f} ms, "
         f"preverify_signatures {sig_s[0] * 1e3:.1f} ms, of which the "
         f"batch_verify span {batch_ms:.2f} ms), the votes built and "
         f"tallied serially {restore_ms - pre_s[0] * 1e3:.1f} ms; garbage "
         f"collector passes {_gc_line(pauses)}; B1 launches {ek.launches}; "
         f"serial misses 0; the restored set makes the same extended "
         f"commit; card: {card}")

    # -- 9c. rejections in a 256-message burst -----------------------------
    _phase(f"9c vote-reject-256: a corrupted signature, an equivocation, "
           f"another height, a VoteBatchMessage; config 5's key mix")
    good = [commit.get_vote(i) for i in range(REJECT_GOOD)]
    bad = good[7].copy()
    bad.signature = bytes([bad.signature[0] ^ 1]) + bad.signature[1:]
    good[7] = bad
    other_bid = BlockID(hashlib.sha256(b"other").digest(),
                        commit.block_id.part_set_header)
    equiv = Vote(type=PRECOMMIT_TYPE, height=HEIGHT, round=0,
                 block_id=other_bid, timestamp=good[3].timestamp,
                 validator_address=good[3].validator_address,
                 validator_index=3)
    equiv.signature = ref.sign(_seed(seed, slot[equiv.validator_address]),
                               equiv.sign_bytes(CHAIN_ID))
    late = commit.get_vote(300)
    late.height = HEIGHT + 1
    late.signature = ref.sign(_seed(seed, slot[late.validator_address]),
                              late.sign_bytes(CHAIN_ID))
    batch = messages.VoteBatchMessage(
        [commit.get_vote(i) for i in
         range(REJECT_GOOD, REJECT_GOOD + REJECT_BATCH)])
    burst = [("peer", messages.VoteMessage(v), "p") for v in good[:5]]
    burst.append(("peer", messages.VoteMessage(equiv), "q"))
    burst += [("peer", messages.VoteMessage(v), "p") for v in good[5:]]
    burst += [("peer", messages.VoteMessage(late), "p"),
              ("peer", batch, "p")]
    confirmations = [0]
    real_verify = Ed25519PubKey.verify_signature

    def counting(self, msg, sig):
        confirmations[0] += 1
        return real_verify(self, msg, sig)

    _clear_memos()
    ek.launches = 0
    Ed25519PubKey.verify_signature = counting
    try:
        asyncio.run(cstate.preverify_burst(burst, HEIGHT, vals, CHAIN_ID))
    finally:
        Ed25519PubKey.verify_signature = real_verify
    launches["vote_reject_256"] = ek.launches
    bad_key = vote_mod._memo_key(vals.validators[7].pub_key,
                                 bad.sign_bytes(CHAIN_ID), bad.signature)
    if (len(burst), ek.launches, confirmations[0]) != (BURST_MAX, 1, 1) or \
            list(vote_mod._REJECTED) != [bad_key] or \
            len(vote_mod._VERIFIED) != REJECT_GOOD:
        raise AssertionError(
            f"reject burst: {len(burst)} messages, {ek.launches} launches, "
            f"{confirmations[0]} serial confirmations, "
            f"{len(vote_mod._VERIFIED)} verified, "
            f"{len(vote_mod._REJECTED)} rejected")
    hvs = HeightVoteSet(CHAIN_ID, HEIGHT, vals)
    errors = []
    with _serial_misses() as misses:
        for _, msg, peer in burst:
            for v in (msg.votes if isinstance(msg, messages.VoteBatchMessage)
                      else [msg.vote]):
                try:
                    hvs.add_vote(v, peer)
                except VoteSetError as e:
                    errors.append((v.validator_index, type(e), str(e)))
    want = [(3, ConflictingVoteError, "conflicting votes from validator "
                                      f"{equiv.validator_address.hex().upper()}"),
            (7, VoteSetError, "failed to verify vote: invalid vote "
                              "signature"),
            (300, VoteSetError, f"expected {HEIGHT}/0/{PRECOMMIT_TYPE}, got "
                                f"{HEIGHT + 1}/0/{PRECOMMIT_TYPE}")]
    if errors != want or misses[0] != REJECT_BATCH:
        raise AssertionError(f"reject tally: errors {errors}, "
                             f"{misses[0]} misses")
    for idx, exc, text in errors:
        _log(f"validator {idx}: {exc.__name__}({text!r})")
    _log(f"the burst's {REJECT_GOOD + 1} VoteMessages of this height went "
         f"to B1 in 1 launch; the corrupted one was confirmed by 1 serial "
         f"verify into the negative memo; the other height was skipped by "
         f"the filter; the VoteBatchMessage's {REJECT_BATCH} votes were "
         f"verified serially ({misses[0]} misses), as the JAX package "
         f"leaves them")
    svals, scommit = mixed_small
    mvotes = [scommit.get_vote(i) for i in range(BURST_MAX)]
    kinds = collections.Counter(svals.validators[i].pub_key.type()
                                for i in range(BURST_MAX))
    mburst = [("peer", messages.VoteMessage(v), "p") for v in mvotes]
    _clear_memos()
    tracing.clear()
    ek.launches = 0
    t0 = time.perf_counter()
    asyncio.run(cstate.preverify_burst(mburst, HEIGHT, svals, CHAIN_ID))
    pre_ms = (time.perf_counter() - t0) * 1e3
    launches["vote_mixed_256"] = ek.launches
    backends = collections.Counter(
        ev["attrs"]["backend"] for ev in
        tracing.snapshot(category=tracing.CRYPTO)
        if ev["name"] == "batch_verify")
    vs = VoteSet(CHAIN_ID, HEIGHT, 0, PRECOMMIT_TYPE, svals)
    with _serial_misses() as misses:
        t0 = time.perf_counter()
        for v in mvotes:
            vs.add_vote(v)
        tally_ms = (time.perf_counter() - t0) * 1e3
    if ek.launches != 1 or backends.get("bls_native") != 1 or \
            len(vote_mod._VERIFIED) != BURST_MAX or \
            misses[0] != kinds["secp256k1"]:
        raise AssertionError(
            f"mixed burst: {ek.launches} launches, backends "
            f"{dict(backends)}, {len(vote_mod._VERIFIED)} verified, "
            f"{misses[0]} misses for {dict(kinds)}")
    _log(f"vote_mixed_256 ({dict(sorted(kinds.items()))}): preverify_burst "
         f"{pre_ms:.1f} ms (ed25519 on B1, 1 launch; bls12_381 on the host "
         f"library; secp256k1 left None); serial tally {tally_ms:.1f} ms "
         f"with {misses[0]} misses, all secp256k1; card: {card}")

    # -- 9d. config 4's shape: 150 validators x 20 heights -----------------
    nr = REPLAY_VALIDATORS
    _phase(f"9d replay-150x20: {nr} precommits a height drained as one "
           f"burst, tallied, made into a commit and verified, "
           f"{REPLAY_HEIGHTS} heights")
    rkeys = [Ed25519PubKey(pub) for pub, _ in data["replay"][0]]
    rvals = ValidatorSet([Validator.new(pk, 10) for pk in rkeys])
    rslot = {pk.address(): j for j, pk in enumerate(rkeys)}
    per_height_ms, per_height_launches = [], []
    for k, signed_h in enumerate(data["replay"]):
        h = k + 1
        bid = _replay_block_id(h)
        hvotes = []
        for i, v in enumerate(rvals.validators):
            j = rslot[v.address]
            hvotes.append(Vote(type=PRECOMMIT_TYPE, height=h, round=0,
                               block_id=bid, timestamp=_stamp(30 + h, j),
                               validator_address=v.address,
                               validator_index=i, signature=signed_h[j][1]))
        ek.launches = 0
        t0 = time.perf_counter()
        out = _vote_storm(CHAIN_ID, h, hvotes, rvals, seed + h,
                          count_misses=False)
        validation.verify_commit(CHAIN_ID, rvals, bid, h, out["commit"])
        per_height_ms.append((time.perf_counter() - t0) * 1e3)
        per_height_launches.append(ek.launches)
        if out["bursts"] != 1 or out["maj23"] != bid:
            raise AssertionError(f"height {h}: {out['bursts']} bursts")
    launches["replay_150x20"] = sum(per_height_launches)
    if set(per_height_launches) != {2}:
        raise AssertionError(f"B1 launches a height: {per_height_launches}, "
                             f"expected 2 each")
    _log(f"replay_150x20 ms a height {_p50_p90(per_height_ms)} (host clock; "
         f"decode, one burst, tally, make the commit, verify_commit; the "
         f"votes were signed beforehand in the pool); B1 launches a height "
         f"2 (the burst and verify_commit); {REPLAY_HEIGHTS} heights; "
         f"card: {card}")
    _clear_memos()
    return launches



# -- phase 10: the light client ------------------------------------------------

_FB = {"table": None, "keys": {}}


def _fb_table():
    """B·d·256^w for w < 32, d < 256 as (y - x, y + x, 2d·x·y), affine:
    the fixed-base table of the fast signer (built once a process)."""
    if _FB["table"] is None:
        from cometbft_tpu_torch.crypto import _ed25519_ref as ref
        p, d2 = ref.P, 2 * ref.D % ref.P
        table, base = [], ref._ext(ref.B)
        for _ in range(32):
            row, acc = [None], (0, 1, 1, 0)
            for _ in range(255):
                acc = ref._ext_add(acc, base)
                zi = pow(acc[2], -1, p)
                x, y = acc[0] * zi % p, acc[1] * zi % p
                row.append(((y - x) % p, (y + x) % p, d2 * x * y % p))
            table.append(row)
            base = ref._ext_add(acc, base)
        _FB["table"] = table
    return _FB["table"]


def _fb_mult(k: int) -> bytes:
    """compress(k·B) by 32 mixed additions from the table (the same
    unified formula as the golden model's _ext_add with Z2 = 1)."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    p, table = ref.P, _fb_table()
    x1, y1, z1, t1 = 0, 1, 1, 0
    for w, digit in enumerate(k.to_bytes(32, "little")):
        if digit:
            ymx, ypx, t2d = table[w][digit]
            a = (y1 - x1) * ymx % p
            b = (y1 + x1) * ypx % p
            c = t1 * t2d % p
            d = 2 * z1
            e, f, g, h = b - a, d - c, d + c, b + a
            x1, y1, z1, t1 = e * f % p, g * h % p, f * g % p, e * h % p
    zi = pow(z1, -1, p)                 # the golden model's inverse, faster
    return ref.compress((x1 * zi % p, y1 * zi % p))


def _fast_key(seed: bytes):
    key = _FB["keys"].get(seed)
    if key is None:
        from cometbft_tpu_torch.crypto import _ed25519_ref as ref
        a, prefix = ref.secret_expand(seed)
        key = _FB["keys"][seed] = (a, prefix, _fb_mult(a))
    return key


def _fast_pub_job(seed: bytes) -> bytes:
    """Worker: seed -> the golden model's public key, by the table."""
    return _fast_key(seed)[2]


def _fast_sign_job(job) -> bytes:
    """Worker: (seed, msg) -> the golden model's signature (RFC 8032
    deterministic, so byte-equal to _ed25519_ref.sign), by the table."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    seed, msg = job
    a, prefix, pub = _fast_key(seed)
    r = ref.sha512_mod_l(prefix, msg)
    rb = _fb_mult(r)
    s = (r + ref.sha512_mod_l(rb, pub, msg) * a) % ref.L
    return rb + s.to_bytes(32, "little")


class _Signer:
    """Signs (seed, msg) jobs with the fast signer, in a pool of worker
    processes or, with ``pool=None``, in this one; counts what it
    signed."""

    def __init__(self, pool=None):
        self.pool = pool
        self.signed = 0
        self.seconds = 0.0

    def _map(self, fn, jobs):
        t0 = time.perf_counter()
        out = (self.pool.map(fn, jobs, chunksize=32) if self.pool and
               len(jobs) > 64 else [fn(j) for j in jobs])
        self.seconds += time.perf_counter() - t0
        return out

    def pubs(self, seeds):
        return self._map(_fast_pub_job, seeds)

    def sign(self, jobs):
        self.signed += len(jobs)
        return self._map(_fast_sign_job, jobs)


def _light_header(chain_id, h, vals, next_vals, last_block_id,
                  app=b"app", t0=LIGHT_T0):
    from cometbft_tpu_torch.types.block import Header
    from cometbft_tpu_torch.types.timestamp import Timestamp
    return Header(chain_id=chain_id, height=h, time=Timestamp(t0 + h, 0),
                  last_block_id=last_block_id,
                  validators_hash=vals.hash(),
                  next_validators_hash=next_vals.hash(),
                  app_hash=hashlib.sha256(b"%s/%d" % (app, h)).digest(),
                  proposer_address=vals.get_proposer().address)


def _block_id(header):
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    return BlockID(header.hash(), PartSetHeader(
        1, hashlib.sha256(b"parts/%d" % header.height).digest()))


def _signed_light_block(header, vals, seed_of, signer, signers=None):
    """The LightBlock of header whose commit is signed by vals'
    validators (every one, or the indices in ``signers``; the others
    absent), each precommit at header time + (index + 1) ns."""
    from cometbft_tpu_torch.types.block import LightBlock, SignedHeader
    from cometbft_tpu_torch.types.canonical import (
        PRECOMMIT_TYPE, vote_sign_bytes_template)
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import BLOCK_ID_FLAG_COMMIT
    h, bid = header.height, _block_id(header)
    make = vote_sign_bytes_template(header.chain_id, PRECOMMIT_TYPE, h, 0,
                                    bid)
    idx = list(range(vals.size())) if signers is None else sorted(signers)
    stamps = {i: Timestamp(header.time.seconds, i + 1) for i in idx}
    sigs = signer.sign([(seed_of[vals.validators[i].address],
                         make(stamps[i])) for i in idx])
    slots = [CommitSig.absent() for _ in range(vals.size())]
    for i, sig in zip(idx, sigs):
        slots[i] = CommitSig(BLOCK_ID_FLAG_COMMIT, vals.validators[i].address,
                             stamps[i], sig)
    return LightBlock(SignedHeader(header, Commit(h, 0, bid, slots)), vals)


class _LightChain:
    """Headers 1..top of ``chain_id``: header h carries the hash of
    ``vals_of(h)`` and of ``vals_of(h + 1)`` and the block id of h - 1.
    A height's commit is signed on its first fetch and kept."""

    def __init__(self, chain_id, top, vals_of, seed_of, signer):
        from cometbft_tpu_torch.types.block_id import BlockID
        self.chain_id, self.top = chain_id, top
        self.vals_of, self.seed_of, self.signer = vals_of, seed_of, signer
        self.headers, prev = {}, BlockID()
        for h in range(1, top + 1):
            hdr = _light_header(chain_id, h, vals_of(h), vals_of(h + 1), prev)
            self.headers[h] = hdr
            prev = _block_id(hdr)
        self._blocks = {}

    def light_block(self, h):
        lb = self._blocks.get(h)
        if lb is None:
            lb = self._blocks[h] = _signed_light_block(
                self.headers[h], self.vals_of(h), self.seed_of, self.signer)
        return lb

    @classmethod
    def rotating(cls, chain_id, n, top, every, rotate, seed_base, signer):
        """Equal-power ed25519 validators; every ``every`` heights the
        ``rotate`` oldest leave and as many new keys join, through
        ValidatorSet.update_with_change_set, and the new set's proposer
        priorities move on by one, as a node's state does."""
        from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
        from cometbft_tpu_torch.types.validator import Validator
        from cometbft_tpu_torch.types.validator_set import ValidatorSet
        epochs = top // every + 1          # the next set of the top height
        seeds = [_seed(seed_base, j) for j in range(n + rotate * (epochs - 1))]
        vals = [Validator.new(Ed25519PubKey(pub), LIGHT_POWER)
                for pub in signer.pubs(seeds)]
        sets = [ValidatorSet(vals[:n])]
        for k in range(1, epochs):
            nxt = sets[-1].copy()
            nxt.update_with_change_set(
                [Validator(v.address, v.pub_key, 0)
                 for v in vals[(k - 1) * rotate:k * rotate]] +
                vals[n + (k - 1) * rotate:n + k * rotate])
            sets.append(nxt.copy_increment_proposer_priority(1))
        chain = cls(chain_id, top, lambda h: sets[(h - 1) // every],
                    {v.address: s for v, s in zip(vals, seeds)}, signer)
        chain.sets = sets
        return chain


def _chain_provider(chain, name, forks=None):
    """A Provider over ``chain`` recording the heights asked of it and
    the evidence reported to it; ``forks`` {height: LightBlock} replaces
    the chain's blocks at those heights."""
    from cometbft_tpu_torch.light.provider import (
        LightBlockNotFoundError, Provider)

    class ChainProvider(Provider):
        def __init__(self):
            self.requests, self.evidence = [], []

        async def light_block(self, height):
            self.requests.append(height)
            height = height or chain.top
            if forks and height in forks:
                return forks[height]
            if not 1 <= height <= chain.top:
                raise LightBlockNotFoundError(
                    f"no light block at height {height}")
            return chain.light_block(height)

        async def report_evidence(self, ev):
            self.evidence.append(ev)

        def id(self):
            return name

    return ChainProvider()


def _trusts(chain, a, b):
    """Whether a hop from height a to height b passes on an honest chain
    whose every commit is signed by its whole set: adjacent, or the
    validators of a's set that are in b's set hold more than a third of
    a's power (verify_commit_light_trusting at trust level 1/3)."""
    if b == a + 1:
        return True
    old, new = chain.vals_of(a), chain.vals_of(b)
    power = sum(v.voting_power for v in old.validators
                if new.has_address(v.address))
    return power > old.total_voting_power() // 3


def _skipping_plan(chain, root, target):
    """What the skipping algorithm of the JAX package's light client
    (cometbft_tpu/light/client.py:203-240) fetches and stores syncing
    ``chain`` from ``root`` to ``target``: (fetched heights after the
    root, stored heights, hops tried, hops refused for lack of trust)."""
    verified, pivots, fetched, stored = root, [target], [target], [root]
    tried = refused = 0
    while pivots:
        candidate = pivots[-1]
        tried += 1
        if _trusts(chain, verified, candidate):
            stored.append(candidate)
            verified = pivots.pop()
            continue
        refused += 1
        pivot = (verified + candidate) // 2
        pivots.append(pivot)
        fetched.append(pivot)
    return fetched, sorted(stored), tried, refused


@contextlib.contextmanager
def _hop_log(client_mod, verifier):
    """Time each hop the light client tries (light/client.verify) and
    count the hops refused for lack of trust; yields the record."""
    real = client_mod.verify
    rec = {"ms": [], "refused": 0}

    def hop(*a, **kw):
        t = time.perf_counter()
        try:
            return real(*a, **kw)
        except verifier.NewValSetCantBeTrustedError:
            rec["refused"] += 1
            raise
        finally:
            rec["ms"].append((time.perf_counter() - t) * 1e3)

    client_mod.verify = hop
    try:
        yield rec
    finally:
        client_mod.verify = real


@contextlib.contextmanager
def _launch_log(kernel_module):
    """The bucket (padded lanes) of each launch of the kernel module's
    wrapper while the block runs; the wrapper's own count decides what
    was a launch."""
    real = kernel_module.verify_cols
    buckets = []

    def logged(*a):
        before = kernel_module.launches
        out = real(*a)
        if kernel_module.launches != before:
            buckets.append(int(a[0].shape[1]))
        return out

    kernel_module.verify_cols = logged
    try:
        yield buckets
    finally:
        kernel_module.verify_cols = real


@contextlib.contextmanager
def _async_timed(cls, name):
    """Time each await of the coroutine method cls.<name>; yields the
    list of seconds."""
    real = getattr(cls, name)
    seconds = []

    async def timed(self, *a, **kw):
        t = time.perf_counter()
        try:
            return await real(self, *a, **kw)
        finally:
            seconds.append(time.perf_counter() - t)

    setattr(cls, name, timed)
    try:
        yield seconds
    finally:
        setattr(cls, name, real)


def _light_client(chain, root, primary, witnesses, db, mode="skipping",
                  period_ns=LIGHT_TRUSTING_PERIOD_NS):
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.store import TrustedStore
    return Client(chain.chain_id,
                  TrustOptions(period_ns, root, chain.headers[root].hash()),
                  primary, witnesses, TrustedStore(db),
                  verification_mode=mode, max_clock_drift_ns=LIGHT_DRIFT_NS)


def _sync(chain, root, target, now, db=None, witnesses=2, mode="skipping",
          on_start=None):
    """Initialize a client at ``root`` over a fresh store and sync it to
    ``target`` (``on_start()`` runs between the two); returns (client,
    primary, witnesses, sync ms)."""
    from cometbft_tpu_torch.db import MemDB
    primary = _chain_provider(chain, "primary")
    wits = [_chain_provider(chain, f"witness-{i}") for i in range(witnesses)]
    client = _light_client(chain, root, primary, wits,
                           db if db is not None else MemDB(), mode)
    asyncio.run(client.initialize(now=now))
    if on_start is not None:
        on_start()
    t0 = time.perf_counter()
    lb = asyncio.run(client.verify_to_height(target, now=now))
    ms = (time.perf_counter() - t0) * 1e3
    if lb.height != target or lb.hash() != chain.headers[target].hash():
        raise AssertionError(f"the sync ended at {lb.height}, not {target}")
    return client, primary, wits, ms


def _sync_split(run):
    """The parts of one sync (ms) from the spans and timers of run."""
    batch = [ev for ev in run["spans"] if ev["name"] == "batch_verify"]
    return {
        "walk": sum(run["walks"]) * 1e3,
        "batch_verify": sum(ev["dur_ns"] for ev in batch) / 1e6,
        "store_encode": sum(run["encode"]) * 1e3,
        "store_decode": sum(run["decode"]) * 1e3,
        "witness_check": sum(run["detect"]) * 1e3,
        "lanes": [ev["attrs"]["batch"] for ev in batch],
    }


def _bls_hop(agg_set, now, card):
    """10c's aggregate hop: a root and a target 10 heights on, both over
    8d's BLS set and each carrying one aggregate signature of every
    validator; the trusting check takes the signer_vals arm.  No kernel
    runs."""
    from cometbft_tpu_torch.crypto import bls12381
    from cometbft_tpu_torch.libs.bits import BitArray
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.types.block import LightBlock, SignedHeader
    from cometbft_tpu_torch.types.commit import AggregateCommit
    avals, secret = agg_set
    na = avals.size()
    _phase(f"10c light-hop-bls-10k: one hop to an aggregate commit over "
           f"{na} BLS validators")
    priv = bls12381.Bls12381PrivKey(
        (sum(secret.values()) % bls12381.R_ORDER).to_bytes(32, "big"))
    chain = _LightChain("light-bls", 11, lambda h: avals, {}, None)
    for h in (1, 11):
        hdr = chain.headers[h]
        agg = AggregateCommit(height=h, round=0, block_id=_block_id(hdr),
                              signers=BitArray.from_indices(na, range(na)))
        agg.signature = priv.sign(agg.vote_sign_bytes(chain.chain_id))
        chain._blocks[h] = LightBlock(SignedHeader(hdr, agg), avals)
    validation.reset_aggregate_caches()
    ek.launches = 0
    with _timed(validation, "_verify_aggregate_commit") as pairing:
        client, _, _, ms = _sync(chain, 1, 11, now, witnesses=0)
    if ek.launches or client.store.heights() != [1, 11] or \
            len(pairing) != 2:
        raise AssertionError(f"the aggregate hop launched B1 {ek.launches}"
                             f" times, stored {client.store.heights()}")
    _log(f"light_hop_bls_10k ms {ms:.1f} (the root decoded from the store "
         f"with its {na} keys checked, the trusting check through "
         f"signer_vals and the 2/3 check: {sum(pairing) * 1e3:.1f} ms in "
         f"the two aggregate verifications); 0 launches; card: {card}")


def _light_phases(seed, card, pool, keys10k, vals10k, agg_set=None):
    """Phases 10a-10d: the light client (light/verifier, light/store,
    light/client over the port's db) on B1, and with ``agg_set`` (8d's
    BLS set and secrets) one hop to an aggregate commit.  Returns B1's
    launches by part and B2's on the cuda8 hop."""
    import tempfile

    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from cometbft_tpu_torch.db import MemDB, SQLiteDB
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.light import client as client_mod
    from cometbft_tpu_torch.light import store as store_mod
    from cometbft_tpu_torch.light import verifier
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    from cometbft_tpu_torch.types import signature_cache, validation
    from cometbft_tpu_torch.types.block import LightBlock, SignedHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    from cometbft_tpu_torch.wire import encode, pb

    t_phase = time.perf_counter()
    signer = _Signer(pool)
    launches, launches8 = {}, {}
    # the fast signer is the golden model's arithmetic on a table
    probe = [(_seed(seed + 60, i), b"light %d " % i * (i * 37)) for i in
             range(3)] + [(_seed(seed + 60, i % 3), b"pool %d" % i)
                          for i in range(97)]
    fast = signer.sign(probe)
    signer.signed = 0
    if [_fast_pub_job(s) for s, _ in probe[:3]] != \
            [ref.public_key(s) for s, _ in probe[:3]] or \
            [fast[i] for i in (0, 1, 2, 50, 96)] != \
            [ref.sign(*probe[i]) for i in (0, 1, 2, 50, 96)]:
        raise AssertionError("the fast signer != the golden model")

    # -- 10a. light-skip-1k ------------------------------------------------
    n, top = LIGHT_VALIDATORS, LIGHT_HEIGHTS
    _phase(f"10a light-skip-1k: BASELINE config 3 at {n} validators, then a "
           f"skipping sync over {top} heights rotating {LIGHT_ROTATE} of "
           f"{n} every {LIGHT_EVERY}")
    t0 = time.perf_counter()
    chain = _LightChain.rotating(LIGHT_CHAIN_ID, n, top, LIGHT_EVERY,
                                 LIGHT_ROTATE, seed + 70, signer)
    build_s = time.perf_counter() - t0
    for k, vs in enumerate(chain.sets[1:], 1):
        fresh = ValidatorSet([Validator(v.address, v.pub_key, v.voting_power)
                              for v in vs.validators])
        if fresh.hash() != vs.hash() or \
                [v.address for v in fresh.validators] != \
                [v.address for v in vs.validators]:
            raise AssertionError(f"set {k} after update_with_change_set != "
                                 f"the same members built from scratch")
    _log(f"chain of {top} headers over {len(chain.sets)} sets "
         f"({len(chain.seed_of)} keys) built in {build_s:.1f} s; every "
         f"rotated set == its members built from scratch (hash, order)")

    # config 3 exactly as the JAX package runs it: no cache across hops
    root = chain.light_block(1)
    hops = [chain.light_block(h) for h in CONFIG3_HOPS]
    vs0, now3 = chain.vals_of(1), Timestamp(LIGHT_T0 + 600, 0)

    def config3():
        for lb in hops:
            verifier.verify(root.signed_header, vs0, lb.signed_header, vs0,
                            CONFIG3_PERIOD_NS, now3, CONFIG3_DRIFT_NS,
                            verifier.DEFAULT_TRUST_LEVEL)

    config3_ms = []
    for _ in range(6):
        ek.launches = 0
        with _launch_log(ek) as buckets:
            t0 = time.perf_counter()
            config3()
            config3_ms.append((time.perf_counter() - t0) * 1e3 / len(hops))
        if ek.launches != 2 * len(hops):
            raise AssertionError(f"config 3 launched B1 {ek.launches} "
                                 f"times, expected {2 * len(hops)}")
    launches["light_config3"] = 2 * len(hops)
    _log(f"light_skipping_verify_ms_per_hop first {config3_ms[0]:.2f}, "
         f"then {_p50_p90(config3_ms[1:])} over {len(config3_ms) - 1} runs "
         f"of {len(hops)} hops (1 -> {', '.join(map(str, CONFIG3_HOPS))}); "
         f"B1 launches a hop 2 (trusting, then 2/3), buckets {buckets[:2]}; "
         f"card: {card}")

    # the sync: cold first (the providers sign what the client fetches)
    now = Timestamp(LIGHT_T0 + top + 5, 0)
    fetched, stored, tried, refused = _skipping_plan(chain, 1, top)
    signed0, sign_s0 = signer.signed, signer.seconds
    client, primary, wits, cold_ms = _sync(chain, 1, top, now)
    if client.store.heights() != stored:
        raise AssertionError(f"stored {client.store.heights()}, the JAX "
                             f"client's algorithm stores {stored}")
    if primary.requests != [1] + fetched or \
            any(w.requests != [top] for w in wits):
        raise AssertionError(f"fetched {primary.requests} / "
                             f"{[w.requests for w in wits]}, expected "
                             f"{[1] + fetched}")
    _log(f"cold sync 1 -> {top}: {cold_ms:.1f} ms, of which signing "
         f"{signer.signed - signed0} signatures for the fetched heights "
         f"{signer.seconds - sign_s0:.2f} s; stored heights {stored} == "
         f"the JAX client's algorithm; primary fetched {primary.requests}")

    runs = []
    for _ in range(LIGHT_SYNC_RUNS):
        hits0 = signature_cache._HITS.value
        ek.launches = 0
        tracing.clear()
        with _hop_log(client_mod, verifier) as hop_rec, \
                _launch_log(ek) as buckets, \
                _timed(validation, "_walk_commit") as walks, \
                _timed(store_mod.TrustedStore, "save_light_block") as enc, \
                _timed(store_mod, "_light_block") as dec, \
                _async_timed(client_mod.Client, "_detect_divergence") as det, \
                _gc_pauses() as gc_rec:
            client, primary, wits, ms = _sync(
                chain, 1, top, now, on_start=lambda: [
                    rec.clear() for rec in (walks, enc, dec, det)])
        if client.store.heights() != stored:
            raise AssertionError("a warm sync stored other heights")
        runs.append({"ms": ms, "launches": ek.launches, "buckets": buckets,
                     "hops": hop_rec, "hits": signature_cache._HITS.value -
                     hits0, "walks": walks, "encode": enc, "decode": dec,
                     "detect": det, "gc": gc_rec,
                     "spans": tracing.snapshot(category=tracing.CRYPTO)})
    last = runs[-1]
    split = _sync_split(last)
    if len(last["hops"]["ms"]) != tried or last["hops"]["refused"] != \
            refused or last["launches"] != len(split["lanes"]):
        raise AssertionError(
            f"hops {len(last['hops']['ms'])} tried / "
            f"{last['hops']['refused']} refused, launches "
            f"{last['launches']} for {len(split['lanes'])} batches; the "
            f"plan says {tried} / {refused}")
    launches["light_sync_1k"] = last["launches"]
    hop_ms = [x for r in runs for x in r["hops"]["ms"]]
    sync_ms = ", ".join(f"{r['ms']:.1f}" for r in runs)
    rest_ms = last["ms"] - sum(split[k] for k in (
        "walk", "batch_verify", "store_encode", "store_decode",
        "witness_check"))
    _log(f"light_sync_1k ms {sync_ms} "
         f"({LIGHT_SYNC_RUNS} warm syncs 1 -> {top}, MemDB, 2 honest "
         f"witnesses); hops tried {tried}, accepted {tried - refused}, "
         f"refused for lack of trust {refused}; heights fetched "
         f"{len(fetched)} + the root; B1 launches {last['launches']} with "
         f"lanes {split['lanes']} in buckets {last['buckets']}; cache hits "
         f"{last['hits']:.0f}; hop ms {_p50_p90(hop_ms)} over "
         f"{len(hop_ms)} hops; card: {card}")
    _log(f"light_sync_1k split (last run, ms): commit walks "
         f"{split['walk']:.1f}, batch_verify spans "
         f"{split['batch_verify']:.1f}, store encode "
         f"{split['store_encode']:.1f} ({len(last['encode'])} saves), "
         f"store decode {split['store_decode']:.1f} "
         f"({len(last['decode'])} reads), witnesses' cross-check "
         f"{split['witness_check']:.1f}, the rest {rest_ms:.1f} of "
         f"{last['ms']:.1f}; gc per run: "
         f"{'; '.join(_gc_line(r['gc']) for r in runs)}")
    window_ms, busy_ms, kernel_ms, events = _device_busy(
        lambda: _sync(chain, 1, top, now))
    if busy_ms is None:
        _log(f"profiled sync {window_ms:.1f} ms: the profiler saw no device "
             f"event (device idle share not measured)")
    else:
        _log(f"profiled sync {window_ms:.1f} ms: device busy {busy_ms:.3f} "
             f"ms ({events} events), B1 {kernel_ms:.3f} ms, idle share "
             f"{1 - busy_ms / window_ms:.4f}")
    with tempfile.TemporaryDirectory() as tmp:
        db = SQLiteDB(os.path.join(tmp, "light.db"))
        client, _, _, sqlite_ms = _sync(chain, 1, top, now, db=db)
        if client.store.heights() != stored:
            raise AssertionError("the SQLite sync stored other heights")
        db.close()
    _log(f"light_sync_1k on SQLiteDB (WAL, a temporary directory): "
         f"{sqlite_ms:.1f} ms, the same stored heights; card: {card}")

    # -- 10b. light-seq-1k -------------------------------------------------
    lo, hi = LIGHT_SEQ_ROOT, LIGHT_SEQ_TARGET
    _phase(f"10b light-seq-1k: sequential {lo} -> {hi}, across the rotation "
           f"at {LIGHT_EVERY + 1}")
    _sync(chain, lo, hi, now, mode="sequential")      # signs the heights
    ek.launches = 0
    with _launch_log(ek) as buckets:
        client, primary, _, seq_ms = _sync(chain, lo, hi, now,
                                           mode="sequential")
    if client.store.heights() != list(range(lo, hi + 1)) or \
            ek.launches != hi - lo:
        raise AssertionError(f"sequential sync stored "
                             f"{client.store.heights()} with {ek.launches} "
                             f"launches")
    launches["light_seq_1k"] = ek.launches
    _log(f"light_seq_1k ms a height {seq_ms / (hi - lo):.2f} ({seq_ms:.1f} "
         f"ms for {hi - lo} heights, one 2/3 check each); B1 launches "
         f"{ek.launches}, buckets {sorted(set(buckets))}; card: {card}")

    # -- 10c. light-hop-10k ------------------------------------------------
    n10 = vals10k.size()
    _phase(f"10c light-hop-10k: one non-adjacent hop over {n10} validators, "
           f"{n10 // HOP10K_REPLACE_EVERY} replaced")
    seed_of = {pk.address(): _seed(seed, j) for j, pk in enumerate(keys10k)}
    gone = [pk for j, pk in enumerate(keys10k)
            if j % HOP10K_REPLACE_EVERY == 0]
    new_seeds = [_seed(seed + 80, j) for j in range(len(gone))]
    new_keys = [Ed25519PubKey(p) for p in signer.pubs(new_seeds)]
    seed_of.update((pk.address(), s) for pk, s in zip(new_keys, new_seeds))
    target_set = vals10k.copy()
    target_set.update_with_change_set(
        [Validator(pk.address(), pk, 0) for pk in gone] +
        [Validator.new(pk, 10) for pk in new_keys])
    target_set = target_set.copy_increment_proposer_priority(1)
    chain10 = _LightChain("light-10k", 11,
                          lambda h: vals10k if h < 11 else target_set,
                          seed_of, signer)
    now10 = Timestamp(LIGHT_T0 + 20, 0)
    t0 = time.perf_counter()
    _sync(chain10, 1, 11, now10, witnesses=0)      # signs both heights
    cold10_ms = (time.perf_counter() - t0) * 1e3
    ek.launches = 0
    tracing.clear()
    with _launch_log(ek) as buckets:
        client10, _, _, hop10_ms = _sync(chain10, 1, 11, now10, witnesses=0)
    lanes10 = [ev["attrs"]["batch"] for ev in
               tracing.snapshot(category=tracing.CRYPTO)
               if ev["name"] == "batch_verify"]
    if ek.launches != 2 or client10.store.heights() != [1, 11]:
        raise AssertionError(f"the 10k hop launched B1 {ek.launches} times "
                             f"and stored {client10.store.heights()}")
    launches["light_hop_10k"] = ek.launches
    os.environ[oe.KERNEL_ENV] = "cuda8"
    try:
        ek.launches = ek8.launches = 0
        client8, _, _, hop10_8_ms = _sync(chain10, 1, 11, now10, witnesses=0)
        if (ek8.launches, ek.launches) != (2, 0):
            raise AssertionError(f"cuda8 hop launched B2 {ek8.launches} and "
                                 f"B1 {ek.launches} times")
    finally:
        os.environ.pop(oe.KERNEL_ENV, None)
    launches8["light_hop_10k_cuda8"] = 2

    def stored_bytes(c):
        return [encode(pb.LIGHT_BLOCK, c.store.light_block(h).to_proto())
                for h in c.store.heights()]

    if stored_bytes(client8) != stored_bytes(client10):
        raise AssertionError("the cuda8 hop stored other bytes")
    _log(f"light_hop_10k ms {hop10_ms:.1f} (initialize excluded; cold with "
         f"signing {cold10_ms:.0f} ms); B1 launches "
         f"{launches['light_hop_10k']} with lanes {lanes10} in buckets "
         f"{buckets}; under cuda8 "
         f"{hop10_8_ms:.1f} ms with 2 B2 launches, 0 B1, the same store "
         f"byte for byte; card: {card}")

    if agg_set is not None:
        _bls_hop(agg_set, now10, card)

    # -- 10d. light-reject-1k ----------------------------------------------
    _phase("10d light-reject-1k: a corrupted signature, an expired root, "
           "clock drift, a lunatic witness, backwards verification")
    ek.launches = 0
    target = chain.light_block(50)
    bad = _corrupted(target.signed_header.commit, [7])
    primary = _chain_provider(chain, "primary", forks={50: LightBlock(
        SignedHeader(target.signed_header.header, bad), target.validator_set)})
    client = _light_client(chain, 1, primary, [], MemDB())
    asyncio.run(client.initialize(now=now))
    # the texts the JAX package raises (cometbft_tpu/types/validation.py
    # "wrong signature (#%d): %X", light/verifier.py:113, :66)
    text = f"wrong signature (#7): {bad.signatures[7].signature.hex().upper()}"
    _expect_rejection(lambda: asyncio.run(client.verify_to_height(
        50, now=now)), verifier.InvalidHeaderError, text)
    if client.store.heights() != [1] or ek.launches != 1:
        raise AssertionError(f"corrupted target: stored "
                             f"{client.store.heights()}, {ek.launches} "
                             f"launches")
    _log(f"corrupted #7 at height 50: InvalidHeaderError {text[:34]}...; "
         f"nothing stored; 1 B1 launch (the trusting batch)")
    reject_launches = ek.launches

    late = root.signed_header.header.time.add_ns(LIGHT_TRUSTING_PERIOD_NS + 1)
    client = _light_client(chain, 1, _chain_provider(chain, "primary"), [],
                           MemDB())
    asyncio.run(client.initialize(now=now))
    _expect_rejection(lambda: asyncio.run(client.verify_to_height(
        41, now=late)), verifier.OldHeaderExpiredError,
        "trusted header expired")
    expired_at = root.signed_header.header.time.add_ns(
        LIGHT_TRUSTING_PERIOD_NS)
    _expect_rejection(lambda: asyncio.run(client.verify_to_height(
        2, now=late)), verifier.OldHeaderExpiredError,
        f"trusted header expired at {expired_at}")
    early = Timestamp(LIGHT_T0 + 41 - LIGHT_DRIFT_NS // 10**9, 0)
    _expect_rejection(lambda: asyncio.run(client.verify_to_height(
        41, now=early)), verifier.InvalidHeaderError,
        "header time exceeds max clock drift")
    if client.store.heights() != [1] or ek.launches != reject_launches:
        raise AssertionError("an expired or drifting header was stored or "
                             "launched B1")
    _log(f"expired root (hop and adjacent): OldHeaderExpiredError 'trusted "
         f"header expired' / 'trusted header expired at {expired_at}'; "
         f"height 41 at now = its time - {LIGHT_DRIFT_NS // 10**9} s: "
         f"InvalidHeaderError 'header time exceeds max clock drift'; "
         f"nothing stored, no launch")

    honest = chain.light_block(FORK_HEIGHT)
    hdr = honest.signed_header.header
    fork_header = _light_header(
        chain.chain_id, FORK_HEIGHT, chain.vals_of(FORK_HEIGHT),
        chain.vals_of(FORK_HEIGHT + 1), hdr.last_block_id, app=b"lunatic")
    signers = [i for i in range(n) if i % 10 < FORK_SIGNERS * 10 // n]
    fork = _signed_light_block(fork_header, chain.vals_of(FORK_HEIGHT),
                               chain.seed_of, signer, signers=signers)
    fork.validate_basic(chain.chain_id)
    primary = _chain_provider(chain, "primary")
    wits = [_chain_provider(chain, "witness-0"),
            _chain_provider(chain, "witness-1", forks={FORK_HEIGHT: fork})]
    client = _light_client(chain, 1, primary, list(wits), MemDB())
    asyncio.run(client.initialize(now=now))
    ek.launches = 0
    _expect_rejection(lambda: asyncio.run(client.verify_to_height(
        FORK_HEIGHT, now=now)), client_mod.DivergenceError,
        "witness witness-1 diverges from primary")
    ev = primary.evidence[0] if len(primary.evidence) == 1 else None
    want = sorted((chain.vals_of(FORK_HEIGHT).validators[i] for i in signers),
                  key=lambda v: (-v.voting_power, v.address))
    if ev is None or wits[1].evidence != [ev] or wits[0].evidence or \
            client.witnesses != [wits[0]] or \
            [v.address for v in ev.byzantine_validators] != \
            [v.address for v in want] or ev.common_height != 1 or \
            ev.total_voting_power != n * LIGHT_POWER or \
            client.store.heights() != [1, FORK_HEIGHT] or ek.launches != 2:
        raise AssertionError("the lunatic witness was not handled as the "
                             "JAX client handles it")
    ev.validate_basic()
    launches["light_fork"] = ek.launches
    _log(f"lunatic witness at {FORK_HEIGHT} (app_hash differs, signed by "
         f"{len(signers)} of the common set): DivergenceError; evidence "
         f"{ev.hash().hex()[:16]} reported to the primary and the witness, "
         f"common height 1, byzantine validators == the {len(signers)} "
         f"signers; the witness dropped; {ek.launches} B1 launches")

    client = _light_client(chain, BACKWARDS_ROOT,
                           _chain_provider(chain, "primary"), [], MemDB())
    asyncio.run(client.initialize(now=now))
    ek.launches = 0
    low = BACKWARDS_ROOT - BACKWARDS_DEPTH
    t0 = time.perf_counter()
    lb = asyncio.run(client.verify_light_block_at_height(low, now=now))
    back_ms = (time.perf_counter() - t0) * 1e3
    if lb.hash() != chain.headers[low].hash() or ek.launches or \
            client.store.heights() != list(range(low, BACKWARDS_ROOT + 1)):
        raise AssertionError("backwards verification went wrong")
    _log(f"backwards {BACKWARDS_ROOT} -> {low} by hash links: "
         f"{back_ms:.1f} ms with the providers' signing, 0 launches, "
         f"{BACKWARDS_DEPTH + 1} heights stored; card: {card}")
    launches["light_reject"] = reject_launches
    _log(f"phase 10 took {time.perf_counter() - t_phase:.1f} s, of which "
         f"{signer.signed} signatures {signer.seconds:.1f} s")
    return launches, launches8


# -- phase 11: the chain below consensus --------------------------------------

def _load_tx(seed: int, h: int, j: int, size: int = EXEC_TX_BYTES) -> bytes:
    """A tx of the JAX load generator's form (tools/loadtime.py
    payload_bytes): one "a" key whose value is the hex of a JSON payload,
    padded with hex after a '.' to ``size`` bytes; made from the seed."""
    body = json.dumps({"id": f"chip-smoke-{seed}",
                       "time_ns": EXEC_T0 * 10**9 + h * 10**6 + j,
                       "rate": EXEC_TXS, "connections": 1},
                      separators=(",", ":")).encode().hex()
    tx = b"a=" + body.encode()
    pad = size - len(tx) - 1
    return tx + b"." + hashlib.shake_128(
        b"%d/%d/%d" % (seed, h, j)).hexdigest((pad + 1) // 2)[:pad].encode()


class _ExecChain:
    """A chain driven through the port's block executor over a kvstore app
    on AppConns: genesis, the Handshaker's InitChain, then each height as
    the JAX package's tests/test_state.py _run_chain builds one —
    create_proposal_block, the txs spliced in through state.make_block,
    process_proposal, apply_block (B1 verifies the previous height's
    commit), save_block with the commit the height's set signs."""

    def __init__(self, chain_id, seeds, signer, pubs=None, power=EXEC_POWER,
                 dbs=None, device=None, sig_cache=None):
        from cometbft_tpu_torch.abci.client import AppConns
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
        from cometbft_tpu_torch.consensus.replay import Handshaker
        from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
        from cometbft_tpu_torch.db import MemDB
        from cometbft_tpu_torch.state import make_genesis_state
        from cometbft_tpu_torch.state.execution import BlockExecutor
        from cometbft_tpu_torch.state.store import Store
        from cometbft_tpu_torch.store import BlockStore
        from cometbft_tpu_torch.types.commit import Commit
        from cometbft_tpu_torch.types.genesis import (
            GenesisDoc, GenesisValidator)
        from cometbft_tpu_torch.types.timestamp import Timestamp
        self.chain_id, self.signer, self.device = chain_id, signer, device
        self.sig_cache = {} if sig_cache is None else sig_cache
        pubs = signer.pubs(seeds) if pubs is None else pubs
        keys = [Ed25519PubKey(p) for p in pubs]
        self.seed_of = {pk.address(): s for pk, s in zip(keys, seeds)}
        self.doc = GenesisDoc(
            chain_id=chain_id, genesis_time=Timestamp(EXEC_T0, 0),
            validators=[GenesisValidator(b"", pk, power) for pk in keys])
        self.dbs = dbs or {"state": MemDB(), "block": MemDB(),
                           "app": MemDB()}
        state = make_genesis_state(self.doc)
        self.app = KVStoreApplication(db=self.dbs["app"])
        self.conns = AppConns(self.app)
        self.state_store = Store(self.dbs["state"])
        self.block_store = BlockStore(self.dbs["block"])
        self.state_store.save(state)
        asyncio.run(Handshaker(self.state_store, state, self.block_store,
                               self.doc, device=device
                               ).handshake(self.conns))
        self.state = state
        self.exec = BlockExecutor(self.state_store, self.conns.consensus,
                                  block_store=self.block_store, device=device)
        self.last_commit = Commit()
        self.applied = {}           # height -> the applied block's hash
        self.parts = {}             # height -> parts of the block

    def sign_commit(self, vals, h, block_id, skip=()):
        """The commit for (h, block_id): every validator of vals precommits
        at EXEC_T0 + h s + (index + 1) ns, but those in ``skip`` (absent)."""
        from cometbft_tpu_torch.types.canonical import (
            PRECOMMIT_TYPE, vote_sign_bytes_template)
        from cometbft_tpu_torch.types.commit import Commit, CommitSig
        from cometbft_tpu_torch.types.timestamp import Timestamp
        from cometbft_tpu_torch.types.vote import BLOCK_ID_FLAG_COMMIT
        make = vote_sign_bytes_template(self.chain_id, PRECOMMIT_TYPE, h, 0,
                                        block_id)
        idx = [i for i in range(vals.size()) if i not in skip]
        stamps = {i: Timestamp(EXEC_T0 + h, i + 1) for i in idx}
        jobs = [(self.seed_of[vals.validators[i].address], make(stamps[i]))
                for i in idx]
        todo = [j for j in jobs if j not in self.sig_cache]
        self.sig_cache.update(zip(todo, self.signer.sign(todo)))
        slots = [CommitSig.absent() for _ in range(vals.size())]
        for i, job in zip(idx, jobs):
            slots[i] = CommitSig(BLOCK_ID_FLAG_COMMIT,
                                 vals.validators[i].address, stamps[i],
                                 self.sig_cache[job])
        return Commit(h, 0, block_id, slots)

    async def _propose_apply(self, txs):
        from cometbft_tpu_torch.types.block_id import BlockID
        state = self.state
        h = state.last_block_height + 1
        proposer = state.validators.get_proposer()
        block = await self.exec.create_proposal_block(
            h, state, self.last_commit.wrapped_extended_commit(),
            proposer.address)
        # the nop mempool reaps nothing: splice the txs in
        block = state.make_block(h, txs, self.last_commit, [],
                                 proposer.address,
                                 block_time=block.header.time)
        parts = block.make_part_set()
        block_id = BlockID(block.hash(), parts.header())
        if not await self.exec.process_proposal(block, state):
            raise AssertionError(f"the app rejected the proposal at {h}")
        self.state = await self.exec.apply_block(state, block_id, block)
        return block, parts, block_id, state.validators

    def step(self, txs):
        """One height; returns (block, seconds of its host work with the
        signing of its commit left out)."""
        t0 = time.perf_counter()
        block, parts, block_id, signing_set = asyncio.run(
            self._propose_apply(txs))
        t1 = time.perf_counter()
        h = block.header.height
        commit = self.sign_commit(signing_set, h, block_id)
        t2 = time.perf_counter()
        self.block_store.save_block(block, parts, commit)
        t3 = time.perf_counter()
        self.last_commit = commit
        self.applied[h] = block.hash()
        self.parts[h] = parts.total
        return block, (t1 - t0) + (t3 - t2)

    def info(self, conns=None):
        from cometbft_tpu_torch.abci import types as abci
        return asyncio.run((conns or self.conns).query.info(
            abci.InfoRequest()))


def _exec_txs(seed, h, updates):
    """Height h's EXEC_TXS txs; a height in ``updates`` carries its val=
    tx in the last place."""
    txs = [_load_tx(seed, h, j) for j in range(EXEC_TXS)]
    if h in updates:
        txs[-1] = updates[h]
    return txs


def _exec_updates(seed, chain, signer):
    """The val= txs of EXEC_UPDATES: a new validator, the first genesis
    validator re-powered to twice its power, another new validator.
    The new keys' seeds join the chain's signers."""
    from cometbft_tpu_torch.abci.kvstore import make_val_set_change_tx
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
    seeds = [_seed(seed + 111, k) for k in range(2)]
    new = [Ed25519PubKey(p) for p in signer.pubs(seeds)]
    chain.seed_of.update((pk.address(), s) for pk, s in zip(new, seeds))
    first = chain.doc.validators[0].pub_key
    keys = [(new[0], EXEC_POWER), (first, 2 * EXEC_POWER),
            (new[1], EXEC_POWER)]
    return {h: make_val_set_change_tx("ed25519", pk.bytes(), power)
            for h, (pk, power) in zip(EXEC_UPDATES, keys)}


@contextlib.contextmanager
def _exec_split():
    """The parts of each height while the block runs: the executor's
    create_proposal_block and process_proposal, validate_block (in
    apply_block), FinalizeBlock in the app, the state store's save of the
    FinalizeBlock responses and of the state, the block store's
    save_block; one entry a call."""
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.state import execution
    from cometbft_tpu_torch.state.store import Store
    from cometbft_tpu_torch.store import BlockStore
    executor = execution.BlockExecutor
    with _async_timed(executor, "create_proposal_block") as propose, \
            _async_timed(executor, "process_proposal") as process, \
            _timed(execution, "validate_block") as val, \
            _async_timed(KVStoreApplication, "finalize_block") as fin, \
            _timed(Store, "save_finalize_block_response") as fbr_save, \
            _timed(Store, "save") as state_save, \
            _timed(BlockStore, "save_block") as block_save:
        yield {"propose": propose, "process_proposal": process,
               "validate_block": val, "finalize_block": fin,
               "responses_save": fbr_save, "state_store_save": state_save,
               "block_store_save": block_save}


def _split_ms(split, i, total_s, batch_ns=0):
    """Height i's split (ms): validate_block as its walk and its
    batch_verify span, the other parts, and the rest of total_s."""
    out = {k: v[i] * 1e3 for k, v in split.items()}
    out["walk"] = out["validate_block"] - batch_ns / 1e6
    out["batch_verify"] = batch_ns / 1e6
    out["rest"] = total_s * 1e3 - sum(out[k] for k in split)
    return out


def _split_line(rows) -> str:
    keys = ("propose", "process_proposal", "walk", "batch_verify",
            "finalize_block", "responses_save", "state_store_save",
            "block_store_save", "rest")
    return "; ".join(f"{k} {_p50_p90([r[k] for r in rows])}" for k in keys)


def _exec_chain(seed, card, signer, ek, tracing, device):
    """11a: the 150-validator chain; returns (chain, B1 launches)."""
    from cometbft_tpu_torch.crypto.encoding import pub_key_from_type_and_bytes
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    n, top = EXEC_VALIDATORS, EXEC_HEIGHTS
    _phase(f"11a chain-{n}x{top}: {n} validators, {top} heights of "
           f"{EXEC_TXS} txs of {EXEC_TX_BYTES} bytes through the block "
           f"executor and the kvstore app; val= txs at {EXEC_UPDATES}")
    t0 = time.perf_counter()
    chain = _ExecChain(EXEC_CHAIN_ID, [_seed(seed + 110, i)
                                       for i in range(n)], signer,
                       device=device)
    chain.updates = updates = _exec_updates(seed, chain, signer)
    genesis_ms = (time.perf_counter() - t0) * 1e3
    host_s, lanes_want, profiled = {}, [], []

    def heights(lo, hi):
        for h in range(lo, hi):
            if h > 1:
                lanes_want.append(chain.state.last_validators.size())
            host_s[h] = chain.step(_exec_txs(seed, h, updates))[1]

    prof_lo = max(top - EXEC_PROFILED + 1, 2)
    ek.launches = 0
    tracing.clear()
    with _exec_split() as split, _launch_log(ek) as buckets, \
            _gc_pauses() as pauses:
        heights(1, prof_lo)
        profiled.append(_device_busy(lambda: heights(prof_lo, top + 1)))
    launches = ek.launches
    spans = tracing.snapshot(category=tracing.CRYPTO)
    batch = [ev for ev in spans if ev["name"] == "batch_verify"]
    lanes = [ev["attrs"]["batch"] for ev in batch]
    if launches != top - 1 or lanes != lanes_want:
        raise AssertionError(f"{top} heights launched B1 {launches} times "
                             f"with lanes {lanes}, expected {top - 1} "
                             f"launches with lanes {lanes_want}")
    rows = [_split_ms(split, h - 1, host_s[h], batch[h - 2]["dur_ns"])
            for h in range(2, top + 1)]
    ms = [host_s[h] * 1e3 for h in range(2, top + 1)]
    # the gates: the stores, the app and the run agree
    loaded = chain.state_store.load()
    info = chain.info()
    fbr = chain.state_store.load_finalize_block_response(top)
    app_vals = ValidatorSet([
        Validator.new(pub_key_from_type_and_bytes(u.pub_key_type,
                                                  u.pub_key_bytes), u.power)
        for u in chain.app.get_validators()])
    if loaded.bytes() != chain.state.bytes() or \
            loaded.last_block_height != top or \
            not loaded.app_hash or \
            loaded.app_hash != info.last_block_app_hash or \
            loaded.app_hash != fbr.app_hash or \
            info.last_block_height != top or \
            loaded.validators.hash() != app_vals.hash() or \
            loaded.validators.size() != n + 2:
        raise AssertionError("the final state disagrees with the run")
    for h in range(1, top + 1):
        if chain.block_store.load_block(h).hash() != chain.applied[h]:
            raise AssertionError(f"load_block({h}) != the applied block")
    window_ms, busy_ms, kernel_ms, events = profiled[0]
    busy = "not measured (no device event)" if busy_ms is None else (
        f"{busy_ms:.2f} ms busy of {window_ms:.1f} ms, idle share "
        f"{1 - busy_ms / window_ms:.4f}, kernel {kernel_ms:.2f} ms, "
        f"{events} device events")
    _log(f"chain_{n}x{top} ms a height (heights 2-{top}, signing "
         f"excluded) {_p50_p90(ms)}; heights a second "
         f"{(top - 1) / (sum(ms) / 1e3):.2f}; genesis and InitChain "
         f"{genesis_ms:.0f} ms; card: {card}")
    _log(f"chain_{n}x{top} split ms (p50, p90): {_split_line(rows)}")
    _log(f"chain_{n}x{top} B1 launches {launches} (one a height from 2), "
         f"lanes a launch {sorted(set(lanes))} (the commit follows "
         f"state.last_validators: {lanes_want[0]} -> {lanes_want[-1]}), "
         f"buckets {sorted(set(buckets))}; parts a block "
         f"{sorted(set(chain.parts.values()))}; final set "
         f"{loaded.validators.size()} validators, app hash "
         f"{loaded.app_hash.hex()[:16]}")
    _log(f"chain_{n}x{top} device over heights {prof_lo}-{top} "
         f"(torch.profiler): {busy}; gc in the window: "
         f"{_gc_line(pauses)}; signing {signer.signed} signatures "
         f"{signer.seconds:.1f} s, outside the timed work")
    return chain, launches


def _exec_replay(seed, card, signer, chain, ek, device):
    """11b: the Handshaker replays the chain into a fresh app; then 11a's
    first heights and their replay on SQLiteDB stores."""
    import tempfile

    from cometbft_tpu_torch.abci.client import AppConns
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.consensus.replay import Handshaker
    from cometbft_tpu_torch.db import MemDB, SQLiteDB
    top = EXEC_HEIGHTS
    _phase(f"11b replay-{EXEC_VALIDATORS}x{top}: the Handshaker replays "
           f"heights 1-{top} into a fresh kvstore app")

    def replay(ch, app_db):
        final = ch.state_store.load()
        conns = AppConns(KVStoreApplication(db=app_db))
        hs = Handshaker(ch.state_store, final, ch.block_store, ch.doc,
                        device=device)
        ek.launches = 0
        t0 = time.perf_counter()
        app_hash = asyncio.run(hs.handshake(conns))
        ms = (time.perf_counter() - t0) * 1e3
        info = ch.info(conns)
        height = final.last_block_height
        if app_hash != final.app_hash or hs.n_blocks != height or \
                info.last_block_height != height or \
                info.last_block_app_hash != final.app_hash or ek.launches:
            raise AssertionError(f"the replay of {height} heights ended at "
                                 f"{info.last_block_height} after "
                                 f"{hs.n_blocks} blocks")
        synced = Handshaker(ch.state_store, final, ch.block_store, ch.doc,
                            device=device)
        if asyncio.run(synced.handshake(conns)) != final.app_hash or \
                synced.n_blocks:
            raise AssertionError("the synced app replayed blocks")
        return ms, hs.n_blocks

    ms, n_blocks = replay(chain, MemDB())
    _log(f"replay_{EXEC_VALIDATORS}x{top} total ms {ms:.1f}, ms a block "
         f"{ms / n_blocks:.2f}, n_blocks {n_blocks}; the app hash equals "
         f"the final state's and Info reports height {top}; the app-synced "
         f"handshake replays 0 blocks; 0 launches; card: {card}")

    k = EXEC_SQLITE_HEIGHTS
    with tempfile.TemporaryDirectory() as d:
        dbs = {name: SQLiteDB(os.path.join(d, f"{name}.db"))
               for name in ("state", "block", "app", "app2")}
        try:
            sql = _ExecChain(EXEC_CHAIN_ID, [_seed(seed + 110, i) for i in
                                             range(EXEC_VALIDATORS)],
                             signer, dbs=dbs, device=device,
                             sig_cache=chain.sig_cache)
            sql.seed_of.update(chain.seed_of)
            host = [sql.step(_exec_txs(seed, h, chain.updates))[1] * 1e3
                    for h in range(1, k + 1)]
            if any(sql.applied[h] != chain.applied[h]
                   for h in range(1, k + 1)):
                raise AssertionError("the SQLite chain made other blocks")
            sql_ms, sql_blocks = replay(sql, dbs["app2"])
        finally:
            for db in dbs.values():
                db.close()
    _log(f"sqlite chain ms a height (heights 2-{k}) {_p50_p90(host[1:])}; "
         f"the same block hashes as on MemDB; replay of {sql_blocks} "
         f"heights {sql_ms:.1f} ms, {sql_ms / sql_blocks:.2f} ms a block; "
         f"card: {card}")


def _exec_block10k(seed, card, signer, keys10k, ek, ek8, oe, tracing,
                   device):
    """11c: a block whose LastCommit holds phase 3's 10,000 precommits,
    applied under B1 and under cuda8; returns the two kernels' launches."""
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    n = len(keys10k)
    want = len(tile_plan(n, DEFAULT_TILE))
    name = f"block_{n // 1000}k" if n >= 1000 else f"block_{n}"
    _phase(f"11c {name}: genesis of phase 3's {n} keys, block 1, "
           f"then block 2 whose LastCommit holds {n} precommits, under B1 "
           f"and under {oe.KERNEL_ENV}=cuda8")
    seeds = [_seed(seed, j) for j in range(n)]
    pubs = [pk.bytes() for pk in keys10k]
    cache, out = {}, {}
    for kernel, mod in (("cuda", ek), ("cuda8", ek8)):
        t0 = time.perf_counter()
        chain = _ExecChain("exec-10k", seeds, signer, pubs=pubs,
                           device=device, sig_cache=cache)
        chain.step(_exec_txs(seed, 1, {}))
        setup_ms = (time.perf_counter() - t0) * 1e3
        if kernel == "cuda8":
            os.environ[oe.KERNEL_ENV] = "cuda8"
        ek.launches = ek8.launches = 0
        tracing.clear()
        try:
            with _exec_split() as split, _launch_log(mod) as buckets, \
                    _gc_pauses() as pauses:
                block, host_s = chain.step(_exec_txs(seed, 2, {}))
        finally:
            os.environ.pop(oe.KERNEL_ENV, None)
        spans = tracing.snapshot(category=tracing.CRYPTO)
        batch_ns = sum(ev["dur_ns"] for ev in spans
                       if ev["name"] == "batch_verify")
        tiles = [ev["attrs"]["batch"] for ev in spans
                 if ev["name"] == "kernel_execute"]
        other = ek.launches if mod is ek8 else ek8.launches
        if mod.launches != want or other or \
                block.last_commit.size() != n:
            raise AssertionError(f"block 2 under {kernel} launched "
                                 f"{mod.launches} (want {want}), the other "
                                 f"kernel {other}")
        row = _split_ms(split, 0, host_s, batch_ns)
        out[kernel] = (chain.state.bytes(), chain.info().last_block_app_hash,
                       mod.launches)
        _log(f"{name}[{kernel}] apply ms {host_s * 1e3:.1f} "
             f"(block 2, signing excluded): " + "; ".join(
                 f"{k} {v:.1f}" for k, v in row.items()) +
             f"; launches {mod.launches}, tiles {tiles} in buckets "
             f"{buckets}; parts a block {chain.parts[2]}; gc inside: "
             f"{_gc_line(pauses)}; genesis, InitChain and block 1 "
             f"{setup_ms:.0f} ms; card: {card}")
    if out["cuda"][:2] != out["cuda8"][:2]:
        raise AssertionError("the state after block 2 differs by kernel")
    _log(f"{name}: both kernels accept; the state after block 2 "
         f"is equal byte for byte ({len(out['cuda'][0])} bytes of "
         f"State.bytes())")
    return out["cuda"][2], out["cuda8"][2]


def _exec_reject(seed, card, chain, ek, device):
    """11d: blocks the executor must refuse on 11a's chain, each with the
    JAX package's text and nothing stored; then a Handshaker over a block
    store that lost a height.  Returns B1's launches."""
    from cometbft_tpu_torch.abci.client import AppConns
    from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
    from cometbft_tpu_torch.consensus.replay import Handshaker, ReplayError
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.state.execution import InvalidBlockError
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.store.store import _meta_key
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    n = chain.state.last_validators.size()
    _phase(f"11d exec-reject-{n}: a corrupted LastCommit signature, a wrong "
           f"app hash, a LastCommit one signature short, a proposer outside "
           f"the set, a block store missing a height")
    state, last = chain.state, chain.last_commit
    h = state.last_block_height + 1
    proposer = state.validators.get_proposer().address
    before = (chain.state_store.load().bytes(), chain.block_store.height,
              chain.info().last_block_height)

    def corrupt(commit, i):
        sigs = list(commit.signatures)
        cs = sigs[i]
        sigs[i] = CommitSig(cs.block_id_flag, cs.validator_address,
                            cs.timestamp,
                            bytes([cs.signature[0] ^ 1]) + cs.signature[1:])
        return Commit(commit.height, commit.round, commit.block_id, sigs)

    short = Commit(last.height, last.round, last.block_id,
                   last.signatures[:-1])
    outsider = hashlib.sha256(b"outsider").digest()[:20]
    cases = [("corrupted signature", corrupt(last, EXEC_BAD_SIG), {},
              f"invalid LastCommit: wrong signature (#{EXEC_BAD_SIG})", 1),
             ("wrong app hash", last, {"app_hash": b"\x99" * 32},
              "wrong Block.Header.AppHash", 0),
             ("commit one short", short, {},
              f"invalid block commit size: want {n}, got {n - 1}", 0),
             ("proposer outside the set", last,
              {"proposer_address": outsider},
              f"block proposer {outsider.hex().upper()} is not a "
              f"validator", 1)]
    total = 0
    for what, commit, fields, text, want in cases:
        block = state.make_block(h, [_load_tx(seed, h, 0)], commit, [],
                                 proposer)
        for k, v in fields.items():
            setattr(block.header, k, v)
        parts = block.make_part_set()
        ek.launches = 0
        try:
            asyncio.run(chain.exec.apply_block(
                state, BlockID(block.hash(), parts.header()), block))
        except InvalidBlockError as e:
            got = str(e)
        else:
            raise AssertionError(f"{what}: the block was applied")
        after = (chain.state_store.load().bytes(), chain.block_store.height,
                 chain.info().last_block_height)
        if not got.startswith(text) or ek.launches != want or \
                after != before:
            raise AssertionError(f"{what}: {got!r} after {ek.launches} "
                                 f"launches (want {text!r}, {want})")
        total += ek.launches
        _log(f"exec_reject {what}: InvalidBlockError {got[:96]!r}; "
             f"{ek.launches} B1 launches; nothing stored")
    lost = MemDB()
    for k, v in chain.dbs["block"].iterator():
        if k != _meta_key(EXEC_MISSING):
            lost.set(k, v)
    hs = Handshaker(chain.state_store, chain.state_store.load(),
                    BlockStore(lost), chain.doc, device=device)
    try:
        asyncio.run(hs.handshake(AppConns(KVStoreApplication(db=MemDB()))))
    except ReplayError as e:
        got = str(e)
    else:
        raise AssertionError("the Handshaker replayed over a lost height")
    if got != f"block {EXEC_MISSING} missing from store" or \
            hs.n_blocks != EXEC_MISSING - 1:
        raise AssertionError(f"the lost height: {got!r} after "
                             f"{hs.n_blocks} blocks")
    _log(f"exec_reject lost height: ReplayError {got!r} after replaying "
         f"{hs.n_blocks} blocks; card: {card}")
    return total


def _exec_phases(seed, card, pool, keys10k, device=None):
    """Phases 11a-11d: the chain below consensus (types/block, part sets,
    params, genesis, the kvstore app over AppConns, the state and block
    stores, the block executor, the Handshaker), every block's LastCommit
    on B1.  Returns B1's launches by part and B2's."""
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    t_phase = time.perf_counter()
    signer = _Signer(pool)
    # the executor, the app and the Handshaker log every height at info
    logging.disable(logging.INFO)
    try:
        chain, chain_launches = _exec_chain(seed, card, signer, ek, tracing,
                                            device)
        _exec_replay(seed, card, signer, chain, ek, device)
        b1, b2 = _exec_block10k(seed, card, signer, keys10k, ek, ek8, oe,
                                tracing, device)
        reject = _exec_reject(seed, card, chain, ek, device)
    finally:
        logging.disable(logging.NOTSET)
    _log(f"phase 11 took {time.perf_counter() - t_phase:.1f} s, of which "
         f"{signer.signed} signatures {signer.seconds:.1f} s")
    return ({"chain_150x100": chain_launches, "block_10k": b1,
             "exec_reject": reject}, {"block_10k_cuda8": b2})


# -- phase 12: the consensus state machine ------------------------------------

def _golden_verify_job(item) -> bool:
    """Worker: the golden model's verdict on (pub, msg, sig)."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    return ref.verify(*item)


def _cs_twin(seed, signer, top, device):
    """11a's chain built again by a twin block executor to height ``top``
    (the same seeds, txs and validator updates): the blocks the harness
    proposes to the node.  Returns (chain, {h: the twin's State bytes
    after height h})."""
    chain = _ExecChain(EXEC_CHAIN_ID, [_seed(seed + 110, i)
                                       for i in range(EXEC_VALIDATORS)],
                       signer, device=device)
    chain.updates = updates = _exec_updates(seed, chain, signer)
    states = {}
    for h in range(1, top + 1):
        chain.step(_exec_txs(seed, h, updates))
        states[h] = chain.state.bytes()
    return chain, states


def _cs_feed(chain, heights, signer):
    """Each height of the twin as the messages its proposer and
    validators gossip: the proposal signed by the height's proposer, the
    block's parts, every validator's prevote (stamped EXEC_T0 + h s +
    500,000 + index ns) and the precommits of the stored commit, in that
    order.  Returns {h: [message]}; the signatures are made in one call
    of the signer."""
    from cometbft_tpu_torch.consensus.messages import (
        BlockPartMessage, ProposalMessage, VoteMessage)
    from cometbft_tpu_torch.types.canonical import (
        PREVOTE_TYPE, vote_sign_bytes_template)
    from cometbft_tpu_torch.types.proposal import Proposal
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import Vote
    plan, jobs = {}, []
    for h in heights:
        block = chain.block_store.load_block(h)
        block_id = chain.block_store.load_block_meta(h).block_id
        parts = block.make_part_set()
        if parts.header() != block_id.part_set_header:
            raise AssertionError(f"height {h}: the stored block does not "
                                 f"re-encode to its part set")
        vals = chain.state_store.load_validators(h)
        proposal = Proposal(height=h, round=0, pol_round=-1,
                            block_id=block_id, timestamp=block.header.time)
        make = vote_sign_bytes_template(chain.chain_id, PREVOTE_TYPE, h, 0,
                                        block_id)
        stamps = [Timestamp(EXEC_T0 + h, 500_000 + i)
                  for i in range(vals.size())]
        plan[h] = (len(jobs), proposal, parts, block_id, vals, stamps)
        jobs.append((chain.seed_of[block.header.proposer_address],
                     proposal.sign_bytes(chain.chain_id)))
        jobs += [(chain.seed_of[v.address], make(stamps[i]))
                 for i, v in enumerate(vals.validators)]
    sigs = signer.sign(jobs)
    feed = {}
    for h, (first, proposal, parts, block_id, vals, stamps) in plan.items():
        proposal.signature = sigs[first]
        prevotes = [Vote(type=PREVOTE_TYPE, height=h, round=0,
                         block_id=block_id, timestamp=stamps[i],
                         validator_address=v.address, validator_index=i,
                         signature=sigs[first + 1 + i])
                    for i, v in enumerate(vals.validators)]
        commit = chain.block_store.load_seen_commit(h)
        precommits = [commit.get_vote(i)
                      for i, sig in enumerate(commit.signatures)
                      if not sig.absent_flag()]
        feed[h] = ([ProposalMessage(proposal)] +
                   [BlockPartMessage(height=h, round=0,
                                     part=parts.get_part(i))
                    for i in range(parts.total)] +
                   [VoteMessage(v) for v in prevotes + precommits])
    return feed


class _CsNode:
    """A port ConsensusState over a kvstore app on AppConns, a Store and a
    BlockStore (MemDB unless ``dbs`` names them), a BlockExecutor that
    publishes to the node's EventBus, and a WAL at ``wal_path`` (none:
    the NilWAL).  Build it with ``await _CsNode.make(...)``: the
    Handshaker runs InitChain on a fresh app, or replays the stores into
    a fresh app on an app db that is behind."""

    @classmethod
    async def make(cls, doc, device, dbs=None, wal_path=None, config=None,
                   pv=None):
        from cometbft_tpu_torch.abci.client import AppConns
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
        from cometbft_tpu_torch.config import ConsensusConfig
        from cometbft_tpu_torch.consensus.replay import Handshaker
        from cometbft_tpu_torch.consensus.state import ConsensusState
        from cometbft_tpu_torch.consensus.wal import WAL
        from cometbft_tpu_torch.db import MemDB
        from cometbft_tpu_torch.state import make_genesis_state
        from cometbft_tpu_torch.state.execution import BlockExecutor
        from cometbft_tpu_torch.state.store import Store
        from cometbft_tpu_torch.store import BlockStore
        from cometbft_tpu_torch.types.events import EventBus
        self = cls()
        self.dbs = dbs or {"state": MemDB(), "block": MemDB(),
                           "app": MemDB()}
        self.state_store = Store(self.dbs["state"])
        self.block_store = BlockStore(self.dbs["block"])
        state = self.state_store.load()
        if state is None:
            state = make_genesis_state(doc)
            self.state_store.save(state)
        self.app = KVStoreApplication(db=self.dbs["app"])
        self.conns = AppConns(self.app)
        await Handshaker(self.state_store, state, self.block_store, doc,
                         device=device).handshake(self.conns)
        self.bus = EventBus()
        self.exec = BlockExecutor(self.state_store, self.conns.consensus,
                                  event_bus=self.bus,
                                  block_store=self.block_store,
                                  device=device)
        self.wal_path = wal_path
        self.cs = ConsensusState(
            config or ConsensusConfig(), self.state_store.load(), self.exec,
            self.block_store, priv_validator=pv, event_bus=self.bus,
            wal=WAL(wal_path) if wal_path else None, device=device)
        return self

    def round_state(self):
        """(height, round, step, prevotes of the round) of the node."""
        rs = self.cs.rs
        pv = rs.votes.prevotes(rs.round) if rs.votes is not None else None
        return (rs.height, rs.round, rs.step_name(),
                len(pv.list()) if pv is not None else 0)

    def wal_size(self) -> int:
        from cometbft_tpu_torch.consensus.wal import WAL
        return sum(os.path.getsize(f)
                   for f in WAL.group_files(self.wal_path))


async def _cs_new_block(node, sub, h, timeout_s=120.0):
    """Wait for the node's NewBlock of height h; raise the node's fatal
    error as soon as it has one."""
    deadline = time.perf_counter() + timeout_s
    while True:
        node.cs.raise_if_failed()
        if time.perf_counter() > deadline:
            raise AssertionError(f"no NewBlock for height {h} in "
                                 f"{timeout_s} s (at {node.round_state()})")
        try:
            msg = await asyncio.wait_for(sub.next(), 0.25)
        except asyncio.TimeoutError:
            continue
        if msg.data.payload["block"].header.height == h:
            return


async def _cs_until(node, pred, what, timeout_s=60.0):
    deadline = time.perf_counter() + timeout_s
    while not pred():
        node.cs.raise_if_failed()
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: not reached in {timeout_s} s "
                                 f"(at {node.round_state()})")
        await asyncio.sleep(0.001)


class _LoopGap:
    """The event loop's longest tick gap (1 ms ticks) since ``take``."""

    def __init__(self):
        self.worst = 0.0
        self.stop = False

    async def run(self):
        last = time.perf_counter()
        while not self.stop:
            await asyncio.sleep(0.001)
            now = time.perf_counter()
            self.worst = max(self.worst, now - last)
            last = now

    def take(self) -> float:
        worst, self.worst = self.worst, 0.0
        return worst


@contextlib.contextmanager
def _cs_split():
    """What the state machine spends, one list of seconds a part: the
    burst pre-verification (B1), the serial tally (VoteSet.add_vote, the
    serial host verifies inside it included), the WAL's writes and
    fsyncs, validate_block (B1 on the LastCommit), the pipelined apply
    (in the background) and the host ed25519's serial verifies."""
    from cometbft_tpu_torch.consensus import state as cs_state
    from cometbft_tpu_torch.consensus.wal import WAL
    from cometbft_tpu_torch.ops import ed25519_host as host
    from cometbft_tpu_torch.state.execution import BlockExecutor
    from cometbft_tpu_torch.types.vote_set import VoteSet
    with _async_timed(cs_state, "preverify_burst") as pre, \
            _timed(VoteSet, "add_vote") as tally, \
            _timed(WAL, "write") as wal_w, \
            _timed(WAL, "flush_and_sync") as wal_f, \
            _timed(BlockExecutor, "validate_block") as val, \
            _async_timed(BlockExecutor, "apply_verified_block") as apply, \
            _timed(host, "verify") as serial:
        yield {"preverify": pre, "tally": tally, "wal_write": wal_w,
               "wal_fsync": wal_f, "validate_block": val, "apply": apply,
               "serial_verify": serial}


_CS_SPLIT_KEYS = ("decode", "preverify", "tally", "wal_write", "wal_fsync",
                  "validate_block", "rest")


def _cs_live(seed, card, signer, ek, tracing, device, loop, wal_dir):
    """12a: a full node fed the twin's 150-validator chain as wire bytes,
    a height at a time; returns (twin, feed, node, B1 launches)."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.consensus.messages import decode_p2p, encode_p2p
    from cometbft_tpu_torch.consensus.round_state import STEP_NAMES
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.wire import encode, pb
    n, top = EXEC_VALIDATORS, CS_HEIGHTS
    _phase(f"12a consensus-{n}x{top}: a full node's ConsensusState (WAL on "
           f"disk, kvstore app, MemDB stores) fed {n} validators' proposal, "
           f"parts, prevotes and precommits as wire bytes for {top} heights")
    t0 = time.perf_counter()
    chain, twin_states = _cs_twin(seed, signer, top + 1, device)
    chain.states = twin_states
    twin_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    feed = _cs_feed(chain, range(1, top + 2), signer)
    raw = {h: [encode_p2p(m) for m in msgs] for h, msgs in feed.items()}
    feed_s = time.perf_counter() - t0
    node = loop.run_until_complete(_CsNode.make(
        chain.doc, device, wal_path=os.path.join(wal_dir, "wal")))
    sub = node.bus.subscribe("chip-smoke", EVENT_QUERY_NEW_BLOCK,
                             out_capacity=1000)
    fired = collections.Counter()
    real_fire = node.cs.ticker._on_timeout

    def fire(ti):
        fired[STEP_NAMES.get(ti.step)] += 1
        real_fire(ti)

    node.cs.ticker._on_timeout = fire
    gap = _LoopGap()

    async def start():
        await node.cs.start()
        gap.task = asyncio.ensure_future(gap.run())

    loop.run_until_complete(start())
    rows, per_launch, serial_n = {}, {}, {}

    async def drive(h):
        wal0, t0, dec = node.wal_size(), time.perf_counter(), 0.0
        gap.take()
        for msg_raw in raw[h]:
            t = time.perf_counter()
            msg = decode_p2p(msg_raw)
            dec += time.perf_counter() - t
            node.cs.send_peer(msg, CS_PEER)
        await _cs_new_block(node, sub, h)
        return (time.perf_counter() - t0, dec, node.wal_size() - wal0,
                gap.take())

    def heights(lo, hi):
        for h in range(lo, hi):
            before = {k: sum(v) for k, v in split.items()}
            l0, s0 = ek.launches, len(split["serial_verify"])
            total, dec, wal_bytes, worst = loop.run_until_complete(drive(h))
            row = {k: (sum(v) - before[k]) * 1e3 for k, v in split.items()}
            row.update(total=total * 1e3, decode=dec * 1e3,
                       wal_bytes=wal_bytes, gap=worst * 1e3)
            row["rest"] = row["total"] - sum(
                row[k] for k in _CS_SPLIT_KEYS[:-1])
            rows[h], per_launch[h] = row, ek.launches - l0
            serial_n[h] = len(split["serial_verify"]) - s0

    prof_lo = max(top - CS_TRACED + 1, 2)
    ek.launches = 0
    tracing.clear()
    with _cs_split() as split, _launch_log(ek) as buckets, \
            _gc_pauses() as pauses:
        heights(1, prof_lo)
        profiled = _device_busy(lambda: heights(prof_lo, top + 1))
    launches = ek.launches
    lanes = [ev["attrs"]["batch"]
             for ev in tracing.snapshot(category=tracing.CRYPTO)
             if ev["name"] == "batch_verify"]
    # the gates: the node stores the twin's chain, byte for byte
    for h in range(1, top + 1):
        mine, twin = node.block_store.load_block(h), \
            chain.block_store.load_block(h)
        if encode(pb.BLOCK, mine.to_proto()) != \
                encode(pb.BLOCK, twin.to_proto()) or \
                node.block_store.load_block_meta(h).block_id != \
                chain.block_store.load_block_meta(h).block_id:
            raise AssertionError(f"12a: the node's block {h} != the twin's")
    state = node.state_store.load()
    info = loop.run_until_complete(node.conns.query.info(abci.InfoRequest()))
    if state.bytes() != twin_states[top] or \
            state.last_block_height != top or \
            info.last_block_height != top or \
            info.last_block_app_hash != state.app_hash:
        raise AssertionError("12a: the node's state or app != the twin's")
    hs = range(2, top + 1)
    rounds = sum(1 for h in range(1, top + 1)
                 if node.block_store.load_seen_commit(h).round > 0)
    window_ms, busy_ms, kernel_ms, events = profiled
    busy = "not measured (no device event)" if busy_ms is None else (
        f"{busy_ms:.2f} ms busy of {window_ms:.1f} ms, idle share "
        f"{1 - busy_ms / window_ms:.4f}, kernel {kernel_ms:.2f} ms, "
        f"{events} device events")
    ms = [rows[h]["total"] for h in hs]
    _log(f"cs_{n}x{top} ms a height (first message to NewBlock, heights "
         f"2-{top}, signing excluded) {_p50_p90(ms)}; heights a second "
         f"{len(ms) / (sum(ms) / 1e3):.2f}; twin chain {twin_s:.1f} s and "
         f"feed {feed_s:.1f} s outside the window; card: {card}")
    _log(f"cs_{n}x{top} split ms (p50, p90): " + "; ".join(
        f"{k} {_p50_p90([rows[h][k] for h in hs])}"
        for k in _CS_SPLIT_KEYS) + f"; apply (background, overlaps) "
        f"{_p50_p90([rows[h]['apply'] for h in hs])}; serial host verifies "
        f"a height {_p50_p90([serial_n[h] for h in hs])} taking "
        f"{_p50_p90([rows[h]['serial_verify'] for h in hs])} ms")
    _log(f"cs_{n}x{top} B1 launches {launches} "
         f"({_p50_p90([per_launch[h] for h in hs])} a height), lanes a "
         f"launch {sorted(collections.Counter(lanes).items())}, buckets "
         f"{sorted(set(buckets))}; loop's longest stall a height ms "
         f"{_p50_p90([rows[h]['gap'] for h in hs])}, max "
         f"{max(rows[h]['gap'] for h in hs):.2f}; WAL bytes a height "
         f"{_p50_p90([rows[h]['wal_bytes'] for h in hs])}; rounds above 0: "
         f"{rounds}; timeouts fired {dict(fired)}")
    _log(f"cs_{n}x{top} device over heights {prof_lo}-{top} "
         f"(torch.profiler): {busy}; gc in the window: {_gc_line(pauses)}")
    node.gap = gap
    return chain, feed, raw, node, launches


def _cs_crash(seed, card, chain, feed, raw, node, ek, ek8, oe, device, loop):
    """12b: height top + 1's proposal, parts and 80% of its prevotes, a
    crash, and restarts on the same stores: under cuda8 and from a
    repaired torn copy of the WAL (both replayed only), then the real
    restart, which commits the twin's block.  Returns (B1 launches, B2
    launches)."""
    import shutil

    from cometbft_tpu_torch.consensus.replay import catchup_replay
    from cometbft_tpu_torch.consensus.wal import WAL, repair_wal_file
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.wire import encode, pb
    from cometbft_tpu_torch.consensus.messages import (
        BlockPartMessage, decode_p2p)
    h = CS_HEIGHTS + 1
    nv = chain.state_store.load_validators(h).size()
    n_parts = sum(isinstance(m, BlockPartMessage) for m in feed[h])
    first = 1 + n_parts + int(CS_CRASH_SHARE * nv)
    _phase(f"12b wal-replay-{nv}: height {h}'s proposal, parts and "
           f"{first - 1 - n_parts} of {nv} prevotes, a crash "
           f"(stop(drain_pipeline=False)), restarts on the same stores")
    for msg_raw in raw[h][:first]:
        node.cs.send_peer(decode_p2p(msg_raw), CS_PEER)
    want = first - 1 - n_parts
    loop.run_until_complete(_cs_until(
        node, lambda: node.round_state()[0] == h and
        node.round_state()[3] == want, f"{want} prevotes at {h}"))
    before = node.round_state()
    node.gap.stop = True
    loop.run_until_complete(node.cs.stop(drain_pipeline=False))
    wal_path = node.wal_path
    wal_bytes = node.wal_size()

    def copy_group(dst):
        """The WAL's group (rotated files and head) under another name."""
        for f in WAL.group_files(wal_path):
            shutil.copy(f, dst + f[len(wal_path):])
        return dst

    torn = copy_group(os.path.join(os.path.dirname(wal_path), "torn"))
    with open(torn, "ab") as f:
        f.write(b"\x00\x00\x00\x07\x00\x00\x01\x00{\"type\"")  # half a frame
    copy8 = copy_group(os.path.join(os.path.dirname(wal_path), "cuda8"))

    async def replay_only(path):
        restarted = await _CsNode.make(chain.doc, device, dbs=node.dbs)
        n = await catchup_replay(restarted.cs, path)
        restarted.cs.ticker.stop()
        return restarted.round_state(), n

    # cuda8: the restore and the replay on B2
    _clear_memos()
    os.environ[oe.KERNEL_ENV] = "cuda8"
    ek8.launches = 0
    l1 = ek.launches
    try:
        got8, n8 = loop.run_until_complete(replay_only(copy8))
    finally:
        del os.environ[oe.KERNEL_ENV]
    b2 = ek8.launches
    if got8 != before or ek.launches != l1 or b2 < 1:
        raise AssertionError(f"12b cuda8 restart: {got8} != {before}, or "
                             f"B1 {ek.launches - l1} / B2 {b2} launches")
    # the torn tail, repaired, replays the same
    _clear_memos()
    dropped = repair_wal_file(torn)
    got_torn, n_torn = loop.run_until_complete(replay_only(torn))
    if got_torn != before or n_torn != n8 or dropped != 15:
        raise AssertionError(f"12b torn WAL: {got_torn} after {n_torn} "
                             f"messages, {dropped} bytes dropped")
    # the real restart
    from cometbft_tpu_torch.libs import tracing
    _clear_memos()
    ek.launches = 0
    tracing.clear()
    t0 = time.perf_counter()
    node2 = loop.run_until_complete(_CsNode.make(
        chain.doc, device, dbs=node.dbs, wal_path=wal_path))
    restore_ms = (time.perf_counter() - t0) * 1e3
    restore_launches = ek.launches
    t0 = time.perf_counter()
    n = loop.run_until_complete(catchup_replay(node2.cs, wal_path))
    replay_ms = (time.perf_counter() - t0) * 1e3
    launches = ek.launches
    lanes = [ev["attrs"]["batch"]
             for ev in tracing.snapshot(category=tracing.CRYPTO)
             if ev["name"] == "batch_verify"]
    after = node2.round_state()
    if after != before:
        raise AssertionError(f"12b: restored {after} != {before} at the "
                             f"crash")
    sub = node2.bus.subscribe("chip-smoke-12b", EVENT_QUERY_NEW_BLOCK)

    async def resume():
        await node2.cs.start()
        for msg_raw in raw[h][first:]:
            node2.cs.send_peer(decode_p2p(msg_raw), CS_PEER)
        await _cs_new_block(node2, sub, h)
        await node2.cs.stop()

    t0 = time.perf_counter()
    loop.run_until_complete(resume())
    resume_ms = (time.perf_counter() - t0) * 1e3
    if encode(pb.BLOCK, node2.block_store.load_block(h).to_proto()) != \
            encode(pb.BLOCK, chain.block_store.load_block(h).to_proto()):
        raise AssertionError(f"12b: the resumed node's block {h} != the "
                             f"twin's")
    _log(f"wal_replay_{nv} crash at {before}; WAL {wal_bytes} bytes; "
         f"restart: stores and last-commit restore {restore_ms:.1f} ms "
         f"({restore_launches} B1 launches), catchup_replay {replay_ms:.1f} "
         f"ms for {n} messages ({launches - restore_launches} B1 launches; "
         f"lanes in order {lanes}); restored {after}; the rest of height "
         f"{h} to NewBlock {resume_ms:.1f} ms; the twin's block {h} "
         f"stored; card: {card}")
    _log(f"wal_replay_{nv} cuda8 restart replayed {n8} messages to {got8} "
         f"with {b2} B2 launches and no B1; a torn copy lost {dropped} bytes "
         f"to repair_wal_file and replayed {n_torn} messages to the same "
         f"round state")
    return launches, b2, node2


def _net_doc(seed, n, chain_id):
    """A genesis of n equal-power validators whose keys come from seed,
    and their MockPVs."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.priv_validator import MockPV
    from cometbft_tpu_torch.types.timestamp import Timestamp
    pvs = [MockPV(Ed25519PrivKey(_seed(seed, i))) for i in range(n)]
    doc = GenesisDoc(chain_id=chain_id, genesis_time=Timestamp(EXEC_T0, 0),
                     validators=[GenesisValidator(b"", pv.get_pub_key(), 10)
                                 for pv in pvs])
    return doc, pvs


async def _net_run(doc, pvs, device, heights, timeout_s=120.0):
    """Four validators wired full-mesh in process, every message through
    encode_p2p / decode_p2p; returns (nodes, NewBlock seconds of node 0)."""
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.consensus.messages import (
        BlockPartMessage, ProposalMessage, VoteMessage, decode_p2p,
        encode_p2p)
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    nodes = [await _CsNode.make(doc, device, pv=pv,
                                config=test_config().consensus)
             for pv in pvs]
    for i, node in enumerate(nodes):
        def hook(msg, i=i):
            if isinstance(msg, (ProposalMessage, BlockPartMessage,
                                VoteMessage)):
                msg_raw = encode_p2p(msg)
                for j, other in enumerate(nodes):
                    if j != i:
                        other.cs.send_peer(decode_p2p(msg_raw), f"node{i}")
        node.cs.broadcast_hooks.append(hook)
    sub = nodes[0].bus.subscribe("chip-smoke-net", EVENT_QUERY_NEW_BLOCK,
                                 out_capacity=1000)
    stamps = [time.perf_counter()]
    for node in nodes:
        await node.cs.start()
    try:
        for h in range(1, heights + 1):
            await _cs_new_block(nodes[0], sub, h, timeout_s)
            stamps.append(time.perf_counter())
        await _cs_until(nodes[0], lambda: all(
            n.block_store.height >= heights for n in nodes),
            "every node at the last height")
    finally:
        for node in nodes:
            await node.cs.stop()
    return nodes, stamps


def _cs_net(seed, card, ek, device, loop):
    """12c: BASELINE.json config 1, four validators with the kvstore app
    and the JAX package's test_config timeouts; returns (B1 launches, ms
    a height)."""
    from cometbft_tpu_torch.ops import ed25519_host as host
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.wire import encode, pb
    n, top = NET_VALIDATORS, NET_HEIGHTS
    _phase(f"12c net-{n}x{top}: {n} validators, full mesh through the wire "
           f"codec, kvstore app, test_config timeouts, {top} heights")
    doc, pvs = _net_doc(seed + 120, n, "net-chip")
    _clear_memos()
    ek.launches = 0
    with _timed(host, "sign") as signs, _timed(host, "verify") as verifies, \
            _gc_pauses() as pauses:
        nodes, stamps = loop.run_until_complete(_net_run(doc, pvs, device,
                                                         top))
    launches = ek.launches
    ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    total_s = stamps[-1] - stamps[1]
    # the gates: the four stores agree, and every commit verifies
    for h in range(1, top + 1):
        blocks = {encode(pb.BLOCK, node.block_store.load_block(h).to_proto())
                  for node in nodes}
        if len(blocks) != 1:
            raise AssertionError(f"12c: the nodes' blocks at {h} differ")
    store = nodes[0].block_store
    rounds = 0
    for h in range(1, top + 1):
        commit = store.load_block(h + 1).last_commit if h < top else \
            store.load_seen_commit(h)
        rounds += commit.round > 0
        validation.verify_commit(
            doc.chain_id, nodes[0].state_store.load_validators(h),
            store.load_block_meta(h).block_id, h, commit, device=device)
    _log(f"net_{n}x{top} heights a second {(top - 1) / total_s:.2f}; ms a "
         f"height (NewBlock to NewBlock on node 0, heights 2-{top}) "
         f"{_p50_p90(ms)}; B1 launches {launches} ({launches / top:.1f} a "
         f"height); native signs {len(signs)} ({len(signs) / top:.1f} a "
         f"height, {_p50_p90([s * 1e6 for s in signs])} us each); serial "
         f"native verifies {len(verifies)} ({len(verifies) / top:.1f} a "
         f"height, {_p50_p90([s * 1e6 for s in verifies])} us each); "
         f"rounds above 0: {rounds}; gc in the run: {_gc_line(pauses)}; "
         f"four stores agree at every height, every commit verifies; "
         f"card: {card}")
    return launches, ms


def _cs_host(seed, card, pool, chain, feed):
    """12d: the host ed25519 held byte for byte to the golden model, its
    timings, and the tally's serial cost on a VoteBatchMessage."""
    import numpy as np

    from cometbft_tpu_torch.consensus.messages import (
        VoteBatchMessage, decode_p2p, encode_p2p)
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.ops import ed25519_host as host
    from cometbft_tpu_torch.types.canonical import PREVOTE_TYPE
    from cometbft_tpu_torch.types.vote_set import VoteSet
    _phase(f"12d ed25519-host: {HOST_INPUTS} seeded signatures and the "
           f"ZIP-215 edge items against the golden model")
    rng = np.random.default_rng(seed + 130)
    jobs = [(_seed(seed + 130, i), rng.bytes(int(rng.integers(0, 300))))
            for i in range(HOST_INPUTS)]
    golden = pool.map(_sign_job, jobs, chunksize=32)
    for (s, m), (pub, sig) in zip(jobs, golden):
        if host.public_key(s) != pub or host.sign(s, pub, m) != sig or \
                not host.verify(pub, m, sig):
            raise AssertionError("12d: the host ed25519 != the golden model "
                                 f"on seed {s.hex()}")
    items = _edge_items(seed + 131, pool)
    want = pool.map(_golden_verify_job, items, chunksize=32)
    got = [host.verify(*it) for it in items]
    if got != want:
        bad = [i for i, (a, b) in enumerate(zip(got, want)) if a != b]
        raise AssertionError(f"12d: host verify != golden on edge items "
                             f"{bad[:8]}")
    (s, m), (pub, sig) = jobs[0], golden[0]
    sign_us, verify_us = [], []
    for _ in range(HOST_TIMED):
        t = time.perf_counter()
        host.sign(s, pub, m)
        sign_us.append((time.perf_counter() - t) * 1e6)
        t = time.perf_counter()
        host.verify(pub, m, sig)
        verify_us.append((time.perf_counter() - t) * 1e6)
    gold_sign, gold_verify = [], []
    for _ in range(5):
        t = time.perf_counter()
        ref.sign(s, m)
        gold_sign.append((time.perf_counter() - t) * 1e3)
        t = time.perf_counter()
        ref.verify(pub, m, sig)
        gold_verify.append((time.perf_counter() - t) * 1e3)
    # the tally's serial cost: a VoteBatchMessage is not pre-verified
    h = max(feed)
    prevotes = [msg.vote for msg in feed[h]
                if getattr(msg, "vote", None) is not None and
                msg.vote.type == PREVOTE_TYPE]
    batch = decode_p2p(encode_p2p(VoteBatchMessage(prevotes)))
    _clear_memos()
    vote_us = []
    vs = VoteSet(chain.chain_id, h, 0, PREVOTE_TYPE,
                 chain.state_store.load_validators(h))
    for v in batch.votes:
        t = time.perf_counter()
        if not vs.add_vote(v):
            raise AssertionError("12d: a batch vote was not added")
        vote_us.append((time.perf_counter() - t) * 1e6)
    _log(f"ed25519_host {HOST_INPUTS} seeded keys, signatures and verdicts "
         f"and {len(items)} edge items == golden model; sign us "
         f"{_p50_p90(sign_us)}, verify us {_p50_p90(verify_us)} "
         f"({HOST_TIMED} calls, one thread); golden model sign ms "
         f"{_p50_p90(gold_sign)}, verify ms {_p50_p90(gold_verify)}; card's "
         f"host: {card}")
    _log(f"tally_serial a VoteBatchMessage of {len(vote_us)} prevotes into "
         f"a VoteSet, memos cleared: us a vote {_p50_p90(vote_us)}, "
         f"{sum(vote_us) / 1e3:.2f} ms in all")


def _cs_reject(seed, card, chain, feed, node2, signer, ek, device, loop,
               wal_dir):
    """12e: what the state machine must refuse, each with the JAX
    package's text or outcome, and a kernel that raises inside the
    receive routine, which must stop consensus and not be restarted."""
    import dataclasses

    from cometbft_tpu_torch.consensus.messages import (
        BlockPartMessage, ProposalMessage)
    from cometbft_tpu_torch.consensus.replay import (
        ReplayError, catchup_replay)
    from cometbft_tpu_torch.consensus.state import ConsensusError
    from cometbft_tpu_torch.consensus.wal import WAL
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.canonical import PREVOTE_TYPE
    from cometbft_tpu_torch.types.timestamp import Timestamp
    _phase("12e cs-reject: a proposal from a non-proposer, a part with a "
           "bad proof, a conflicting vote, two WALs catchup_replay refuses, "
           "a kernel that raises in the receive routine")
    out = []
    node = loop.run_until_complete(_CsNode.make(chain.doc, device))
    cs = node.cs
    proposal = feed[1][0].proposal
    vals = chain.state_store.load_validators(1)
    other = next(v for v in vals.validators
                 if v.address != vals.get_proposer().address)
    forged = dataclasses.replace(proposal)
    forged.signature = signer.sign([(chain.seed_of[other.address],
                                     forged.sign_bytes(chain.chain_id))])[0]
    try:
        cs._set_proposal(forged, Timestamp.now())
        raise AssertionError("12e: a non-proposer's proposal was accepted")
    except ConsensusError as e:
        if str(e) != "invalid proposal signature":
            raise
        out.append(f"non-proposer proposal: ConsensusError {str(e)!r}")
    cs._set_proposal(proposal, Timestamp.now())
    part = feed[1][1].part
    bad = dataclasses.replace(part, bytes_=bytes([part.bytes_[0] ^ 1]) +
                              part.bytes_[1:])
    added = loop.run_until_complete(cs._add_proposal_block_part(
        BlockPartMessage(height=1, round=0, part=bad), "peer"))
    dropped = cs.metrics.block_gossip_parts_received.with_labels(
        "false").value
    if added or dropped != 1 or cs.rs.proposal_block_parts.count != 0:
        raise AssertionError("12e: a part with a bad proof was not dropped")
    out.append("bad-proof part: dropped (added False, "
               "block_gossip_parts_received{matches_current=false} 1)")
    v0 = next(m.vote for m in feed[1] if getattr(m, "vote", None) is not None
              and m.vote.type == PREVOTE_TYPE)
    twin_vote = dataclasses.replace(v0, block_id=BlockID())
    twin_vote.signature = signer.sign([(
        chain.seed_of[v0.validator_address],
        twin_vote.sign_bytes(chain.chain_id))])[0]
    first = loop.run_until_complete(cs._try_add_vote(v0, "peer"))
    second = loop.run_until_complete(cs._try_add_vote(twin_vote, "peer"))
    kept = cs.rs.votes.prevotes(0).get_by_index(v0.validator_index)
    if not first or second or kept.block_id != v0.block_id:
        raise AssertionError("12e: a conflicting vote was not refused")
    out.append("conflicting prevote: refused (tryAddVote False, the first "
               "vote kept)")
    cs.ticker.stop()
    # the two WALs catchup_replay refuses
    bad_end = os.path.join(wal_dir, "wal-end-current")
    w = WAL(bad_end)
    w.write_end_height(1)
    w.close()
    try:
        loop.run_until_complete(catchup_replay(cs, bad_end))
        raise AssertionError("12e: a WAL ending the current height replayed")
    except ReplayError as e:
        if str(e) != "WAL should not contain end-height for 1":
            raise
        out.append(f"WAL with end-height 1 at height 1: ReplayError "
                   f"{str(e)!r}")
    fresh = loop.run_until_complete(_CsNode.make(chain.doc, device,
                                                 dbs=node2.dbs))
    h = fresh.cs.rs.height
    no_end = os.path.join(wal_dir, "wal-no-end")
    w = WAL(no_end)
    w.write_end_height(h - 2)
    w.write(feed[1][0].to_wal())
    w.close()
    try:
        loop.run_until_complete(catchup_replay(fresh.cs, no_end))
        raise AssertionError("12e: a WAL without the end-height replayed")
    except ReplayError as e:
        if str(e) != (f"cannot replay height {h}: WAL has no end-height "
                      f"marker for {h - 1}"):
            raise
        out.append(f"WAL without end-height {h - 1} at height {h}: "
                   f"ReplayError {str(e)!r}")
    # a kernel that raises inside the receive routine: the stand-in is
    # not a launch, so it adds nothing to the counts
    launches = ek.launches
    real = ek.verify_cols

    def raising(*a, **kw):
        raise RuntimeError("stand-in kernel failure (12e)")

    ek.verify_cols = raising
    _clear_memos()
    try:
        victim = loop.run_until_complete(_CsNode.make(chain.doc, device))

        async def run():
            from cometbft_tpu_torch.consensus.messages import VoteMessage
            await victim.cs.start()
            for msg in feed[1]:
                if isinstance(msg, (ProposalMessage, BlockPartMessage,
                                    VoteMessage)):
                    victim.cs.send_peer(msg, CS_PEER)
            deadline = time.perf_counter() + 30
            while victim.cs.failure is None and \
                    time.perf_counter() < deadline:
                await asyncio.sleep(0.01)
            try:
                await victim.cs.stop()
            except RuntimeError as e:
                return e
            return None

        err = loop.run_until_complete(run())
    finally:
        ek.verify_cols = real
    task = victim.cs._task
    if err is None or "stand-in kernel failure" not in str(err) or \
            task.restarts != 0 or not task.gave_up or \
            victim.block_store.height != 0:
        raise AssertionError(f"12e: the raising kernel was hidden: {err!r}, "
                             f"{task.restarts} restarts")
    out.append(f"raising kernel in the receive routine: consensus stopped, "
               f"0 restarts, stop() raised RuntimeError {str(err)!r}")
    for line in out:
        _log(f"cs_reject {line}")
    _log(f"cs_reject all {len(out)} cases as the JAX package decides them; "
         f"card: {card}")
    return ek.launches - launches


def _cs_phases(seed, card, pool, device=None, keep=None):
    """Phases 12a-12e: the consensus state machine (ConsensusState with
    its round state, ticker, timeouts and supervisor, every consensus
    message, EventBus, the WAL and catch-up, the host ed25519).  Returns
    B1's launches by part and B2's; fills ``keep`` with what phase 13
    reads: the twin chain (its states at ``chain.states``), the stores
    12b's resumed node leaves and 12c's ms a height."""
    import shutil
    import tempfile

    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_host as host
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    t_phase = time.perf_counter()
    signer = _Signer(pool)
    from cometbft_tpu_torch.ops import _build
    host.load()
    info = _build.ed25519_host_build_info
    _log(f"ed25519_host library {info['path']} (g++ {info['seconds']:.3f} "
         f"s, cached={info['cached']}); self-test passed in "
         f"{info['selftest_seconds'] * 1e3:.1f} ms")
    wal_dir = tempfile.mkdtemp(prefix="chip-smoke-wal-")
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        chain, feed, raw, node, live = _cs_live(
            seed, card, signer, ek, tracing, device, loop, wal_dir)
        crash, crash8, node2 = _cs_crash(seed, card, chain, feed, raw, node,
                                         ek, ek8, oe, device, loop)
        net, net_ms = _cs_net(seed, card, ek, device, loop)
        _cs_host(seed, card, pool, chain, feed)
        reject = _cs_reject(seed, card, chain, feed, node2, signer, ek,
                            device, loop, wal_dir)
        if keep is not None:
            keep.update(chain=chain, dbs=node2.dbs, net_ms=net_ms)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
        shutil.rmtree(wal_dir, ignore_errors=True)
    _log(f"phase 12 took {time.perf_counter() - t_phase:.1f} s, of which "
         f"{signer.signed} signatures {signer.seconds:.1f} s")
    return ({f"cs_{EXEC_VALIDATORS}x{CS_HEIGHTS}": live,
             f"wal_replay_{EXEC_VALIDATORS}": crash,
             f"net_{NET_VALIDATORS}x{NET_HEIGHTS}": net,
             "cs_reject": reject},
            {f"wal_replay_{EXEC_VALIDATORS}_cuda8": crash8})


# -- phase 13: p2p and the consensus reactor ----------------------------------

def _p2p_metrics_bytes(switches, family):
    """{channel: bytes} summed over the switches' p2p metrics."""
    out = collections.Counter()
    for sw in switches:
        fam = getattr(sw.metrics, family)
        for ch in ("0x20", "0x21", "0x22", "0x23"):
            out[ch] += fam.with_labels(ch).value
    return out


async def _sock_node(doc, device, key_seed, pv=None, config=None, dbs=None):
    """A _CsNode with a Switch on 127.0.0.1 (port 0), a ConsensusReactor
    and a node key made from ``key_seed``."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
    from cometbft_tpu_torch.p2p import NodeKey, Switch
    node = await _CsNode.make(doc, device, dbs=dbs, config=config, pv=pv)
    node.switch = Switch(NodeKey(Ed25519PrivKey(key_seed)), doc.chain_id,
                         listen_addr="127.0.0.1:0")
    node.reactor = ConsensusReactor(node.cs)
    node.switch.add_reactor(node.reactor)
    await node.switch.start()
    return node


async def _sock_mesh(nodes, timeout_s=30.0):
    """Dial every pair once (the lower index dials) and wait until each
    node has every other as a peer."""
    for i, node in enumerate(nodes):
        for other in nodes[i + 1:]:
            await asyncio.wait_for(
                node.switch.dial_peer(other.switch.listen_addr), timeout_s)

    async def meshed():
        while not all(n.switch.num_peers() == len(nodes) - 1
                      for n in nodes):
            await asyncio.sleep(0.005)
    await asyncio.wait_for(meshed(), timeout_s)


async def _sock_stop(nodes):
    """Stop every node's consensus, then its switch; the first consensus
    failure is re-raised after all are stopped."""
    failure = None
    for node in nodes:
        try:
            await node.cs.stop()
        except Exception as e:  # noqa: BLE001 — re-raised below
            failure = failure or e
        await node.switch.stop()
    if failure is not None:
        raise failure


def _sock_net(seed, card, ek, tracing, device, loop, net_ms):
    """13a: BASELINE.json config 1 over sockets — four validators, each
    with a Switch, a ConsensusReactor and a ConsensusState over the
    kvstore app, full mesh through the secret connection, test_config
    timeouts.  Returns B1 launches."""
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.ops import aead_host
    from cometbft_tpu_torch.ops import ed25519_host as host
    from cometbft_tpu_torch.p2p.secret_connection import SecretConnection
    from cometbft_tpu_torch.types import validation
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.wire import encode, pb
    n, top = SOCK_VALIDATORS, SOCK_HEIGHTS
    _phase(f"13a sock-{n}x{top}: {n} validators on 127.0.0.1, each a "
           f"Switch + ConsensusReactor + ConsensusState over the kvstore "
           f"app, full mesh through the secret connection, test_config "
           f"timeouts, {top} heights")
    doc, pvs = _net_doc(seed + 130, n, "sock-chip")
    _clear_memos()
    ek.launches = 0
    tracing.clear()

    async def run():
        nodes = [await _sock_node(doc, device, _seed(seed + 131, i), pv=pv,
                                  config=test_config().consensus)
                 for i, pv in enumerate(pvs)]
        try:
            with _async_timed(SecretConnection, "make") as hs:
                t0 = time.perf_counter()
                await _sock_mesh(nodes)
                mesh_s = time.perf_counter() - t0
            sub = nodes[0].bus.subscribe("chip-smoke-sock",
                                         EVENT_QUERY_NEW_BLOCK,
                                         out_capacity=1000)
            stamps = [time.perf_counter()]
            for node in nodes:
                await node.cs.start()
            for h in range(1, top + 1):
                for node in nodes:
                    node.cs.raise_if_failed()
                await _cs_new_block(nodes[0], sub, h)
                stamps.append(time.perf_counter())
            await _cs_until(nodes[0], lambda: all(
                nd.block_store.height >= top for nd in nodes),
                "every node at the last height")
        finally:
            await _sock_stop(nodes)
        return nodes, stamps, hs, mesh_s

    with _timed(aead_host.ChaCha20Poly1305, "encrypt") as seals, \
            _timed(aead_host.ChaCha20Poly1305, "decrypt") as opens, \
            _timed(host, "verify") as verifies, _gc_pauses() as pauses:
        nodes, stamps, hs, mesh_s = loop.run_until_complete(run())
    launches = ek.launches
    lanes = [ev["attrs"]["batch"]
             for ev in tracing.snapshot(category=tracing.CRYPTO)
             if ev["name"] == "batch_verify"]
    ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    total_s = stamps[-1] - stamps[1]
    # the gates: the four stores agree, and every commit verifies
    for h in range(1, top + 1):
        blocks = {encode(pb.BLOCK, node.block_store.load_block(h).to_proto())
                  for node in nodes}
        if len(blocks) != 1:
            raise AssertionError(f"13a: the nodes' blocks at {h} differ")
    store, rounds = nodes[0].block_store, 0
    l0 = ek.launches
    for h in range(1, top + 1):
        commit = store.load_block(h + 1).last_commit if h < top else \
            store.load_seen_commit(h)
        rounds += commit.round > 0
        validation.verify_commit(
            doc.chain_id, nodes[0].state_store.load_validators(h),
            store.load_block_meta(h).block_id, h, commit, device=device)
    if ek.launches - l0 < top:
        raise AssertionError("13a: a commit did not verify on B1")
    sent = _p2p_metrics_bytes([nd.switch for nd in nodes],
                              "message_send_bytes_total")
    useful = _p2p_metrics_bytes([nd.switch for nd in nodes],
                                "message_useful_bytes_total")
    _log(f"sock_{n}x{top} ms a height (NewBlock to NewBlock on node 0, "
         f"heights 2-{top}) {_p50_p90(ms)} against net_{n}x{top}'s "
         f"in-process {_p50_p90(net_ms)} in this call; heights a second "
         f"{(top - 1) / total_s:.2f}; B1 launches {launches} "
         f"({launches / top:.2f} a height), lanes a launch "
         f"{sorted(collections.Counter(lanes).items())}; serial host "
         f"verifies {len(verifies)} ({len(verifies) / top:.1f} a height); "
         f"rounds above 0: {rounds}; card: {card}")
    _log(f"sock_{n}x{top} wire bytes a height sent by the four nodes, by "
         f"channel: " + ", ".join(f"{ch} {sent[ch] / top:.0f}"
                                  for ch in sorted(sent)) +
         f" (total {sum(sent.values()) / top:.0f}); useful bytes "
         f"received a height: " + ", ".join(
             f"{ch} {useful[ch] / top:.0f}" for ch in sorted(useful)))
    _log(f"sock_{n}x{top} handshake (SecretConnection.make, both sides of "
         f"{n * (n - 1) // 2} links) ms {_p50_p90([s * 1e3 for s in hs])}, "
         f"mesh up in {mesh_s * 1e3:.1f} ms; seal {len(seals)} frames "
         f"{_p50_p90([s * 1e6 for s in seals])} us each, open {len(opens)} "
         f"{_p50_p90([s * 1e6 for s in opens])} us each (ctypes call "
         f"included); gc in the run: {_gc_line(pauses)}; four stores agree "
         f"at every height, every commit verifies on B1")
    return launches


def _sock_catchup(seed, card, ek, tracing, device, loop, keep):
    """13b: a port full node restarted with a Switch and a
    ConsensusReactor over the stores phase 12 leaves (the twin's
    150-validator chain, 12b's resumed height on top), and a fresh joiner
    from genesis with the default ConsensusConfig that dials it and
    catches up by the reactor's gossip alone.  Returns B1 launches."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.ops import ed25519_host as host
    from cometbft_tpu_torch.store import BlockStore
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.wire import encode, pb
    chain, top = keep["chain"], CATCHUP_HEIGHTS
    n = EXEC_VALIDATORS
    _phase(f"13b catchup-{n}x{top}: a full node with Switch and "
           f"ConsensusReactor over phase 12's stores; a fresh joiner "
           f"(default ConsensusConfig) dials it and catches up {top} "
           f"heights by gossip (depth cut from the chain's "
           f"{CS_HEIGHTS} to keep phase 13 inside its 60 s budget)")
    _clear_memos()
    ek.launches = 0
    tracing.clear()
    gap = _LoopGap()

    async def run():
        server = await _sock_node(chain.doc, device, _seed(seed + 132, 0),
                                  dbs=keep["dbs"])
        joiner = await _sock_node(chain.doc, device, _seed(seed + 132, 1))
        states = {}
        real_save = joiner.state_store.save

        def save(state):
            states[state.last_block_height] = state.bytes()
            real_save(state)

        joiner.state_store.save = save
        sub = joiner.bus.subscribe("chip-smoke-catchup",
                                   EVENT_QUERY_NEW_BLOCK, out_capacity=1000)
        gap_task = asyncio.ensure_future(gap.run())
        try:
            await server.cs.start()
            await joiner.cs.start()
            l0 = ek.launches
            t0 = time.perf_counter()
            await asyncio.wait_for(
                joiner.switch.dial_peer(server.switch.listen_addr), 30)
            gap.take()
            stamps, worst, per_launch = [t0], [], []
            for h in range(1, top + 1):
                server.cs.raise_if_failed()
                l1 = ek.launches
                await _cs_new_block(joiner, sub, h)
                stamps.append(time.perf_counter())
                worst.append(gap.take())
                per_launch.append(ek.launches - l1)
        finally:
            gap.stop = True
            await gap_task
            await _sock_stop([joiner, server])
        return (server, joiner, states, stamps, worst, per_launch,
                ek.launches - l0)

    with _timed(host, "verify") as verifies, _gc_pauses() as pauses, \
            _timed(BlockStore, "load_block_commit") as commit_loads, \
            _timed(BlockStore, "load_block_part") as part_loads:
        server, joiner, states, stamps, worst, per_launch, launches = \
            loop.run_until_complete(run())
    lanes = [ev["attrs"]["batch"]
             for ev in tracing.snapshot(category=tracing.CRYPTO)
             if ev["name"] == "batch_verify"]
    # the gates: the joiner stores the twin's rows, states and app hash
    for h in range(1, top + 1):
        mine, twin = joiner.block_store.load_block(h), \
            chain.block_store.load_block(h)
        if encode(pb.BLOCK, mine.to_proto()) != \
                encode(pb.BLOCK, twin.to_proto()) or \
                joiner.block_store.load_block_meta(h).block_id != \
                chain.block_store.load_block_meta(h).block_id:
            raise AssertionError(f"13b: the joiner's block {h} != the "
                                 f"twin's")
        if states.get(h) != chain.states[h]:
            raise AssertionError(f"13b: the joiner's State at {h} != the "
                                 f"twin's")
    final = joiner.state_store.load()
    info = loop.run_until_complete(joiner.conns.query.info(
        abci.InfoRequest()))
    if final.bytes() != chain.states[final.last_block_height] or \
            info.last_block_height != final.last_block_height or \
            info.last_block_app_hash != final.app_hash:
        raise AssertionError("13b: the joiner's app hash != the twin's")
    ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    sent = _p2p_metrics_bytes([server.switch], "message_send_bytes_total")
    _log(f"catchup_{n}x{top} {top} heights in {stamps[-1] - stamps[0]:.2f} "
         f"s from the dial ({top / (stamps[-1] - stamps[0]):.2f} heights a "
         f"second); ms a height (the joiner's NewBlock to NewBlock, heights "
         f"2-{top}) {_p50_p90(ms)}; B1 launches {launches} "
         f"({_p50_p90(per_launch)} a height), lanes a launch "
         f"{sorted(collections.Counter(lanes).items())}; serial host "
         f"verifies {len(verifies)} ({len(verifies) / top:.1f} a height); "
         f"card: {card}")
    _log(f"catchup_{n}x{top} wire bytes a height sent by the server, by "
         f"channel: " + ", ".join(f"{ch} {sent[ch] / top:.0f}"
                                  for ch in sorted(sent)) +
         f" (total {sum(sent.values()) / top:.0f}); the loop's longest "
         f"stall a height ms {_p50_p90([w * 1e3 for w in worst])}, max "
         f"{max(worst) * 1e3:.2f}; gc in the run: {_gc_line(pauses)}; the "
         f"server's store reads a height: load_block_commit "
         f"{len(commit_loads) / top:.1f} taking "
         f"{sum(commit_loads) * 1e3 / top:.1f} ms, load_block_part "
         f"{len(part_loads) / top:.1f} taking "
         f"{sum(part_loads) * 1e3 / top:.1f} ms; the joiner's rows, "
         f"State.bytes() and app hash equal the twin's at every height")
    return launches


def _aead_vs_plain(seed):
    """The AEAD library against its plain version on AEAD_INPUTS seeded
    (key, nonce, aad, message) inputs: seals byte-equal, opens back, a
    flipped tag bit refused by both.  Returns the number of inputs."""
    import numpy as np

    from cometbft_tpu_torch.crypto import _aead_ref
    from cometbft_tpu_torch.ops import aead_host
    rng = np.random.default_rng(seed)
    lens = list(AEAD_LENS) + [int(x) for x in rng.integers(
        0, 2100, AEAD_INPUTS - len(AEAD_LENS))]
    for i, length in enumerate(lens):
        key, nonce = rng.bytes(32), rng.bytes(12)
        aad, msg = rng.bytes(i % 24), rng.bytes(length)
        lib, plain = aead_host.ChaCha20Poly1305(key), \
            _aead_ref.ChaCha20Poly1305(key)
        sealed = lib.encrypt(nonce, msg, aad)
        if sealed != plain.encrypt(nonce, msg, aad):
            raise AssertionError(f"13c: the AEAD library's seal != its "
                                 f"plain version's (input {i}, {length} "
                                 f"bytes)")
        if lib.decrypt(nonce, sealed, aad) != msg:
            raise AssertionError(f"13c: the AEAD library did not open its "
                                 f"own seal (input {i})")
        bad = bytearray(sealed)
        bad[length + i % 16] ^= 1 << (i % 8)
        for aead, exc in ((lib, aead_host.AEADInvalidTag),
                          (plain, _aead_ref.AEADInvalidTag)):
            try:
                aead.decrypt(nonce, bytes(bad), aad)
            except exc:
                continue
            raise AssertionError(f"13c: a flipped tag bit was opened "
                                 f"(input {i})")
    return len(lens)


async def _expect_refusal(coro, exc_type, text, what):
    try:
        await asyncio.wait_for(coro, 30)
    except exc_type as e:
        if str(e) != text:
            raise AssertionError(f"13c {what}: {type(e).__name__} "
                                 f"{str(e)!r} != {text!r}")
        return f"{what}: {type(e).__name__} {str(e)!r}"
    raise AssertionError(f"13c {what}: accepted")


def _p2p_reject(seed, card, ek, device, loop):
    """13c: the AEAD library against its plain version; a tampered frame,
    a low-order X25519 key, another network and a self-dial refused with
    the JAX texts; a stand-in kernel that raises in one node's receive
    routine stops that node's consensus, surfaces and is not restarted.
    Returns B1 launches (of the three nodes that go on)."""
    import threading

    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.crypto import ed25519 as p_ed
    from cometbft_tpu_torch.crypto import pipeline
    from cometbft_tpu_torch.ops import _build, aead_host
    from cometbft_tpu_torch.p2p import NodeKey, Switch
    from cometbft_tpu_torch.p2p.secret_connection import (
        SecretConnection, SecretConnectionError)
    from cometbft_tpu_torch.p2p.switch import Reactor, SwitchError
    from cometbft_tpu_torch.p2p.conn import ChannelDescriptor
    from cometbft_tpu_torch.types import vote as vote_mod
    _phase("13c p2p-reject: the AEAD library vs its plain version, a "
           "tampered frame, a low-order X25519 key, another network, a "
           "self-dial, a kernel that raises in one node's receive routine")
    out = []
    t0 = time.perf_counter()
    n_aead = _aead_vs_plain(seed + 133)
    out.append(f"AEAD library == plain version on {n_aead} seeded inputs "
               f"(lengths {', '.join(map(str, AEAD_LENS))} among them; "
               f"seal byte-equal, open back, a flipped tag bit refused by "
               f"both) in {time.perf_counter() - t0:.2f} s; library "
               f"{_build.aead_build_info['path']}")

    class _Echo(Reactor):
        def get_channels(self):
            return [ChannelDescriptor(id=0x77)]

    async def pipe():
        got = asyncio.Queue()

        async def on_conn(r, w):
            await got.put((r, w))

        server = await asyncio.start_server(on_conn, "127.0.0.1", 0)
        cr, cw = await asyncio.open_connection(
            "127.0.0.1", server.sockets[0].getsockname()[1])
        sr, sw = await asyncio.wait_for(got.get(), 10)
        return (cr, cw), (sr, sw), server

    async def cases():
        (cr, cw), (sr, sw), server = await pipe()
        k1, k2 = p_ed.Ed25519PrivKey(_seed(seed + 134, 0)), \
            p_ed.Ed25519PrivKey(_seed(seed + 134, 1))
        sc1, sc2 = await asyncio.wait_for(asyncio.gather(
            SecretConnection.make(cr, cw, k1),
            SecretConnection.make(sr, sw, k2)), 30)
        frame = sc2._seal_chunk(b"a frame")
        sw.write(frame[:100] + bytes([frame[100] ^ 4]) + frame[101:])
        await sw.drain()
        res = [await _expect_refusal(sc1.read_msg(),
                                     aead_host.AEADInvalidTag,
                                     "authentication failed",
                                     "tampered frame")]
        sc1.close()
        sc2.close()
        server.close()
        (cr, cw), (sr, sw), server = await pipe()
        sw.write(bytes(32))               # u = 0: a low-order point
        await sw.drain()
        res.append(await _expect_refusal(
            SecretConnection.make(cr, cw, k1), SecretConnectionError,
            "x25519: low-order peer public key", "low-order X25519 key"))
        cw.close()
        sw.close()
        server.close()
        a = Switch(NodeKey(k1), "chain-a", listen_addr="127.0.0.1:0")
        b = Switch(NodeKey(k2), "chain-b", listen_addr="127.0.0.1:0")
        for sw_ in (a, b):
            sw_.add_reactor(_Echo("echo"))
            await sw_.start()
        try:
            res.append(await _expect_refusal(
                b.dial_peer(a.listen_addr), SwitchError,
                "incompatible peer: peer network 'chain-a' != 'chain-b'",
                "another network"))
            res.append(await _expect_refusal(
                a.dial_peer(a.listen_addr), SwitchError, "connected to self",
                "self-dial"))
            await asyncio.sleep(0.05)
            if a.num_peers() or b.num_peers():
                raise AssertionError("13c: a refused peer was added")
        finally:
            await a.stop()
            await b.stop()
        return res

    out += loop.run_until_complete(cases())

    # a kernel that raises, on one node of a 13a-shaped net: the victim's
    # bursts reach the stand-in (its receive routine's task is the one that
    # submits them); the other three nodes keep the real kernel
    doc, pvs = _net_doc(seed + 135, SOCK_VALIDATORS, "sock-reject")
    flag = threading.local()
    victim_task = [None]
    real_kernel = ek.verify_cols
    real_async = vote_mod.preverify_signatures_async

    def raising(*a, **kw):
        if getattr(flag, "raise_now", False):
            raise RuntimeError("stand-in kernel failure (13c)")
        return real_kernel(*a, **kw)

    def victim_preverify(entries, dev):
        flag.raise_now = True
        try:
            return vote_mod.preverify_signatures(entries, dev)
        finally:
            flag.raise_now = False

    def routed(entries, dev=None):
        if victim_task[0] is not None and \
                asyncio.current_task() is victim_task[0]:
            return pipeline.submit(victim_preverify, entries, dev)
        return real_async(entries, dev)

    async def run():
        nodes = [await _sock_node(doc, device, _seed(seed + 136, i), pv=pv,
                                  config=test_config().consensus)
                 for i, pv in enumerate(pvs)]
        victim = nodes[-1]
        try:
            await _sock_mesh(nodes)
            for node in nodes:
                await node.cs.start()
            victim_task[0] = victim.cs._task.runner
            deadline = time.perf_counter() + 60
            while victim.cs.failure is None:
                if time.perf_counter() > deadline:
                    raise AssertionError("13c: the victim never reached "
                                         "the raising kernel")
                await asyncio.sleep(0.01)
            stopped_at = victim.block_store.height
            await _cs_until(nodes[0], lambda: all(
                nd.block_store.height >= stopped_at + 3
                for nd in nodes[:-1]), "three nodes go on")
            peers = victim.switch.num_peers()
            for node in nodes[:-1]:
                node.cs.raise_if_failed()
        finally:
            err = None
            try:
                await _sock_stop(nodes)
            except RuntimeError as e:
                err = e
        return victim, stopped_at, peers, err, \
            [nd.block_store.height for nd in nodes[:-1]]

    _clear_memos()
    l0 = ek.launches
    ek.verify_cols = raising
    vote_mod.preverify_signatures_async = routed
    try:
        victim, stopped_at, peers, err, others = loop.run_until_complete(
            run())
    finally:
        ek.verify_cols = real_kernel
        vote_mod.preverify_signatures_async = real_async
    task = victim.cs._task
    if err is None or "stand-in kernel failure" not in str(err) or \
            task.restarts != 0 or not task.gave_up or \
            victim.block_store.height != stopped_at:
        raise AssertionError(f"13c: the raising kernel was hidden: {err!r}, "
                             f"{task.restarts} restarts")
    out.append(f"raising kernel on one of {SOCK_VALIDATORS} socket nodes: "
               f"its consensus stopped at height {stopped_at}, 0 restarts, "
               f"its switch kept {peers} peers, stop() raised RuntimeError "
               f"{str(err)!r}; the other three went on to heights {others}")
    for line in out:
        _log(f"p2p_reject {line}")
    _log(f"p2p_reject all {len(out)} cases as the JAX package decides them; "
         f"card: {card}")
    return ek.launches - l0


def _p2p_phases(seed, card, keep, device=None):
    """Phases 13a-13c: p2p and the consensus reactor (the secret
    connection on the host AEAD, MConnection, Switch, ConsensusReactor).
    ``keep`` holds what phase 12 leaves: the twin chain with its states,
    the restarted node's stores and 12c's ms a height.  Returns B1's
    launches by part."""
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import _build, aead_host
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    t_phase = time.perf_counter()
    aead_host.load()
    info = _build.aead_build_info
    _log(f"aead library {info['path']} (g++ {info['seconds']:.3f} s, "
         f"cached={info['cached']}); RFC 8439 self-test passed in "
         f"{info['selftest_seconds'] * 1e3:.3f} ms")
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        sock = _sock_net(seed, card, ek, tracing, device, loop,
                         keep["net_ms"])
        catchup = _sock_catchup(seed, card, ek, tracing, device, loop, keep)
        reject = _p2p_reject(seed, card, ek, device, loop)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
    _log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {f"sock_{SOCK_VALIDATORS}x{SOCK_HEIGHTS}": sock,
            f"catchup_{EXEC_VALIDATORS}x{CATCHUP_HEIGHTS}": catchup,
            "p2p_reject": reject}


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args()

    t_start = time.perf_counter()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 2

    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import pipeline
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PubKey
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    from cometbft_tpu_torch.libs import tracing
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
        report = _build.build_info["ptxas"]
        t0 = time.perf_counter()
        host = _build.load_host()
        _log(f"host_build_seconds {time.perf_counter() - t0:.3f} (g++ "
             f"{_build.host_build_info['seconds']:.3f} s for "
             f"{_build.HOST_SOURCE}, {' '.join(_build.HOST_FLAGS)}, "
             f"cached={_build.host_build_info['cached']}); os.cpu_count "
             f"{os.cpu_count()}; multi-buffer SHA-512 "
             f"{bool(host.ed25519_prep_multibuffer())}; prep threads at "
             f"3,334 / 10,000 items: {host.ed25519_prep_threads(3334)} / "
             f"{host.ed25519_prep_threads(10000)}")
        t0 = time.perf_counter()
        _build.load_bls()
        _log(f"bls_build_seconds {time.perf_counter() - t0:.3f} (g++ "
             f"{_build.bls_build_info['seconds']:.3f} s for "
             f"{_build.BLS_SOURCE}, cached="
             f"{_build.bls_build_info['cached']}); self-test passed in "
             f"{_build.bls_build_info['selftest_seconds'] * 1e3:.1f} ms")
        ripemd = hashlib.new("ripemd160", b"abc").hexdigest()
        if ripemd != RIPEMD160_ABC:
            raise AssertionError(f"ripemd160(abc) = {ripemd}")
        _log(f"hashlib ripemd160 available ({ripemd})")
        mb_ptxas = {op: _ptxas_summary(report, "mb_kernelILi%d"
                                       % list(mb.REPS).index(op))
                    for op in mb.POINT_OPS}
        infos = {name: _ptxas_summary(report, name) for name in
                 ("ed25519_verify_kernel", "ed25519_verify8_kernel")}
        infos.update((f"mb_kernel<{op}>", info)
                     for op, info in mb_ptxas.items())
        for name, info in infos.items():
            _log(f"ptxas {name}: {info.get('registers')} registers, "
                 f"{info.get('stack')} B stack, {info.get('spill_stores')} B "
                 f"spill stores, {info.get('spill_loads')} B spill loads, "
                 f"{info.get('smem')} B shared")

        # -- 2. kernel vs plain on edge-case lanes --------------------------
        _phase("2 kernel vs plain, 1024 edge-case lanes")
        items = _edge_items(args.seed, pool)
        _same_prep(oe, items, 1024, "1024 edge-case lanes")
        rng_msgs = [hashlib.sha512(b"%d" % n).digest() * (n // 64 + 1)
                    for n in EDGE_MSG_LENS]
        lens_items = [(pub, msg[:n], sig) for (pub, sig), msg, n in zip(
            pool.map(_sign_job, [(_seed(args.seed + 11, i), msg[:n])
                                 for i, (msg, n) in enumerate(
                                     zip(rng_msgs, EDGE_MSG_LENS))]),
            rng_msgs, EDGE_MSG_LENS)]
        _same_prep(oe, lens_items, 64, "message lengths "
                   f"{', '.join(map(str, EDGE_MSG_LENS))}")
        if not all(ref.verify(*it) for it in lens_items):
            raise AssertionError("an edge-length signature does not verify")
        _log(f"C prep == plain prep byte for byte on the 1024 edge-case "
             f"lanes and on messages of {', '.join(map(str, EDGE_MSG_LENS))}"
             f" bytes")
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
        # lane counts that leave a partial quad, warp or block of B1
        for m in PARTIAL_LANES:
            pa, pr, ps, pk, _ = oe.prep_arrays(items[:m], m)
            pcols = [oe.to_cols(x, dev) for x in (pa, pr, ps, pk)]
            got_m = ek.verify_cols(*pcols)
            torch.cuda.synchronize()
            plain_m = ek.verify_cols_plain(*pcols)
            if not torch.equal(got_m, plain_m):
                raise AssertionError(
                    f"kernel != plain on {int((got_m != plain_m).sum())} "
                    f"of {m} lanes")
            max_abs_err = max(max_abs_err, int(
                (got_m.int() - plain_m.int()).abs().max().item()))
        _log(f"kernel == plain at {', '.join(map(str, PARTIAL_LANES))} "
             f"lanes (partial quads, warps and blocks)")

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
        for m in PARTIAL_LANES:
            pa, pr, ps, pk, _ = oe.prep_arrays(items[:m], m)
            pcols = [oe.to_cols(x, dev) for x in (pa, pr, ps, pk)]
            got_m = ek8.verify_cols(*pcols)
            torch.cuda.synchronize()
            plain_m = ek8.verify_cols_plain(*pcols)
            if not torch.equal(got_m, plain_m):
                raise AssertionError(
                    f"B2 kernel != B2 plain on "
                    f"{int((got_m != plain_m).sum())} of {m} lanes")
            max_abs_err8 = max(max_abs_err8, int(
                (got_m.int() - plain_m.int()).abs().max().item()))
        _log(f"B2 kernel == B2 plain at "
             f"{', '.join(map(str, PARTIAL_LANES))} lanes")

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
        vote_data = _vote_data(args.seed, pool)
    # the pool is closed: nothing below forks or spawns until phase 8

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
    if pipeline.tile_size() != DEFAULT_TILE:
        raise AssertionError(f"{pipeline.TILE_ENV} is set: the main path "
                             f"must run at the default tile")
    entries = [(vals.validators[i].pub_key.bytes(),
                commit.vote_sign_bytes(CHAIN_ID, i), cs.signature)
               for i, cs in enumerate(commit.signatures)]
    for t_lo, t_hi in tile_plan(n, DEFAULT_TILE):
        _same_prep(oe, entries[t_lo:t_hi], oe._bucket(t_hi - t_lo),
                   f"the commit's entries {t_lo}..{t_hi}")
    _log(f"C prep == plain prep byte for byte on the commit's {n} entries, "
         f"tile by tile")

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
    _phase(f"4 times, {WARM_RUNS} warm runs each")

    def walk_split():
        """verify_commit's parts from the port's spans (ms): the batch,
        host prep, packing, the C pass, the kernel wait; and the overlap
        ratio the run observed."""
        ov = pipeline.overlap_histogram()
        n_ov, s_ov = ov.count, ov.sum
        tracing.clear()
        t0 = time.perf_counter()
        validation.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
        e2e_ms = (time.perf_counter() - t0) * 1e3
        ms = collections.Counter()
        for ev in tracing.snapshot(category=tracing.CRYPTO):
            ms[ev["name"]] += ev["dur_ns"] / 1e6
        if ov.count != n_ov + 1:
            raise AssertionError("verify_commit observed no overlap ratio")
        return e2e_ms, ms, ov.sum - s_ov

    validation.verify_commit(CHAIN_ID, vals, block_id, HEIGHT, commit)
    runs = [walk_split() for _ in range(WARM_RUNS)]
    e2e = [r[0] for r in runs]
    split = {name: [r[1][name] for r in runs] for name in
             ("batch_verify", "host_prep", "prep_pack", "prep_c",
              "kernel_execute")}
    split["walk"] = [r[0] - r[1]["batch_verify"] for r in runs]
    overlap = [r[2] for r in runs]

    def timed(fn):
        fn()
        out = []
        for _ in range(WARM_RUNS):
            t0 = time.perf_counter()
            fn()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    plan = tile_plan(n, DEFAULT_TILE)
    vb = timed(lambda: oe.verify_batch(entries))
    prep = timed(lambda: [oe.prep_arrays(entries[lo:hi], oe._bucket(hi - lo))
                          for lo, hi in plan])
    plain_prep = timed(lambda: [
        oe.prep_arrays_plain(entries[lo:hi], oe._bucket(hi - lo))
        for lo, hi in plan])
    # the C pass alone on either side of its threading threshold
    threads_ms = {}
    for count in (2047, 2048):
        packed = oe.pack(entries[:count])
        block = np.empty(oe._LANE_BYTES * 4096, np.uint8)
        base = block.ctypes.data
        threads_ms[count] = timed(lambda: host.ed25519_prep(
            *packed[:3], packed[3].ctypes.data, packed[4].ctypes.data, count,
            4096, oe._B_BYTES, oe._IDENTITY_BYTES, base, base + 32 * 4096,
            base + 64 * 4096, base + 128 * 4096, base + 192 * 4096))

    # kernel times per bucket; at the main path's tile (its first tile of
    # real signatures, padded to 4096) and at 10240 lanes the kernel is
    # also held to the plain version — exact equality, verdicts are bools
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

    # -- 4c. verify_async of the 10k batch under a 1 ms asyncio ticker ----
    _phase(f"4c verify_async of the {n}-signature batch under a 1 ms ticker")
    bv = crypto_batch.create_batch_verifier(keys[0])
    for pub, msg, sig in entries:
        bv.add(Ed25519PubKey(pub), msg, sig)
    async_ok, sync_gap_ms, async_gap_ms, async_ms = asyncio.run(
        _loop_stalls(bv))
    pipeline.reset_workers()
    if not async_ok:
        raise AssertionError("verify_async rejected the commit's batch")
    _log(f"loop_stall_ms verify_async {async_gap_ms:.3f} against "
         f"{sync_gap_ms:.3f} for the synchronous verify() on the loop "
         f"(longest gap between 1 ms ticks; the async call took "
         f"{async_ms:.3f} ms)")

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
    _log(f"verify_commit_e2e_ms {_p50_p90(e2e)} ({WARM_RUNS} warm runs, "
         f"host clock; {n} signatures, {tiles_all} tiles; runs: "
         f"{', '.join(f'{x:.2f}' for x in e2e)})")
    _log(f"signatures_per_s {n / _pct(e2e, 0.5) * 1e3:.0f} (at the "
         f"verify_commit p50)")
    _log(f"verify_batch_ms {_p50_p90(vb)} (prep, copies and kernels of the "
         f"{n} signatures through the tile pipeline, no commit walk)")
    _log(f"c_prep_ms {_p50_p90(prep)} (prep_arrays on the {tiles_all} "
         f"tiles, packing included); plain_prep_ms {_p50_p90(plain_prep)} "
         f"(prep_arrays_plain, numpy and hashlib)")
    _log("verify_commit split from the port's spans (ms, "
         f"{WARM_RUNS} runs): " + "; ".join(
             f"{name} {_p50_p90(split[name])}" for name in
             ("walk", "batch_verify", "host_prep", "prep_pack", "prep_c",
              "kernel_execute")) +
         " (walk = e2e - batch_verify; kernel_execute = the host's wait "
         "at each tile's event)")
    _log(f"overlap_ratio {_p50_p90(overlap)} (summed phase time over "
         f"pipeline wall, one observation a verify_commit)")
    _log(f"c_pass_ms at 2,047 items ({host.ed25519_prep_threads(2047)} "
         f"thread) {_p50_p90(threads_ms[2047])}; at 2,048 items "
         f"({host.ed25519_prep_threads(2048)} threads) "
         f"{_p50_p90(threads_ms[2048])} (the C call alone, no packing)")
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
    mb_ops = _mb_work_per_lane()
    mb_yard_ops = {op: _mb_ops(*work, op, mb.REPS[op])
                   for op, work in MB_YARDSTICK_WORK.items()}
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
    # the point ops at lane counts that leave a partial quad, warp or block
    for m in MB_PARTIAL_LANES:
        x_part = mb.suite_input(m, dev)
        for op in mb.POINT_OPS:
            got = mb.bench_cols(x_part, op, MB_PARTIAL_REPS)
            torch.cuda.synchronize()
            plain = mb.bench_cols_plain(x_part, op, MB_PARTIAL_REPS)
            if not torch.equal(got, plain):
                raise AssertionError(
                    f"microbench {op} kernel != plain on "
                    f"{int((got != plain).any(0).sum())} of {m} lanes")
            mb_err[op] = max(mb_err[op], int(
                (got.long() - plain.long()).abs().max().item()))
    _log(f"microbench {', '.join(mb.POINT_OPS)} == plain limb for limb at "
         f"{', '.join(map(str, MB_PARTIAL_LANES))} lanes, "
         f"{MB_PARTIAL_REPS} reps (partial quads, warps and blocks)")
    _log(f"mb bound per op = max(int32 ops per lane x lanes / "
         f"{INT32_OPS_PER_S:.4g}, lanes x "
         f"{MB_IN_BYTES_PER_LANE + MB_OUT_BYTES_PER_LANE} B / "
         f"{HBM_BYTES_PER_S:.3g} B/s); ops per lane = multiplies x "
         f"{OPS_PER_FIELD_MUL} + squarings x {OPS_PER_FIELD_SQR} + "
         f"carries x {OPS_PER_CARRY} (+ {OPS_PER_SELECT_STEP} per select16 "
         f"step), counting only what the output reads; yardstick_bound_ms "
         f"is PR 3's, on every product of the single-point chain")
    mb_bounds = {}
    for recs, _ in mb_runs.values():
        for op, rec in recs.items():
            lanes, reps = rec["bucket"], rec["reps"]
            ops, n_mul, n_sqr, n_carry = mb_ops[op]
            b_ms, b_by = _mb_bound(lanes, ops)
            yard_ms = _mb_bound(lanes, mb_yard_ops[op])[0]
            mb_bounds[(op, lanes)] = (b_ms, b_by, yard_ms)
            _log(json.dumps(rec))
            _log(f"{rec['metric']} lanes {lanes} reps {reps}: ms "
                 f"{rec['value_ms']:.4f} per_op_us {rec['per_op_us']:.4f} "
                 f"per_lane_ns {rec['value_ms'] * 1e6 / (reps * lanes):.4f} "
                 f"plain_ms {mb_plain_ms[(op, lanes)]:.1f} "
                 f"bound_ms {b_ms:.4f} ({b_by}; {ops} ops/lane: {n_mul} mul, "
                 f"{n_sqr} sqr, {n_carry} carry) bound_share "
                 f"{b_ms / rec['value_ms']:.4f} yardstick_bound_ms "
                 f"{yard_ms:.4f} ({mb_yard_ops[op]} ops/lane)")

    # -- 6c. B1's round cost: the suite at B1's tile, 512 warps ----------
    _phase(f"6c microbench suite at B1's tile ({MB_TILE} lanes)")
    tile_recs = {r["metric"][3:]: r for r in mb.run_suite(m=MB_TILE)}
    for op, rec in tile_recs.items():
        _log(f"{rec['metric']} lanes {MB_TILE} reps {rec['reps']}: ms "
             f"{rec['value_ms']:.4f} per_op_us {rec['per_op_us']:.4f}" +
             (f" rounds {MB_ROUNDS[op]} round_us "
              f"{rec['per_op_us'] / MB_ROUNDS[op]:.4f}"
              if op in MB_ROUNDS else ""))

    grouped_launches, grouped_b2, mixed_small, agg_set = _config5_phases(
        args.seed, card, make, stamps, block_id)

    vote_launches = _vote_phases(args.seed, card, vals, commit, slot,
                                 vote_data, mixed_small)

    # phases 10 and 11 sign what they need in a pool, outside every
    # timed window
    with ctx.Pool(os.cpu_count() or 4) as pool:
        light_launches, light_launches8 = _light_phases(
            args.seed, card, pool, keys, vals, agg_set)
        exec_launches, exec_launches8 = _exec_phases(args.seed, card, pool,
                                                     keys)
        keep = {}
        cs_launches, cs_launches8 = _cs_phases(args.seed, card, pool,
                                               keep=keep)
    p2p_launches = _p2p_phases(args.seed, card, keep)

    # -- 7. kernels line, card line, result line -----------------------------
    # ms, plain_ms and bound_ms are for one launch at the main path's
    # tile; the 10240-lane bucket and the whole commit ride beside them
    b_tile, b_10240 = bounds[tile_lanes], bounds[10240]
    kernels = {"kernels": [{
        "name": "ed25519_verify",
        "route": "cuda",
        "source": "cometbft_tpu_torch/ops/csrc/ed25519_verify.cu",
        "replaces": "cometbft_tpu/ops/ed25519_pallas.py:379",
        "design": "four threads a signature on the 4-way extended-"
                  "coordinate rounds, 55-product squaring, cached lane "
                  "table in shared memory",
        "launches": main_launches,
        "launches_by_path": {"commit_10k": main_launches,
                             "config5_grouped": grouped_launches,
                             **{k: v for k, v in vote_launches.items()
                                if k != "vote_burst_cuda8"},
                             **light_launches, **exec_launches,
                             **cs_launches, **p2p_launches},
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
        "design": "four threads a signature on its own 16-limb field, "
                  "thread c keeping coordinate c of the point, two-round "
                  "doubling and unified add, lane table of (X, Y, Z, 2dT) "
                  "entries in shared memory",
        "launches": main8_launches,
        "launches_by_path": {"commit_10k_cuda8": main8_launches,
                             "config5_grouped": grouped_b2,
                             "vote_burst_cuda8":
                                 vote_launches["vote_burst_cuda8"],
                             **light_launches8, **exec_launches8,
                             **cs_launches8},
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
        b_ms, b_by, yard_ms = mb_bounds[(op, mb.M_DEFAULT)]
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
            "yardstick_bound_ms": yard_ms,
            "per_op_us": rec["per_op_us"],
            f"lanes_{MB_BIG}": {
                "ms": big[op]["value_ms"],
                "plain_ms": mb_plain_ms[(op, MB_BIG)],
                "bound_ms": mb_bounds[(op, MB_BIG)][0],
                "bound_by": mb_bounds[(op, MB_BIG)][1],
                "yardstick_bound_ms": mb_bounds[(op, MB_BIG)][2]},
        })
        if op in mb.POINT_OPS:
            kernels["kernels"][-1].update(
                design="four threads a lane on B1's own rounds "
                       "(ed25519_quad.cuh), point in registers, "
                       "64-thread blocks" +
                       (", cached lane table in shared memory"
                        if op == "window" else ""),
                ptxas=mb_ptxas[op],
                round_us_at_b1_tile=(tile_recs[op]["per_op_us"] /
                                     MB_ROUNDS[op]))
    _log(f"chip_smoke_seconds {time.perf_counter() - t_start:.1f}")
    print(json.dumps(kernels), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
