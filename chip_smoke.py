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
Phases 14a-14d drive block sync, evidence and the mempool (blocksync/,
evidence/, mempool/, light/provider.NodeProvider, tools/loadtime): 13b's
server restarted over the same stores with a passive BlocksyncReactor,
and a fresh joiner wired as the JAX node (active BlocksyncReactor,
ConsensusReactor waiting for sync, EvidenceReactor, MempoolReactor) that
block-syncs the 150-validator chain, two B1 launches a height, switches
to consensus through the JAX node's hand-off and commits the server's
last height by catch-up, timed a height beside 13b's gossip figure, its
rows, states and app hash held to the twin's; config 1 over sockets with
evidence pools, one validator equivocating to node 0 until every node
commits the evidence; a lunatic light-client attack at 150 validators
verified on B1 against the joiner's stores and a tampered attribution
refused; config 1 with CListMempools and the default consensus timeouts
under 400 tx/s of 1 KB loadtime payloads for 10 s, every accepted tx
committed once on every node; and a server whose block carries a
flipped LastCommit signature bit banned, the evidence and mempool
refusals, a 20-height sync under cuda8 and a raising stand-in kernel in
the sync routine, which must stop the sync without a restart.
Phases 15a-15c drive state sync and pruning (statesync/, state/pruner.py,
state/rollback.py, the stores' bootstrap and pruning, the kvstore's
snapshots, the state tree's prune and import): a 150-validator source of
105 heights of 200 txs each under its own key (about 20,000 pairs),
snapshots every 10 heights, retain_blocks 50 and a Pruner service on its
executor, served over sockets by a full node without a key; a fresh
joiner wired as the JAX node's state-syncing one restores the snapshot
at 100 through its light client (trust root 90, every light block's
commit on B1), bootstraps, block-syncs 101-104, switches to consensus and
commits 105 by catch-up, timed stage by stage with B1's launches, the
chunk's MB/s over the secret connection and the device's busy share, its
rows, app and app hash held to the source's; the pruned source held to
its retain height (no row below the block store's base but the validator
rows retained pointers name, every tree version rebuilt to its root) and
rollback_state on the stopped joiner; and the refusals: a format the app
refuses, a chunk off its hash, a chunk never served, a snapshot at the
tip (dropped for the next one), a flipped signature bit in a light block, a raising stand-in
kernel, and one state sync under cuda8 with the same rows.
Phases 16a-16e drive privval and the JSON-RPC (privval/, indexer/, rpc/,
the HTTP provider, new_rpc_state_provider, loadtime's generate and
report): a light client over two RPCServers serving 15a's source
(HttpProviders, sequential and skipping from 90 to 105) against the same
syncs over NodeProviders, every light block over HTTP held to the stores'
bytes; 15a's joiner with new_rpc_state_provider over those servers, its
bootstrapped rows held to 15a's; config 1 over sockets with three FilePVs
and validator 0 signing in `python -m cometbft_tpu_torch.privval.signer`,
against 13a's MockPV net, then loadtime over HTTP, broadcast_tx_commit
and a WebSocket client with every tx found by /tx and tx_search; the
signer killed and restarted from its files (a conflicting vote refused
with the JAX text, a timestamp-only one given the stored signature); and
the refusals: a lying server's light block and commit (B1, then cuda8),
a forked witness (divergence and evidence over broadcast_evidence), the
unsafe routes, an unknown method, a bad parameter, a body over
max_body_bytes, bad lightserve parameters, the signer gone, a raising
stand-in kernel.
Phases 17a-17e drive the proof-serving light path (lightserve/, the
state tree's prove and pins, light/state_proof, light/proxy) over 15a's
source: 16a's syncs over servers serving light_block with a response
cache (one round trip a light block, no /commit or /validators, B1's
launches and lanes equal to NodeProvider's, a second client's pass
served from the cache) against NodeProviders and servers without the
lightserve routes; a proven abci_query_batch of 256 present and 16
absent keys and multiproofs over a block's txs, checked against a header
the light client verified on B1 (and under cuda8), tampered ones refused;
a cached height kept provable past the tree's pruning horizon; the
light proxy over the two servers, every answer held to the stores and a
forged tx refused; and the repairs of ROADMAP C.1-C.4 on config 1's
in-process net, an evidence reactor and an RPC server.
Phases 18a-18d drive the rest of ABCI and the gRPC surface with every
app in a process of its own (python -m cometbft_tpu_torch.abci.server,
reached over a unix socket through SocketAppConns with the JAX node's
deadlines, tracing, proxy metrics and a call trace): 13a's config 1 net
with a mempool, keyed txs through each node's mempool connection, an SQL
event sink and a loop-lag sampler per node and a pprof listener (the app
hashes agree, every tx committed once with one sink row, each
LastCommit check's launches as 13a's, the call traces grammatical); 12a's
150-validator feed replayed to a node whose app is a process (blocks,
results and state equal the twin's, B1's launches and lanes a height
equal 12a's, one height under cuda8); the companion services' servicers
on those stores, pruning to four retain heights; and the rejects: an
app raising in FinalizeBlock, an app past a deadline, an app killed
between heights, frames over MAX_MSG_SIZE.
Phases 19a-19e drive the node (node/, cmd/, config, confix,
tools/manifest) as a user runs it: BASELINE.json config 1 as `python -m
cometbft_tpu_torch.cmd testnet --v 4` and four `cmd start` processes on
the card under `cmd load` for 30 heights (every process holds the card
and exits 0 on SIGTERM, /block and /commit agree on every node, every
accepted tx committed once); four Nodes in this process on those homes
for 50 heights, each LastCommit check one B1 launch, then one height
under cuda8; a fifth Node state-syncing over two of their RPC servers,
block-syncing and joining consensus (its blocks and app hashes the net's,
the same proposer at its first consensus height); a generated e2e
manifest with a restart, a late joiner and injected duplicate-vote
evidence through run_manifest; and the rejects: a killed socket app stops
its `cmd start` process non-zero, a bad config, a home without a genesis,
grpc.laddr without grpcio.
Phases 20a-20e drive the testnet tools (tools/qa.py, tools/fuzz.py,
tools/fleet_report.py) and the mesh split and tally (parallel/): the QA
tool's process fleet at the reference QA width (12 validators and 3 full
nodes as `cmd start` processes on the card across three latency zones, 90
ghost validators, two 10 s load windows, a kill -9 and restart, a
state-sync joiner: no mismatch, the joiner at the target, every sampled
commit with at least 9 signatures, as many compute apps as live nodes,
B1 launches in every process's "Node stopped" line); 1,000 simulated
light clients against four Nodes (no request or proof error, cache
hits); each fuzz target for 5 s with no crash and both corpora replayed;
a mixed 10,240-lane batch through verify_sharded over make_mesh() (one B1
launch a shard, the mask equal to verify_batch's and the golden
model's), one tally step in a one-rank NCCL group and the sharding
report calibrated on the card; and a fleet child started under an
unknown COMETBFT_TPU_TORCH_KERNEL, which exits 1 and makes the QA tool
exit 1.
Phases 21a-21d drive the last trims of the port: tools/benchmarks.py's
BASELINE configs #2-#4 at --full in this process (the batch verifier at
64, 1,024 and 10,000 signatures, 1,000 light validators over 4 hops, 150
validators for 10 heights) and config #5 at its default size (200 mixed
keys, a 16-message BLS aggregate; phase 8b holds it at 10,000), each
line with the JAX line's keys and the card's name and B1 launches
counted around each config, then `python -m
cometbft_tpu_torch.tools.benchmarks --config 2` as a process; a Node on
the card whose supervised task verifies a batch on B1 and crashes until
the supervisor gives up, leaving a flight record with B1's
kernel_execute spans in the data dir, and /debug/pprof/trace?dump=1
writing another; and 2,100 peer ids through that node's peer-labelled
metric families, each held at 2,048 series and one overflow series, on
/metrics and /metrics?exemplars=1.
Phases 22a-22b drive the port's fault paths on the card: two scenarios
of the nemesis (tests/torch_nemesis.py, each Scenario as the JAX
package's tests/test_nemesis.py writes it) with four in-process
validators verifying on B1, `faulty-links` (seed 23: every link drops,
delays, reorders and duplicates frames) and `pipelined-commit` (seed 17:
file WALs, a hard crash that aborts an in-flight apply, a restart through
the handshake and catch-up replay), each with no conflicting commit, its
recovery bound met and B1 launched; then every stored commit of every
node verified again through verify_commit on the card, and one height's
batch with a corrupted lane held to B1's plain version, masks equal; and
the fail-point crash sweep: tests/torch_crash_driver.py node processes on
the card crashing (exit 99) at commit-path boundaries 0, 2, 5 and 6 of
height 2 and restarting to their target (exit 0), and a node restarting
on a torn WAL tail, which leaves a .corrupted copy and commits on.
Phase 23 drives the record readers on the card: the JAX package's live
exposition contract's net (three Nodes in this process verifying on B1,
four txs, every node to height 6); node 0's /trace?height=H of each
committed height through the port's tools/trace_report.py, one line a
height (wall, gossip, verify, execute, commit ms and kernel_execute
spans), the run's record holding one kernel_execute span, its kernel
`cuda`, for each B1 launch logged; /metrics and /metrics?exemplars=1
through the exposition contract's parser (tests/torch_exposition.py),
batch verification counted under the backend `cuda` and every exemplar
at a height that had begun; and tools/metrics_catalog.py's catalog equal
to the one tier-1 pins (tests/torch_catalog.py).
Any failure exits non-zero.  The last three lines are the kernels JSON,
the card's name and power limit, and {"ok": true, "device": {...}}.  Signatures are made
from --seed with the golden model in a pool of worker processes.
"""
from __future__ import annotations

import argparse
import asyncio
import base64
import collections
import contextlib
import hashlib
import json
import logging
import multiprocessing
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import threading
import time
from concurrent.futures import ThreadPoolExecutor

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
# 80GB HBM3 at 700 W, with the spread of the card's host), then from 50 to
# keep the whole run near 800 s with phase 20 (13b took 33.9 s at 50), then
# from 25 to 12 for the smoke's margin (13b took 15.5 s at 25).  Here and
# below, "saved" is an estimate of the seconds a cut saves from the whole
# run's 1,077.9 s on an NVIDIA H100 80GB HBM3 at 700 W and its host
CATCHUP_HEIGHTS = 12
AEAD_INPUTS = 1000        # 13c: seeded (key, nonce, aad, message) inputs
AEAD_LENS = (0, 3, 1023, 1024, 1028)   # 13c: message lengths among them
# phase 14
LCA_COMMON = 50           # 14b(ii): the attack's common height
LCA_CONFLICT = 60         # 14b(ii): its conflicting height
LOAD_RATE = 400           # 14c: tx/s, round-robin over the nodes
LOAD_SECONDS = 3.0        # 14c: the submission window (10 s until phase 20,
                          # 5 s until phase 21: ~2 s saved)
LOAD_TX_BYTES = 1024      # 14c: CometBFT's QA tx size
MEMPOOL_HEIGHTS = 20      # 14c: the heights the net commits at least (50
                          # until phase 20, 30 until phase 21: ~2 s saved)
BSYNC_REJECT_HEIGHTS = 12  # 14d: the depth of each of its syncs (20 until
                           # phase 21; 14d took 17.5 s at 20: ~5 s saved)
BSYNC_BAD_HEIGHT = 10     # 14d: the bad server spoils block BSYNC_BAD_HEIGHT + 1
# phase 15
SS_CHAIN_ID = "statesync-chip"
SS_HEIGHTS = 105          # 15a: the source chain's heights
SS_INTERVAL = 10          # 15a: snapshot_interval, the JAX node's builtin one
SS_RETAIN = 50            # 15a: the source app's retain_blocks
SS_TRUST = 90             # 15a: the joiner's trust root
SS_LEAD_S = 300           # 15a: the genesis lies this long before the run
SS_DISCOVERY_NS = 2 * 10**9       # 15a: the JAX QA joiner's discovery time
SS_REJECT_DISCOVERY_NS = 5 * 10**8  # 15c: the peers are dialed beforehand
SS_CHUNK_TIMEOUT_NS = 25 * 10**7    # 15c(ii): a short chunk_request_timeout_ns
# phase 16: privval and the JSON-RPC over 15a's source and config 1
PV_VALIDATORS = 4         # 16c: config 1
PV_HEIGHTS = 5            # 16c: the heights of each net before the load (20
                          # until phase 20, 10 until phase 21: ~1.5 s saved)
RPC_LOAD_RATE = 100       # 16d: tx/s over HTTP, round-robin over the nodes
RPC_LOAD_SECONDS = 2.0    # 16d: the submission window (3 s until phase 21:
                          # ~1 s saved)
RPC_TX_BYTES = 1024       # 16d: CometBFT's QA tx size
RPC_COMMIT_TXS = 10       # 16d: txs sent by broadcast_tx_commit
RPC_TX_HEIGHTS = 10       # 16d: the heights the net commits at least after 16c
                          # (20 until phase 21: ~2.6 s saved at 263 ms a height)
LS_VERSION = 100          # 17b: the tree version proven (header 101)
LS_PRESENT = 256          # 17b: present keys a proven batch asks
LS_ABSENT = 16            # 17b: absent keys beside them
LS_MP_PICK = 16           # 17b: txs of one block a seeded multiproof proves
LS_PIN = 60               # 17c: the cached height below the next horizon
LS_PIN_HEIGHTS = 10       # 17c: the commits that move the horizon past it
LS_PROXY_HEIGHTS = (92, 100, 105)   # 17d: commit and block through the proxy
REPAIR_HEIGHTS = 3        # 17e: the heights config 1 commits past C.1-C.2
# phase 18: the rest of ABCI and the gRPC surface over out-of-process apps
SOCKAPP_HEIGHTS = 12      # 18a: config 1's heights, each app in a process
                          # (50 until phase 20, 25 until phase 21: ~3.6 s
                          # saved at 275 ms a height)
SOCKAPP_CS_HEIGHTS = 25   # 18b: 12a's heights replayed to a socket app (50
                          # until phase 21: ~5.6 s saved at 224 ms a height)
ABCI_TIMEOUT_S = 20.0     # 18a-18b: apply_deadlines' default, the JAX node's
ABCI_RETRIES = 2          # 18a-18b: its retries, the JAX node's
LAG_INTERVAL_S = 0.25     # 18a: the loop-lag sampler's interval
COMPANION_RETAIN = {      # 18c: retain heights, each below 18b's top
    "app": 18, "block": 15, "results": 20, "tx_indexer": 10,
    "block_indexer": 12}
REJECT_DEADLINE_S = 0.5   # 18d: the deadline an app sleeps past
REJECT_FAULT_HEIGHT = 3   # 18d: the height whose FinalizeBlock raises
# phase 19: the node and its entry points
NODE_CLI = [sys.executable, "-m", "cometbft_tpu_torch.cmd"]
NODE_VALIDATORS = 4       # 19a: config 1, cmd testnet --v 4
NODE_CLI_HEIGHTS = 30     # 19a: heights of the cmd start processes
NODE_LOAD_RATE = 100      # 19a: cmd load, 16d's load: tx/s,
NODE_LOAD_SECONDS = 1.0   # seconds (3 until phase 21: ~2 s saved)
NODE_LOAD_SIZE = 1024     # and bytes a tx
NODE_INPROC_HEIGHTS = 12  # 19b: heights of the four in-process Nodes (50
                          # until phase 20, 25 until phase 21: ~5 s saved at
                          # 396 ms a height)
NODE_JOIN_TRUST = 10      # 19c: the joiner's trust height (19a's chain)
NODE_JOIN_DISCOVERY_NS = 2_000_000_000   # 19c: its snapshot discovery
MANIFEST_SEED = 793       # 19d: a generated net with a restart, a late
MANIFEST_TARGET = 8       # joiner and duplicate-vote evidence, ed25519
MANIFEST_TIMEOUT_S = 30.0
QA_CLI = [sys.executable, "-m", "cometbft_tpu_torch.tools.qa"]
QA_VALIDATORS = 12        # 20a: the reference QA width (method.md):
QA_FULL = 3               # 12 validators, 3 full nodes and 90 ghosts
QA_GHOSTS = 90
QA_RATES = (25, 50)       # two load windows (the JAX default: five
QA_WINDOW_S = 6.0         # windows of 90 s; 10 s until phase 21, two block
                          # intervals and more at 6: ~8 s saved)
QA_LS_CLIENTS = 1000      # 20b: run_lightserve's default
QA_LS_REQUESTS = 3        # 20b: requests a client (the default 6 until phase
                          # 21; with the write load now ending with the
                          # hammer, 20b took 24.9 s against 53.1)
QA_FUZZ_S = 2.0           # 20c: seconds a fuzz target (5 until phase 21: 9 s)
QA_MESH_LANES = 10240     # 20d: the sharded batch
QA_REPORT_LANES = 2048    # 20d: the report's reduced run
QA_MESH_SPLIT = 4         # 20d: shards on the one card ...
QA_MESH_SPLIT_LANES = 10200   # ... over lanes not a multiple of 16 * 4
# 21a: tools/benchmarks.main's arguments, a call a config; config 5 at the
# runner's default size, not --full's 10,000 keys: with them the whole smoke
# took 1,097.7 s on an H100 host, past 1,050 s of its 1,200 s limit, and
# phase 8b holds config 5 at 10,000
BENCH_ARGS = [["--full", "--config", "2"], ["--full", "--config", "3"],
              ["--full", "--config", "4"], ["--config", "5"]]
BENCH_SIZES = ["64", "1024", "10000"]   # 21a: config 2's sizes at --full
BENCH_CLI = [sys.executable, "-m", "cometbft_tpu_torch.tools.benchmarks"]
# 21a: each config's keys in the JAX package's line
# (cometbft_tpu/tools/benchmarks.py), to which the port adds "device"
BENCH_JAX_KEYS = {
    2: {"config", "metric", "backend", "results_ms"},
    3: {"config", "metric", "validators", "hops", "value_ms"},
    4: {"config", "metric", "validators", "heights", "tally_ms_p50",
        "commit_verify_ms_p50"},
    5: {"config", "metric", "validators", "bls_aggregate_size",
        "mixed_commit_verify_ms", "bls_aggregate_verify_ms"}}
FLIGHT_SIGS = 64          # 21c: the batch the failing task verifies
FLIGHT_RESTARTS = 2       # 21c: its restart budget
CHURN_PEERS = 2100        # 21d: peer ids through the metrics


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


_T_START = time.perf_counter()


def _phase(name):
    """A phase's heading, with the seconds since the script started."""
    _log(f"== {name} (at {time.perf_counter() - _T_START:.1f} s)")


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
                 dbs=None, device=None, sig_cache=None, t0=EXEC_T0):
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
        self.t0 = t0                # genesis time; height h signs at t0 + h s
        self.sig_cache = {} if sig_cache is None else sig_cache
        pubs = signer.pubs(seeds) if pubs is None else pubs
        keys = [Ed25519PubKey(p) for p in pubs]
        self.seed_of = {pk.address(): s for pk, s in zip(keys, seeds)}
        self.doc = GenesisDoc(
            chain_id=chain_id, genesis_time=Timestamp(t0, 0),
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
        at t0 + h s + (index + 1) ns, but those in ``skip`` (absent)."""
        from cometbft_tpu_torch.types.canonical import (
            PRECOMMIT_TYPE, vote_sign_bytes_template)
        from cometbft_tpu_torch.types.commit import Commit, CommitSig
        from cometbft_tpu_torch.types.timestamp import Timestamp
        from cometbft_tpu_torch.types.vote import BLOCK_ID_FLAG_COMMIT
        make = vote_sign_bytes_template(self.chain_id, PRECOMMIT_TYPE, h, 0,
                                        block_id)
        idx = [i for i in range(vals.size()) if i not in skip]
        stamps = {i: Timestamp(self.t0 + h, i + 1) for i in idx}
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
        out = asyncio.run(self._propose_apply(txs))
        return self._sign_save(out, time.perf_counter() - t0)

    async def astep(self, txs):
        """step() on the caller's running event loop."""
        t0 = time.perf_counter()
        out = await self._propose_apply(txs)
        return self._sign_save(out, time.perf_counter() - t0)

    def _sign_save(self, out, apply_s):
        block, parts, block_id, signing_set = out
        h = block.header.height
        commit = self.sign_commit(signing_set, h, block_id)
        t2 = time.perf_counter()
        self.block_store.save_block(block, parts, commit)
        t3 = time.perf_counter()
        self.last_commit = commit
        self.applied[h] = block.hash()
        self.parts[h] = parts.total
        return block, apply_s + (t3 - t2)

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
    a fresh app on an app db that is behind.

    It also carries the JAX Node's attribute names that rpc/core's routes
    read (``consensus_state``, ``event_bus``, ``app_conns``,
    ``genesis_doc``, ``config``, ``priv_validator``, ``evidence_pool``,
    the indexers and the pruner, ``status()``), so an RPCServer serves
    it as it would serve that Node."""

    tx_indexer = block_indexer = pruner = None
    consensus_reactor = None

    @property
    def blocksync_reactor(self):
        return getattr(self, "bsync", None)

    @property
    def consensus_state(self):
        return self.cs

    @property
    def event_bus(self):
        return self.bus

    @property
    def app_conns(self):
        return self.conns

    @property
    def evidence_pool(self):
        return self.evpool

    @property
    def priv_validator(self):
        return self.cs.priv_validator

    def status(self) -> dict:
        from cometbft_tpu_torch.node.node import Node
        return Node.status(self)

    @classmethod
    async def make(cls, doc, device, dbs=None, wal_path=None, config=None,
                   pv=None, mempool_config=None, evidence=False, app=None,
                   conns=None):
        """``mempool_config`` gives the node a CListMempool on the app's
        lanes, ``evidence`` an EvidencePool over MemDB; both reach the
        BlockExecutor (otherwise it runs its no-op ones).  ``app`` is a
        kvstore app over ``dbs["app"]`` to keep (its snapshots live in
        memory); by default the node opens a new one.  ``conns`` are the
        started app connections of an app in another process (abci/
        client.SocketAppConns, wrapped or not): the node then holds no
        app of its own (``node.app`` is None)."""
        from cometbft_tpu_torch.abci import types as abci
        from cometbft_tpu_torch.abci.client import AppConns
        from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
        from cometbft_tpu_torch.config import Config, ConsensusConfig
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
        self.genesis_doc, self.config = doc, Config()
        self.dbs = dbs or {"state": MemDB(), "block": MemDB(),
                           "app": MemDB()}
        self.state_store = Store(self.dbs["state"])
        self.block_store = BlockStore(self.dbs["block"])
        state = self.state_store.load()
        if state is None:
            state = make_genesis_state(doc)
            self.state_store.save(state)
        if conns is not None:
            self.app, self.conns = None, conns
        else:
            self.app = app if app is not None else \
                KVStoreApplication(db=self.dbs["app"])
            self.conns = AppConns(self.app)
        await Handshaker(self.state_store, state, self.block_store, doc,
                         device=device).handshake(self.conns)
        self.bus = EventBus()
        self.mempool = self.evpool = None
        if mempool_config is not None:
            from cometbft_tpu_torch.mempool import CListMempool
            info = await self.conns.query.info(abci.InfoRequest())
            self.mempool = CListMempool(
                mempool_config, self.conns.mempool,
                lanes=info.lane_priorities, default_lane=info.default_lane,
                height=self.state_store.load().last_block_height)
        if evidence:
            from cometbft_tpu_torch.evidence import EvidencePool
            self.evpool = EvidencePool(MemDB(), self.state_store,
                                       self.block_store, device=device)
        self.exec = BlockExecutor(self.state_store, self.conns.consensus,
                                  mempool=self.mempool, evpool=self.evpool,
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
def _commit_checks(ek):
    """{height: {id of the BlockExecutor: [B1 launches of each of its
    validate_block calls at that height]}} while the block runs: the
    LastCommit check's launches, counted on the calling thread only (the
    bursts' pre-verification launches on the staging worker's thread are
    not its)."""
    from cometbft_tpu_torch.state.execution import BlockExecutor
    real_validate, real_verify = BlockExecutor.validate_block, \
        ek.verify_cols
    inside = threading.local()
    checks = collections.defaultdict(lambda: collections.defaultdict(list))

    def verify_cols(*a):
        before = ek.launches
        out = real_verify(*a)
        if getattr(inside, "count", None) is not None:
            # a call launches at most once; a burst's launch on another
            # thread between the two reads is not this call's
            inside.count += min(1, ek.launches - before)
        return out

    def validate_block(self, state, block):
        inside.count = 0
        try:
            return real_validate(self, state, block)
        finally:
            checks[block.header.height][id(self)].append(inside.count)
            inside.count = None

    BlockExecutor.validate_block, ek.verify_cols = validate_block, verify_cols
    try:
        yield checks
    finally:
        BlockExecutor.validate_block, ek.verify_cols = real_validate, \
            real_verify


def _node_checks(checks, execs, heights) -> list:
    """Each executor's LastCommit-check launches at ``heights``: the most
    that any of its validate_block calls at a height made."""
    return [[max(checks.get(h, {}).get(id(ex), [0])) for h in heights]
            for ex in execs]


def _tally(counts) -> dict:
    """{count: how many times it occurs}, smallest count first."""
    return dict(sorted(collections.Counter(counts).items()))


def _batch_lanes(tracing) -> list:
    """The lanes of each B1 batch the flight recorder holds, oldest
    first."""
    return [ev["attrs"]["batch"]
            for ev in tracing.snapshot(category=tracing.CRYPTO)
            if ev["name"] == "batch_verify"]


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
    rows, per_launch, serial_n, per_lanes = {}, {}, {}, {}

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
            b0 = len(_batch_lanes(tracing))
            total, dec, wal_bytes, worst = loop.run_until_complete(drive(h))
            row = {k: (sum(v) - before[k]) * 1e3 for k, v in split.items()}
            row.update(total=total * 1e3, decode=dec * 1e3,
                       wal_bytes=wal_bytes, gap=worst * 1e3)
            row["rest"] = row["total"] - sum(
                row[k] for k in _CS_SPLIT_KEYS[:-1])
            rows[h], per_launch[h] = row, ek.launches - l0
            serial_n[h] = len(split["serial_verify"]) - s0
            per_lanes[h] = _batch_lanes(tracing)[b0:]

    prof_lo = max(top - CS_TRACED + 1, 2)
    ek.launches = 0
    tracing.clear()
    with _cs_split() as split, _launch_log(ek) as buckets, \
            _gc_pauses() as pauses:
        heights(1, prof_lo)
        profiled = _device_busy(lambda: heights(prof_lo, top + 1))
    launches = ek.launches
    lanes = _batch_lanes(tracing)
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
    # what 18b holds its socket-app node to: the feed, and this node's B1
    # launches, lanes and ms a height
    chain.live = {"raw": raw, "launches": per_launch, "lanes": per_lanes,
                  "ms": {h: rows[h]["total"] for h in rows}}
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
    lanes = _batch_lanes(tracing)
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

def _p2p_metrics_bytes(switches, family,
                      channels=("0x20", "0x21", "0x22", "0x23")):
    """{channel: bytes} summed over the switches' p2p metrics."""
    out = collections.Counter()
    for sw in switches:
        fam = getattr(sw.metrics, family)
        for ch in channels:
            out[ch] += fam.with_labels(ch).value
    return out


async def _sock_node(doc, device, key_seed, pv=None, config=None, dbs=None,
                     wait_sync=False, mempool_config=None, evidence=False,
                     reactors=(), app=None, conns=None):
    """A _CsNode with a Switch on 127.0.0.1 (port 0), a ConsensusReactor
    and a node key made from ``key_seed``; with a MempoolReactor when
    ``mempool_config`` is given, an EvidenceReactor when ``evidence``, and
    ``reactors(node)``'s reactors, all added before the switch starts."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
    from cometbft_tpu_torch.p2p import NodeKey, Switch
    node = await _CsNode.make(doc, device, dbs=dbs, config=config, pv=pv,
                              mempool_config=mempool_config,
                              evidence=evidence, app=app, conns=conns)
    node.node_key = NodeKey(Ed25519PrivKey(key_seed))
    node.switch = Switch(node.node_key, doc.chain_id,
                         listen_addr="127.0.0.1:0")
    node.reactor = node.consensus_reactor = ConsensusReactor(
        node.cs, wait_sync=wait_sync)
    node.switch.add_reactor(node.reactor)
    if mempool_config is not None:
        from cometbft_tpu_torch.mempool.reactor import MempoolReactor
        node.mempool_reactor = MempoolReactor(node.mempool, mempool_config)
        node.switch.add_reactor(node.mempool_reactor)
    if evidence:
        from cometbft_tpu_torch.evidence import EvidenceReactor
        node.evidence_reactor = EvidenceReactor(node.evpool)
        node.switch.add_reactor(node.evidence_reactor)
    for reactor in (reactors(node) if reactors else ()):
        node.switch.add_reactor(reactor)
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


def _sock_net(seed, card, ek, tracing, device, loop, net_ms, record=None):
    """13a: BASELINE.json config 1 over sockets — four validators, each
    with a Switch, a ConsensusReactor and a ConsensusState over the
    kvstore app, full mesh through the secret connection, test_config
    timeouts.  Fills ``record`` with what 18a holds its socket apps to:
    the ms a height, B1's launches and each LastCommit check's launches
    by height.  Returns B1 launches."""
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
            _timed(host, "verify") as verifies, _gc_pauses() as pauses, \
            _commit_checks(ek) as checks:
        nodes, stamps, hs, mesh_s = loop.run_until_complete(run())
    launches = ek.launches
    lanes = _batch_lanes(tracing)
    ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    total_s = stamps[-1] - stamps[1]
    if record is not None:
        record.update(ms=ms, launches=launches,
                      checks=_node_checks(checks, [nd.exec for nd in nodes],
                                          range(1, top + 1)))
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
    lanes = _batch_lanes(tracing)
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
    keep["catchup_ms"] = ms
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
                         keep["net_ms"], record=keep.setdefault("sock", {}))
        catchup = _sock_catchup(seed, card, ek, tracing, device, loop, keep)
        reject = _p2p_reject(seed, card, ek, device, loop)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
    _log(f"phase 13 took {time.perf_counter() - t_phase:.1f} s")
    return {f"sock_{SOCK_VALIDATORS}x{SOCK_HEIGHTS}": sock,
            f"catchup_{EXEC_VALIDATORS}x{CATCHUP_HEIGHTS}": catchup,
            "p2p_reject": reject}


# -- phase 14: block sync, evidence and the mempool ---------------------------

def _switch_to_consensus(node, log):
    """The JAX node's hand-off from block sync to consensus
    (cometbft_tpu/node/node.py:433-452), step by step: LastCommit rebuilt
    from the stored seen commit off the loop, the synced state taken,
    the reactor told to stop waiting, consensus started.  ``log`` gets
    when it ran, B1's launches in it and the round state it left."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek

    async def switch(new_state, height):
        log["switch_at"] = time.perf_counter()
        l0 = ek.launches
        if new_state.last_block_height > 0:
            node.cs.rs.last_commit = None
            await node.cs.reconstruct_last_commit_off_loop(new_state)
        node.cs.update_to_state(new_state)
        node.reactor.wait_sync = False
        await node.cs.start()
        rs = node.cs.rs
        log.update(switch_launches=ek.launches - l0, height=height,
                   rs_height=rs.height, last_commit=rs.last_commit,
                   switched=time.perf_counter())
    return switch


def _bsync_reactor(node, cfg, device, log):
    """An active BlocksyncReactor for ``node`` as the JAX node wires it
    (node.py:419-458): active and wait_sync read cfg.blocksync.enable."""
    from cometbft_tpu_torch.blocksync import BlocksyncReactor
    node.bsync = BlocksyncReactor(
        node.state_store.load(), node.exec, node.block_store,
        active=cfg.blocksync.enable,
        on_caught_up=_switch_to_consensus(node, log), device=device)
    return [node.bsync]


def _passive_bsync(node, device):
    from cometbft_tpu_torch.blocksync import BlocksyncReactor
    node.bsync = BlocksyncReactor(node.state_store.load(), node.exec,
                                  node.block_store, active=False,
                                  device=device)
    return [node.bsync]


def _bsync_chain(seed, card, ek, tracing, device, loop, keep):
    """14a: phase 13b's server restarted over the same stores (the twin's
    150-validator chain, 12b's height on top) with a passive
    BlocksyncReactor; a fresh joiner from genesis wired as the JAX node
    (Switch, active BlocksyncReactor, ConsensusReactor(wait_sync=True),
    EvidenceReactor, MempoolReactor, kvstore app, MemDB) block-syncs the
    chain, switches to consensus and takes the server's last block by
    the consensus catch-up.  Returns (B1 launches, the joiner)."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.blocksync.pool import BlockPool
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.ops import ed25519_host as host
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.wire import encode, pb
    chain, n, cfg = keep["chain"], EXEC_VALIDATORS, Config()
    _clear_memos()
    ek.launches = 0
    tracing.clear()
    gap = _LoopGap()
    rec = {"recv": {}, "saved": {}, "launches": {}, "stall": {}}
    log = {}
    real_add = BlockPool.add_block

    def add_block(pool, peer_id, block, ext, size):
        rec["recv"].setdefault(block.header.height, time.perf_counter())
        return real_add(pool, peer_id, block, ext, size)

    async def run():
        server = await _sock_node(
            chain.doc, device, _seed(seed + 140, 0), dbs=keep["dbs"],
            reactors=lambda nd: _passive_bsync(nd, device))
        top = server.block_store.height
        _phase(f"14a blocksync-{n}x{top - 1}: phase 13b's server restarted "
               f"over its stores ({top} heights of the twin's {n}-validator "
               f"chain) with a passive BlocksyncReactor; a fresh joiner "
               f"(active BlocksyncReactor, ConsensusReactor(wait_sync), "
               f"EvidenceReactor, MempoolReactor) block-syncs heights "
               f"1-{top - 1} (the last needs its successor's LastCommit), "
               f"switches to consensus and commits {top} by catch-up")
        joiner = await _sock_node(
            chain.doc, device, _seed(seed + 140, 1),
            wait_sync=cfg.blocksync.enable, mempool_config=cfg.mempool,
            evidence=True,
            reactors=lambda nd: _bsync_reactor(nd, cfg, device, log))
        states = {}
        real_save = joiner.state_store.save
        real_save_block = joiner.block_store.save_block

        def save(state):
            states[state.last_block_height] = state.bytes()
            real_save(state)

        def save_block(block, parts, seen):
            real_save_block(block, parts, seen)
            h = block.header.height
            rec["saved"][h] = time.perf_counter()
            rec["launches"][h] = ek.launches
            rec["stall"][h] = gap.take()

        joiner.state_store.save = save
        joiner.block_store.save_block = save_block
        sub = joiner.bus.subscribe("chip-smoke-bsync", EVENT_QUERY_NEW_BLOCK,
                                   out_capacity=1000)
        gap_task = asyncio.ensure_future(gap.run())
        try:
            await server.cs.start()
            await joiner.bsync.start_sync()
            t0 = time.perf_counter()
            rec["launches"][0] = ek.launches
            await asyncio.wait_for(
                joiner.switch.dial_peer(server.switch.listen_addr), 30)
            gap.take()
            deadline = t0 + 180
            while "switched" not in log:
                joiner.bsync.raise_if_failed()
                server.cs.raise_if_failed()
                if time.perf_counter() > deadline:
                    raise AssertionError(
                        f"14a: no switch to consensus in 180 s (joiner at "
                        f"{joiner.block_store.height})")
                await asyncio.sleep(0.01)
            await _cs_new_block(joiner, sub, top)
            t_done = time.perf_counter()
            await joiner.bsync.stop_sync()
            final_rs = joiner.cs.rs.height
        finally:
            gap.stop = True
            await gap_task
            await _sock_stop([joiner, server])
        return server, joiner, top, states, t0, t_done, final_rs

    BlockPool.add_block = add_block
    try:
        with _timed(host, "verify") as verifies, _gc_pauses() as pauses:
            server, joiner, top, states, t0, t_done, final_rs = \
                loop.run_until_complete(run())
    finally:
        BlockPool.add_block = real_add
    synced = range(1, top)
    lanes = _batch_lanes(tracing)
    # the gates: the joiner's rows, states and app hash are the twin's
    for h in range(1, top + 1):
        mine, twin = joiner.block_store, chain.block_store
        if encode(pb.BLOCK, mine.load_block(h).to_proto()) != \
                encode(pb.BLOCK, twin.load_block(h).to_proto()) or \
                encode(pb.BLOCK_META, mine.load_block_meta(h).to_proto()) != \
                encode(pb.BLOCK_META, twin.load_block_meta(h).to_proto()):
            raise AssertionError(f"14a: the joiner's block {h} != the twin's")
        if h < top and encode(pb.COMMIT,
                              mine.load_seen_commit(h).to_proto()) != \
                encode(pb.COMMIT, twin.load_seen_commit(h).to_proto()):
            raise AssertionError(f"14a: the joiner's seen commit {h} != the "
                                 f"twin's")
        if states.get(h) != chain.states[h]:
            raise AssertionError(f"14a: the joiner's State at {h} != the "
                                 f"twin's")
    final = joiner.state_store.load()
    info = loop.run_until_complete(joiner.conns.query.info(
        abci.InfoRequest()))
    if final.last_block_height != top or \
            info.last_block_app_hash != final.app_hash or \
            final.bytes() != chain.states[top]:
        raise AssertionError("14a: the joiner's app hash != the twin's")
    # the switch: consensus took the synced height, LastCommit is the
    # stored seen commit, and the catch-up then commits the server's top
    seen = joiner.block_store.load_seen_commit(top - 1)
    vs = log["last_commit"]
    if log["height"] != top - 1 or log["rs_height"] != top or \
            vs is None or vs.height != top - 1 or any(
                vs.get_by_index(i).signature != sig.signature
                for i, sig in enumerate(seen.signatures)
                if not sig.absent_flag()) or final_rs != top + 1:
        raise AssertionError(
            f"14a: the switch left rs.height {log['rs_height']} (then "
            f"{final_rs}) for a sync to {log['height']}")
    ms = [(rec["saved"][h] - rec["recv"][h]) * 1e3 for h in synced]
    step = [(rec["saved"][h] - rec["saved"][h - 1]) * 1e3
            for h in synced if h > 1]
    per = [rec["launches"][h] - rec["launches"].get(h - 1, 0)
           for h in synced]
    stalls = [rec["stall"][h] * 1e3 for h in synced]
    sync_s = rec["saved"][top - 1] - t0
    grace_s = log["switch_at"] - rec["saved"][top - 1]
    launches = rec["launches"][top - 1] - rec["launches"][0]
    sent = _p2p_metrics_bytes([server.switch], "message_send_bytes_total",
                              ("0x40",))["0x40"]
    got = _p2p_metrics_bytes([joiner.switch], "message_send_bytes_total",
                             ("0x40",))["0x40"]
    _log(f"blocksync_{n}x{top - 1} {top - 1} heights in {sync_s:.2f} s from "
         f"the dial ({(top - 1) / sync_s:.2f} heights a second); ms a height "
         f"from BlockResponse received to the block store's save "
         f"{_p50_p90(ms)}, save to save {_p50_p90(step)}; beside it "
         f"catchup_{n}x{CATCHUP_HEIGHTS}'s gossip catch-up in this call "
         f"{_p50_p90(keep['catchup_ms'])} ms a height; B1 launches "
         f"{launches} ({_p50_p90(per)} a height: verify_commit_light on "
         f"the next block's LastCommit, then validate_block on the block's "
         f"own), lanes a launch {sorted(collections.Counter(lanes).items())}; "
         f"card: {card}")
    _log(f"blocksync_{n}x{top - 1} caught up to the switch {grace_s:.2f} s "
         f"(the JAX grace is 2 x 2 s); the switch's LastCommit rebuild "
         f"{log['switch_launches']} B1 launch(es), rs.height {top} at the "
         f"switch, {final_rs} after the consensus catch-up of height {top} "
         f"({(t_done - log['switched']) * 1e3:.1f} ms); serial host verifies "
         f"{len(verifies)}; wire bytes a height on 0x40: server "
         f"{sent / (top - 1):.0f}, joiner {got / (top - 1):.0f}; the loop's "
         f"longest stall a height ms {_p50_p90(stalls)}, max "
         f"{max(stalls):.2f}; gc in the run: {_gc_line(pauses)}; the "
         f"joiner's rows, State.bytes() and app hash equal the twin's at "
         f"every height")
    return launches + log["switch_launches"], joiner


def _evidence_dup(seed, card, ek, device, loop):
    """14b(i): 13a's socket net (BASELINE.json config 1, four validators,
    the JAX test timeouts) with an EvidencePool and an EvidenceReactor on
    every node; a harness holding validator 3's key sends node 0 a second
    prevote for another block id.  Returns (B1 launches, what 14d
    reads)."""
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.consensus.messages import VoteMessage
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.canonical import PREVOTE_TYPE
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import Vote
    n = SOCK_VALIDATORS
    _phase(f"14b(i) evidence-dup-{n}: 13a's net with an EvidencePool and an "
           f"EvidenceReactor on every node; validator 3 equivocates to node "
           f"0, the evidence is gossiped on 0x38, proposed and committed")
    doc, pvs = _net_doc(seed + 141, n, "evidence-chip")
    _clear_memos()
    ek.launches = 0
    seen = [[] for _ in pvs]
    found = []

    async def run():
        nodes = [await _sock_node(doc, device, _seed(seed + 142, i), pv=pv,
                                  config=test_config().consensus,
                                  evidence=True)
                 for i, pv in enumerate(pvs)]
        for i, node in enumerate(nodes):
            real = node.app.finalize_block

            async def finalize(req, real=real, i=i):
                seen[i].extend((req.height, m) for m in req.misbehavior)
                return await real(req)
            node.app.finalize_block = finalize
        real_add = nodes[0].evpool._add_pending

        def add_pending(ev):
            found.append((ev, nodes[0].block_store.height))
            real_add(ev)
        nodes[0].evpool._add_pending = add_pending
        try:
            await _sock_mesh(nodes)
            sub = nodes[0].bus.subscribe("chip-smoke-ev",
                                         EVENT_QUERY_NEW_BLOCK,
                                         out_capacity=1000)
            for node in nodes:
                await node.cs.start()
            await _cs_new_block(nodes[0], sub, 2)
            reports = []
            deadline = time.perf_counter() + 60
            while not found:
                rs = nodes[0].cs.rs
                h, r = rs.height, rs.round
                vote = Vote(type=PREVOTE_TYPE, height=h, round=r,
                            block_id=BlockID(
                                hashlib.sha256(b"%d/%d" % (seed, h)).digest(),
                                PartSetHeader(1, bytes(32))),
                            timestamp=Timestamp(EXEC_T0 + h, 3),
                            validator_address=pvs[3].get_pub_key().address(),
                            validator_index=3)
                vote.signature = pvs[3].priv_key.sign(
                    vote.sign_bytes(doc.chain_id))
                nodes[0].cs.send_peer(VoteMessage(vote), "equivocation")
                reports.append(h)
                until = nodes[0].block_store.height + 3
                while not found and nodes[0].block_store.height < until:
                    for node in nodes:
                        node.cs.raise_if_failed()
                        node.evidence_reactor.raise_if_failed()
                    if time.perf_counter() > deadline:
                        raise AssertionError("14b: no evidence in 60 s")
                    await asyncio.sleep(0.005)
            ev = found[0][0]
            while not all(node.evpool._is_committed(ev) for node in nodes):
                for node in nodes:
                    node.cs.raise_if_failed()
                    node.evidence_reactor.raise_if_failed()
                if time.perf_counter() > deadline:
                    raise AssertionError("14b: the evidence was not "
                                         "committed everywhere in 60 s")
                await asyncio.sleep(0.005)
            top = min(node.block_store.height for node in nodes)
            await _cs_until(nodes[0], lambda: all(
                nd.block_store.height >= top + 1 for nd in nodes),
                "every node one height on")
        finally:
            await _sock_stop(nodes)
        return nodes, reports, top

    nodes, reports, top = loop.run_until_complete(run())
    ev, pending_at = found[0]
    committed_at = [h for h in range(1, top + 1) if any(
        e.hash() == ev.hash()
        for e in nodes[0].block_store.load_block(h).evidence)]
    if len(committed_at) != 1:
        raise AssertionError(f"14b: the evidence is in blocks {committed_at}")
    for i in range(n):
        hits = [h for h, m in seen[i]
                if m.validator.address == ev.vote_a.validator_address]
        if hits != committed_at:
            raise AssertionError(f"14b: node {i}'s app saw the misbehavior "
                                 f"at {hits}, not {committed_at}")
    for h in range(1, top + 1):
        if len({nd.block_store.load_block(h).header.app_hash
                for nd in nodes}) != 1:
            raise AssertionError(f"14b: the app hashes differ at {h}")
    ev_bytes = _p2p_metrics_bytes([nd.switch for nd in nodes],
                                  "message_send_bytes_total", ("0x38",))
    _log(f"evidence_dup_{n} validator 3's second prevote reported to node 0 "
         f"at height {reports[-1]} ({len(reports)} report(s)); "
         f"DuplicateVoteEvidence pending on node 0 after height "
         f"{pending_at}, committed in block {committed_at[0]} "
         f"({committed_at[0] - reports[-1]} heights from the report); every "
         f"pool marks it committed, every app saw the misbehavior once in "
         f"FinalizeBlock, app hashes agree to height {top}; 0x38 bytes sent "
         f"by the four nodes {ev_bytes['0x38']:.0f}; B1 launches "
         f"{ek.launches}; card: {card}")
    return ek.launches, {"ev": ev, "node": nodes[0]}


def _evidence_lca(seed, card, ek, tracing, device, keep, joiner):
    """14b(ii): a lunatic light-client attack at config 4's width, judged
    against 14a's joiner stores: a conflicting header at LCA_CONFLICT
    with a forged validator set of the fewest common-set validators that
    hold more than a third of its power, all of them signing.  Returns
    B1 launches."""
    import dataclasses
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.evidence import EvidenceError, EvidencePool
    from cometbft_tpu_torch.types.block import LightBlock, SignedHeader
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.canonical import (
        PRECOMMIT_TYPE, vote_sign_bytes_template)
    from cometbft_tpu_torch.types.commit import Commit, CommitSig
    from cometbft_tpu_torch.types.evidence import LightClientAttackEvidence
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.validator import Validator
    from cometbft_tpu_torch.types.validator_set import ValidatorSet
    from cometbft_tpu_torch.types.vote import BLOCK_ID_FLAG_COMMIT
    chain, n = keep["chain"], EXEC_VALIDATORS
    ss, bs = joiner.state_store, joiner.block_store
    common = ss.load_validators(LCA_COMMON)
    total = common.total_voting_power()
    k, power = 0, 0
    while 3 * power <= total:
        power += common.validators[k].voting_power
        k += 1
    _phase(f"14b(ii) evidence-lca-{n}: a lunatic attack on 14a's joiner "
           f"stores — a header at {LCA_CONFLICT} signed by a forged set of "
           f"{k} of the {common.size()} validators of height {LCA_COMMON} "
           f"({power} of {total} power), verified by the pool on B1")
    forged = ValidatorSet([Validator.new(v.pub_key, v.voting_power)
                           for v in common.validators[:k]])
    meta = bs.load_block_meta(LCA_CONFLICT)
    header = dataclasses.replace(
        meta.header, validators_hash=forged.hash(),
        next_validators_hash=forged.hash(), app_hash=b"\xee" * 32)
    block_id = BlockID(header.hash(), PartSetHeader(1, b"\xab" * 32))
    make = vote_sign_bytes_template(chain.chain_id, PRECOMMIT_TYPE,
                                    LCA_CONFLICT, 0, block_id)
    stamps = [Timestamp(EXEC_T0 + LCA_CONFLICT, 7 + i) for i in range(k)]
    sigs = _Signer().sign([(chain.seed_of[v.address], make(stamps[i]))
                           for i, v in enumerate(forged.validators)])
    commit = Commit(LCA_CONFLICT, 0, block_id, [
        CommitSig(BLOCK_ID_FLAG_COMMIT, v.address, stamps[i], sigs[i])
        for i, v in enumerate(forged.validators)])
    conflicting = LightBlock(SignedHeader(header, commit), forged)
    trusted = SignedHeader(bs.load_block_meta(LCA_CONFLICT).header,
                           bs.load_block_commit(LCA_CONFLICT))
    ev = LightClientAttackEvidence(
        conflicting_block=conflicting, common_height=LCA_COMMON,
        total_voting_power=total,
        timestamp=bs.load_block_meta(LCA_COMMON).header.time)
    ev.byzantine_validators = ev.get_byzantine_validators(common, trusted)
    _clear_memos()
    tracing.clear()
    l0 = ek.launches
    pool = EvidencePool(MemDB(), ss, bs, device=device)
    t = time.perf_counter()
    pool.add_evidence(ev)
    ms = (time.perf_counter() - t) * 1e3
    launches = ek.launches - l0
    lanes = [e["attrs"]["batch"]
             for e in tracing.snapshot(category=tracing.CRYPTO)
             if e["name"] == "batch_verify"]
    if [e.hash() for e in pool.all_pending()] != [ev.hash()] or \
            len(ev.byzantine_validators) != k or launches != 2:
        raise AssertionError(f"14b: the attack was not admitted on B1 "
                             f"({launches} launches)")
    bad = dataclasses.replace(
        ev, byzantine_validators=ev.byzantine_validators[:1])
    want = f"expected {k} byzantine validators, got 1"
    _expect_rejection(lambda: EvidencePool(MemDB(), ss, bs, device=device)
                      .add_evidence(bad), EvidenceError, want)
    _log(f"evidence_lca_{n} a lunatic attack (common height {LCA_COMMON}, "
         f"conflicting {LCA_CONFLICT}, {k} byzantine validators) verified "
         f"by add_evidence in {ms:.2f} ms with {launches} B1 launches "
         f"(verify_commit_light_trusting on the common set, then "
         f"verify_commit_light on the forged set), lanes a launch "
         f"{sorted(collections.Counter(lanes).items())}; a tampered "
         f"attribution refused: EvidenceError {want!r}; card: {card}")
    return launches


def _mempool_net(seed, card, ek, tracing, device, loop):
    """14c: 13a's net again, each node with a CListMempool at the
    MempoolConfig defaults (have/want gossip, incremental recheck), a
    MempoolReactor and its mempool in the BlockExecutor; loadtime
    payloads submitted round-robin through CheckTx.  The consensus
    timeouts are ConsensusConfig's defaults (propose 3 s, votes 1 s):
    under the JAX test_config's 40 / 10 ms, blocks of 1 KB txs cannot
    cross the sockets inside a round, and the net stops committing.
    Returns B1 launches."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.mempool import MempoolError
    from cometbft_tpu_torch.mempool import reactor as mreactor
    from cometbft_tpu_torch.tools.loadtime import (
        Stats, payload_bytes, payload_from_tx)
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    n, cfg = SOCK_VALIDATORS, Config()
    mcfg = cfg.mempool
    _phase(f"14c mempool-{n}x{MEMPOOL_HEIGHTS}: 13a's net with the default "
           f"ConsensusConfig timeouts, each node with a "
           f"CListMempool (MempoolConfig defaults) and a MempoolReactor; "
           f"{LOAD_RATE} tx/s of {LOAD_TX_BYTES}-byte loadtime payloads for "
           f"{LOAD_SECONDS:.0f} s, round-robin through CheckTx, then until "
           f"every pool drains and {MEMPOOL_HEIGHTS} heights are committed")
    doc, pvs = _net_doc(seed + 143, n, "mempool-chip")
    exp = f"chip-smoke-{seed}"
    _clear_memos()
    ek.launches = 0
    wire = collections.Counter()
    real_encode = mreactor.encode_mempool

    def counting(msg):
        raw = real_encode(msg)
        wire[type(msg).__name__] += len(raw)
        return raw

    async def run():
        nodes = [await _sock_node(doc, device, _seed(seed + 144, i), pv=pv,
                                  config=cfg.consensus, mempool_config=mcfg)
                 for i, pv in enumerate(pvs)]
        blocks, stamps = {}, []
        accepted, refused = [], collections.Counter()
        col = None
        try:
            await _sock_mesh(nodes)
            sub = nodes[0].bus.subscribe("chip-smoke-mp",
                                         EVENT_QUERY_NEW_BLOCK,
                                         out_capacity=100_000)

            async def collect():
                while True:
                    msg = await sub.next()
                    blocks[msg.data.payload["block"].header.height] = \
                        time.time_ns()
                    stamps.append(time.perf_counter())
            col = asyncio.ensure_future(collect())
            for node in nodes:
                await node.cs.start()
            t0 = time.perf_counter()
            for i in range(int(LOAD_RATE * LOAD_SECONDS)):
                delay = t0 + i / LOAD_RATE - time.perf_counter()
                if delay > 0:
                    await asyncio.sleep(delay)
                tx = payload_bytes(exp, size=LOAD_TX_BYTES, rate=LOAD_RATE,
                                   connections=n)
                try:
                    await nodes[i % n].mempool.check_tx(tx)
                    accepted.append(tx)
                except MempoolError as e:
                    refused[type(e).__name__] += 1
                if i % 40 == 0:
                    for node in nodes:
                        node.cs.raise_if_failed()
            send_s = time.perf_counter() - t0
            await _cs_until(nodes[0], lambda: all(
                nd.mempool.size() == 0 and
                nd.block_store.height >= MEMPOOL_HEIGHTS for nd in nodes),
                "every mempool drained", timeout_s=120.0)
            top = min(nd.block_store.height for nd in nodes)
            await _cs_until(nodes[0], lambda: max(blocks, default=0) >= top,
                            "node 0's NewBlock for the last height")
        finally:
            if col is not None:
                col.cancel()
            await _sock_stop(nodes)
        return nodes, blocks, stamps, accepted, refused, send_s, top

    mreactor.encode_mempool = counting
    try:
        nodes, blocks, stamps, accepted, refused, send_s, top = \
            loop.run_until_complete(run())
    finally:
        mreactor.encode_mempool = real_encode
    # the gates: every accepted tx committed exactly once on every node,
    # the app hashes agree, every pool drained
    want = collections.Counter(accepted)
    latency, per_block, committed_ns = [], [], []
    for i, node in enumerate(nodes):
        got = collections.Counter()
        for h in range(1, node.block_store.height + 1):
            txs = node.block_store.load_block(h).data.txs
            got.update(txs)
            if i == 0 and h <= top:
                per_block.append(len(txs))
                for tx in txs:
                    p = payload_from_tx(tx)
                    if p is not None and p["id"] == exp:
                        latency.append((blocks[h] - p["time_ns"]) / 1e9)
                        committed_ns.append(blocks[h])
        if got != want:
            raise AssertionError(f"14c: node {i} committed "
                                 f"{sum(got.values())} txs, "
                                 f"{len(set(got) ^ set(want))} not as "
                                 f"submitted, or a tx twice")
    for h in range(1, top + 1):
        if len({nd.block_store.load_block(h).header.app_hash
                for nd in nodes}) != 1:
            raise AssertionError(f"14c: the app hashes differ at {h}")
    first_ns = min(payload_from_tx(tx)["time_ns"] for tx in accepted)
    tps = len(accepted) / ((max(committed_ns) - first_ns) / 1e9)
    lat = Stats.from_samples(latency)
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    m = [nd.cs.metrics for nd in nodes]
    mp = [nd.mempool.metrics for nd in nodes]
    recv = sum(x.gossip_txs_received.value for x in mp)
    dup = sum(x.gossip_txs_duplicate.value for x in mp)
    sent = _p2p_metrics_bytes([nd.switch for nd in nodes],
                              "message_send_bytes_total", ("0x30",))["0x30"]
    _log(f"mempool_{n}x{MEMPOOL_HEIGHTS} {len(accepted)} txs accepted of "
         f"{len(accepted) + sum(refused.values())} submitted in {send_s:.2f} "
         f"s (refused: {dict(refused)}); committed {tps:.1f} tx/s; latency "
         f"submit to committing block (node 0's NewBlock) p50 "
         f"{lat.p50_s * 1e3:.1f} ms, p90 {lat.p90_s * 1e3:.1f} ms, max "
         f"{lat.max_s * 1e3:.1f} ms; {top} heights, ms a height "
         f"{_p50_p90(ms)}, txs a block {_p50_p90(per_block)} max "
         f"{max(per_block)}; card: {card}")
    _log(f"mempool_{n}x{MEMPOOL_HEIGHTS} compact proposals sent "
         f"{sum(x.compact_blocks_sent.value for x in m):.0f}, rebuilt from "
         f"the mempool "
         f"{sum(x.compact_blocks_reconstructed.value for x in m):.0f}, "
         f"misses (nacked to parts) "
         f"{sum(x.compact_block_misses.value for x in m):.0f}, mismatches "
         f"{sum(x.compact_block_mismatches.value for x in m):.0f}; 0x30 bytes "
         f"sent {sent:.0f}: Txs {wire['TxsMessage']}, TxHave "
         f"{wire['TxHaveMessage']}, TxWant {wire['TxWantMessage']}; "
         f"duplicate-receive ratio {dup / max(recv, 1):.3f} ({dup:.0f} of "
         f"{recv:.0f}); B1 launches {ek.launches}; every accepted tx "
         f"committed once on every node, app hashes agree, every pool at 0")
    return ek.launches


class _CappedStore:
    """A block store seen up to ``cap``: what a server at that height
    serves a block-syncing peer."""

    def __init__(self, store, cap):
        self._store, self._cap = store, cap

    @property
    def height(self):
        return self._cap

    @property
    def base(self):
        return self._store.base

    def load_block(self, h):
        return self._store.load_block(h) if h <= self._cap else None

    def load_block_ext_commit(self, h):
        return self._store.load_block_ext_commit(h) if h <= self._cap \
            else None


async def _bsync_server(chain, key_seed, cap, device, bad_height=0):
    """A Switch with a passive BlocksyncReactor over the twin's stores seen
    up to ``cap``; with ``bad_height``, the block served there carries a
    LastCommit with one signature bit flipped."""
    from cometbft_tpu_torch.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.blocksync.reactor import (
        BLOCKSYNC_CHANNEL, MESSAGE)
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.p2p import NodeKey, Switch
    from cometbft_tpu_torch.wire import encode
    store = _CappedStore(chain.block_store, cap)
    reactor = BlocksyncReactor(chain.state, chain.exec, store, active=False,
                               device=device)
    if bad_height:
        real = reactor._respond_to_block_request

        def respond(peer, height):
            if height != bad_height:
                return real(peer, height)
            block = store.load_block(height)
            sig = block.last_commit.signatures[0]
            sig.signature = bytes([sig.signature[0] ^ 1]) + sig.signature[1:]
            peer.send(BLOCKSYNC_CHANNEL, encode(MESSAGE, {
                "block_response": {"block": block.to_proto()}}))
        reactor._respond_to_block_request = respond
    sw = Switch(NodeKey(Ed25519PrivKey(key_seed)), chain.chain_id,
                listen_addr="127.0.0.1:0")
    sw.add_reactor(reactor)
    await sw.start()
    return sw


async def _bsync_joiner(chain, key_seed, device):
    """A fresh node from genesis with a Switch and an active
    BlocksyncReactor (no switch to consensus: ``on_caught_up`` unset)."""
    from cometbft_tpu_torch.blocksync import BlocksyncReactor
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.p2p import NodeKey, Switch
    node = await _CsNode.make(chain.doc, device)
    node.states = {}
    real_save = node.state_store.save

    def save(state):
        node.states[state.last_block_height] = state.bytes()
        real_save(state)
    node.state_store.save = save
    node.bsync = BlocksyncReactor(node.state_store.load(), node.exec,
                                  node.block_store, active=True,
                                  device=device)
    node.switch = Switch(NodeKey(Ed25519PrivKey(key_seed)), chain.chain_id,
                         listen_addr="127.0.0.1:0")
    node.switch.add_reactor(node.bsync)
    await node.switch.start()
    return node


async def _bsync_until(node, pred, what, timeout_s=60.0):
    deadline = time.perf_counter() + timeout_s
    while not pred():
        node.bsync.raise_if_failed()
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: not reached in {timeout_s} s (at "
                                 f"{node.block_store.height})")
        await asyncio.sleep(0.005)


def _bsync_reject(seed, card, ek, ek8, oe, device, loop, keep, dup):
    """14d: a server whose block carries a bad LastCommit signature, the
    evidence and mempool refusals, a sync under cuda8 and a raising
    stand-in kernel in the joiner's sync routine.  Returns (B1 launches,
    B2 launches)."""
    import dataclasses
    from cometbft_tpu_torch.abci.client import AppConns
    from cometbft_tpu_torch.abci.kvstore import (
        DEFAULT_LANES, KVStoreApplication)
    from cometbft_tpu_torch.config import MempoolConfig
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.evidence import EvidenceError, EvidencePool
    from cometbft_tpu_torch.mempool import CListMempool, MempoolError
    from cometbft_tpu_torch.mempool.mempool import (
        MempoolFullError, TxInCacheError)
    chain, depth = keep["chain"], BSYNC_REJECT_HEIGHTS
    _phase(f"14d bsync-reject: a server whose block {BSYNC_BAD_HEIGHT + 1} "
           f"carries a flipped LastCommit signature bit, evidence and "
           f"mempool refusals, a {depth}-height sync under cuda8 and a "
           f"raising stand-in kernel in a joiner's sync routine")
    out = []
    _clear_memos()
    l0 = ek.launches

    def check_states(node, what):
        for h in range(1, depth + 1):
            if node.states.get(h) != chain.states[h]:
                raise AssertionError(f"14d: {what}: the State at {h} != the "
                                     f"twin's")

    async def bad_then_honest():
        bad = await _bsync_server(chain, _seed(seed + 145, 0), depth + 1,
                                  device, bad_height=BSYNC_BAD_HEIGHT + 1)
        good = await _bsync_server(chain, _seed(seed + 145, 1), depth + 1,
                                   device)
        joiner = await _bsync_joiner(chain, _seed(seed + 145, 2), device)
        bans, redos = [], []
        real_ban = joiner.bsync._ban_peer

        def ban(peer_id, reason):
            bans.append((peer_id, reason))
            real_ban(peer_id, reason)
        joiner.bsync._ban_peer = ban
        try:
            await joiner.bsync.start_sync()
            real_redo = joiner.bsync.pool.redo_request

            def redo(height, reason):
                redos.append(height)
                real_redo(height, reason)
            joiner.bsync.pool.redo_request = redo
            bad_peer = await joiner.switch.dial_peer(bad.listen_addr)
            await _bsync_until(joiner, lambda: bans and
                               bad_peer.id not in joiner.switch.peers,
                               "14d: the ban of the bad server")
            stalled = joiner.block_store.height
            await joiner.switch.dial_peer(good.listen_addr)
            await _bsync_until(joiner, lambda: joiner.block_store.height >=
                               depth, "14d: the sync from the honest server")
            await joiner.bsync.stop_sync()
        finally:
            for sw in (joiner.switch, bad, good):
                await sw.stop()
        return joiner, bad_peer.id, bans, redos, stalled

    joiner, bad_id, bans, redos, stalled = loop.run_until_complete(
        bad_then_honest())
    check_states(joiner, "the sync past the bad server")
    if redos[:2] != [BSYNC_BAD_HEIGHT, BSYNC_BAD_HEIGHT + 1] or \
            {p for p, _ in bans} != {bad_id} or \
            stalled != BSYNC_BAD_HEIGHT - 1:
        raise AssertionError(f"14d: redos {redos}, bans {bans}, stalled at "
                             f"{stalled}")
    out.append(f"bad LastCommit signature in block {BSYNC_BAD_HEIGHT + 1}: "
               f"the joiner stopped at {stalled}, redid heights "
               f"{redos[:2]}, banned the server with reason "
               f"{bans[0][1]!r}, then synced {depth} heights from the "
               f"honest server, its States the twin's")

    # evidence refusals on 14b's chain
    ev, node = dup["ev"], dup["node"]

    def pool():
        return EvidencePool(MemDB(), node.state_store, node.block_store,
                            device=device)
    vals = node.state_store.load_validators(ev.height)
    wrong = dataclasses.replace(ev, total_voting_power=ev.total_voting_power
                                + 1)
    want = (f"total voting power mismatch: {wrong.total_voting_power} vs "
            f"{vals.total_voting_power()}")
    _expect_rejection(lambda: pool().add_evidence(wrong), EvidenceError, want)
    out.append(f"evidence with the wrong total power: EvidenceError {want!r}")
    want = "evidence was already committed"
    _expect_rejection(lambda: node.evpool.check_evidence([ev]),
                      EvidenceError, want)
    out.append(f"committed evidence in a block: EvidenceError {want!r}")
    old = pool()
    state = node.state_store.load()
    params = state.consensus_params
    old.state = dataclasses.replace(
        state, consensus_params=dataclasses.replace(
            params, evidence=dataclasses.replace(
                params.evidence, max_age_num_blocks=1,
                max_age_duration_ns=1)))
    want = f"evidence from height {ev.height} is too old"
    _expect_rejection(lambda: old.add_evidence(ev), EvidenceError, want)
    out.append(f"expired evidence: EvidenceError {want!r}")

    # mempool refusals
    async def mempool_cases():
        mp = CListMempool(MempoolConfig(size=2, max_tx_bytes=64),
                          AppConns(KVStoreApplication()).mempool,
                          lanes=DEFAULT_LANES, default_lane="default")
        await mp.check_tx(b"a=1")
        await mp.check_tx(b"b=2")
        res = []
        for tx, exc, text in (
                (b"a=1", TxInCacheError, "tx already exists in cache"),
                (b"d=" + b"x" * 63, MempoolError, "tx too large: 65 > 64"),
                (b"c=3", MempoolFullError,
                 "mempool is full: 2 txs, 6 bytes")):
            try:
                await mp.check_tx(tx)
            except MempoolError as e:
                if type(e) is not exc or str(e) != text:
                    raise AssertionError(f"14d: {type(e).__name__} {e}")
                res.append(f"{exc.__name__} {text!r}")
                continue
            raise AssertionError(f"14d: the mempool took {tx[:8]!r}")
        return res
    for line in loop.run_until_complete(mempool_cases()):
        out.append(f"mempool refuses: {line}")

    # one sync under cuda8: the same States as under B1
    async def sync8():
        good = await _bsync_server(chain, _seed(seed + 146, 0), depth + 1,
                                   device)
        joiner = await _bsync_joiner(chain, _seed(seed + 146, 1), device)
        try:
            await joiner.bsync.start_sync()
            await joiner.switch.dial_peer(good.listen_addr)
            await _bsync_until(joiner, lambda: joiner.block_store.height >=
                               depth, "14d: the cuda8 sync")
            await joiner.bsync.stop_sync()
        finally:
            await joiner.switch.stop()
            await good.stop()
        return joiner

    _clear_memos()
    b1, ek8.launches = ek.launches, 0
    os.environ[oe.KERNEL_ENV] = "cuda8"
    try:
        joiner8 = loop.run_until_complete(sync8())
    finally:
        os.environ.pop(oe.KERNEL_ENV, None)
    launches8, b1_in_8 = ek8.launches, ek.launches - b1
    check_states(joiner8, "the cuda8 sync")
    if b1_in_8 or launches8 < 2 * (depth - 1):
        raise AssertionError(f"14d: cuda8 sync launched B1 {b1_in_8}, B2 "
                             f"{launches8}")
    out.append(f"{depth}-height sync under cuda8: {launches8} B2 launches, "
               f"0 B1, its States equal the B1 sync's")

    # a kernel that raises in the joiner's sync routine stops the sync
    async def raising_sync():
        good = await _bsync_server(chain, _seed(seed + 147, 0), depth + 1,
                                   device)
        joiner = await _bsync_joiner(chain, _seed(seed + 147, 1), device)
        err = None
        try:
            await joiner.bsync.start_sync()
            task = joiner.bsync._tasks[0]
            await joiner.switch.dial_peer(good.listen_addr)
            deadline = time.perf_counter() + 30
            while joiner.bsync.failure is None:
                if time.perf_counter() > deadline:
                    raise AssertionError("14d: the raising kernel was never "
                                         "reached")
                await asyncio.sleep(0.005)
            await asyncio.sleep(0.5)
            running = joiner.bsync.pool.is_running
            try:
                await joiner.bsync.stop_sync()
            except RuntimeError as e:
                err = e
        finally:
            await joiner.switch.stop()
            await good.stop()
        return joiner, task, running, err

    real_kernel = ek.verify_cols

    def raising(*a, **kw):
        raise RuntimeError("stand-in kernel failure (14d)")

    _clear_memos()
    ek.verify_cols = raising
    try:
        joiner_r, task, running, err = loop.run_until_complete(
            raising_sync())
    finally:
        ek.verify_cols = real_kernel
    if err is None or "stand-in kernel failure" not in str(err) or \
            task.restarts != 0 or not task.gave_up or running or \
            joiner_r.block_store.height != 0:
        raise AssertionError(f"14d: the raising kernel was hidden: {err!r}, "
                             f"{task.restarts} restarts")
    out.append(f"raising kernel in the sync routine: the sync stopped at "
               f"height 0, 0 restarts, the pool stopped, stop_sync() raised "
               f"RuntimeError {str(err)!r}")
    for line in out:
        _log(f"bsync_reject {line}")
    _log(f"bsync_reject all {len(out)} cases as the JAX package decides "
         f"them; card: {card}")
    return ek.launches - l0 - b1_in_8, launches8


def _sync_phases(seed, card, keep, device=None):
    """Phases 14a-14d: block sync, evidence and the mempool (blocksync/,
    evidence/, mempool/, light/provider.NodeProvider, tools/loadtime).
    ``keep`` holds what phases 12 and 13 leave: the twin chain with its
    states, 13b's server stores and its ms a height.  Returns B1's
    launches by part and B2's."""
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    t_phase = time.perf_counter()
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        bsync, joiner = _bsync_chain(seed, card, ek, tracing, device, loop,
                                     keep)
        dup, dup_keep = _evidence_dup(seed, card, ek, device, loop)
        lca = _evidence_lca(seed, card, ek, tracing, device, keep, joiner)
        mempool = _mempool_net(seed, card, ek, tracing, device, loop)
        reject, reject8 = _bsync_reject(seed, card, ek, ek8, oe, device,
                                        loop, keep, dup_keep)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
    _log(f"phase 14 took {time.perf_counter() - t_phase:.1f} s")
    return ({f"blocksync_{EXEC_VALIDATORS}x{CS_HEIGHTS}": bsync,
             f"evidence_dup_{SOCK_VALIDATORS}": dup,
             f"evidence_lca_{EXEC_VALIDATORS}": lca,
             f"mempool_{SOCK_VALIDATORS}x{MEMPOOL_HEIGHTS}": mempool,
             "bsync_reject": reject},
            {f"bsync_{BSYNC_REJECT_HEIGHTS}_cuda8": reject8})


# -- phase 15: state sync and pruning -----------------------------------------

def _keyed_tx(seed: int, h: int, j: int) -> bytes:
    """_load_tx's tx of EXEC_TX_BYTES under its own key "h.j" (not "a"),
    so a height adds EXEC_TXS pairs to the app's state."""
    tx = _load_tx(seed, h, j)
    key = b"%d.%d" % (h, j)
    return key + tx[1:len(tx) - len(key) + 1]


class _HostSigner(_Signer):
    """_Signer's interface on the port's host ed25519 library: RFC 8032
    signing is deterministic, so its signatures are the golden model's."""

    def __init__(self):
        super().__init__(None)
        self._keys = {}

    def _key(self, seed):
        from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
        key = self._keys.get(seed)
        if key is None:
            key = self._keys[seed] = Ed25519PrivKey(seed)
        return key

    def pubs(self, seeds):
        return [self._key(s).pub_key().bytes() for s in seeds]

    def sign(self, jobs):
        t0 = time.perf_counter()
        out = [self._key(s).sign(m) for s, m in jobs]
        self.signed += len(jobs)
        self.seconds += time.perf_counter() - t0
        return out


class _Stages:
    """Each stage's wall time, B1 launches and verify_batch sizes (the
    lanes of each batch), by name; stages nest, and a batch counts in the
    innermost one.  ``wrap`` makes an object's coroutine method a stage."""

    def __init__(self, ek):
        self.ek, self.cur, self.rows = ek, None, {}

    @contextlib.contextmanager
    def stage(self, name):
        row = self.rows.setdefault(name, {"ms": 0.0, "launches": 0,
                                          "lanes": [], "calls": 0})
        prev, self.cur = self.cur, name
        l0, t0 = self.ek.launches, time.perf_counter()
        row.setdefault("first", t0)
        try:
            yield row
        finally:
            row["ms"] += (time.perf_counter() - t0) * 1e3
            row["launches"] += self.ek.launches - l0
            row["calls"] += 1
            self.cur = prev

    def wrap(self, obj, name, stage):
        real = getattr(obj, name)

        async def staged(*a, **kw):
            with self.stage(stage if isinstance(stage, str)
                            else stage(*a, **kw)):
                return await real(*a, **kw)
        setattr(obj, name, staged)

    @contextlib.contextmanager
    def batches(self, oe):
        """Record the size of each verify_batch call under the current
        stage while the block runs."""
        real = oe.verify_batch

        def verify_batch(items, *a, **kw):
            if self.cur is not None:
                self.rows[self.cur]["lanes"].append(len(items))
            return real(items, *a, **kw)
        oe.verify_batch = verify_batch
        try:
            yield
        finally:
            oe.verify_batch = real

    def line(self, name) -> str:
        row = self.rows.get(name)
        if row is None:
            return f"{name} not run"
        return (f"{name} {row['ms']:.1f} ms ({row['calls']} call(s)), B1 "
                f"launches {row['launches']}, batch sizes {row['lanes']}")


def _ss_source(seed, card, ek, device, loop):
    """15a's source: config 4's 150 validators through _ExecChain over a
    kvstore with snapshot_interval SS_INTERVAL and retain_blocks
    SS_RETAIN, a Pruner wired to its executor as the JAX node wires one
    (cometbft_tpu/node/node.py:307-316, :369) and run as its service on
    the same event loop; SS_HEIGHTS heights of EXEC_TXS txs of
    EXEC_TX_BYTES bytes, each under its own key, and 11a's val= txs at
    EXEC_UPDATES.  The genesis lies SS_LEAD_S before now, so the light
    client's trusting period and clock drift hold for every header.
    Returns what 15a-15c read of it."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.state.pruner import Pruner
    n, top = EXEC_VALIDATORS, SS_HEIGHTS
    signer = _HostSigner()
    chain = _ExecChain(SS_CHAIN_ID, [_seed(seed + 150, i) for i in range(n)],
                       signer, device=device,
                       t0=int(time.time()) - SS_LEAD_S)
    chain.app.snapshot_interval = SS_INTERVAL
    chain.app.retain_blocks = SS_RETAIN
    updates = _exec_updates(seed, chain, signer)
    pruner = Pruner(chain.state_store, chain.block_store, MemDB(),
                    interval_s=Config().storage.pruning_interval_ns / 1e9,
                    metrics=chain.exec.metrics)
    chain.exec.pruner = pruner
    passes, roots, states, host_ms = [], {}, {}, []
    real_prune = pruner.prune_once

    def prune_once():
        t = time.perf_counter()
        out = real_prune()
        passes.append((out[0], (time.perf_counter() - t) * 1e3))
        return out
    pruner.prune_once = prune_once
    tree_ms, snap_ms = [], []
    for obj, name, out in ((chain.app.tree, "prune", tree_ms),
                           (chain.app, "_serialize_state", snap_ms)):
        real = getattr(obj, name)

        def timed(*a, real=real, out=out, **kw):
            t = time.perf_counter()
            res = real(*a, **kw)
            out.append((time.perf_counter() - t) * 1e3)
            return res
        setattr(obj, name, timed)

    async def build():
        await pruner.start()
        for h in range(1, top + 1):
            txs = [_keyed_tx(seed, h, j) for j in range(EXEC_TXS)]
            if h in updates:
                txs[-1] = updates[h]
            _, host_s = await chain.astep(txs)
            host_ms.append(host_s * 1e3)
            roots[h] = chain.app.tree.root(h)
            states[h] = (chain.state.last_block_height, chain.state.app_hash)
            await asyncio.sleep(0)          # the pruner's pass for h
        deadline = time.perf_counter() + 30
        while chain.block_store.base != chain.exec.last_retain_height:
            if time.perf_counter() > deadline:
                raise AssertionError(
                    f"15b: the pruner left the base at "
                    f"{chain.block_store.base}, the app's retain height is "
                    f"{chain.exec.last_retain_height}")
            await asyncio.sleep(0.005)
        await pruner.stop()

    ek.launches = 0
    t0 = time.perf_counter()
    loop.run_until_complete(build())
    build_s = time.perf_counter() - t0
    snaps = sorted(chain.app._snapshots)
    chunk = len(chain.app._snapshots[snaps[-1]])
    _log(f"statesync_source_{n}x{top} built in {build_s:.2f} s ({top} "
         f"heights, ms a height {_p50_p90(host_ms)} with signing left out, "
         f"{signer.signed} signatures in {signer.seconds:.2f} s on the host "
         f"ed25519), B1 launches {ek.launches} (validate_block's one a "
         f"height); app pairs at {top} {len(chain.app.tree.pairs())}, "
         f"snapshots at {snaps}, the one chunk of {snaps[-1]} is {chunk} "
         f"bytes ({chunk / 2**20:.2f} MiB, recv_message_capacity 22 MiB), "
         f"each snapshot's JSON in Commit ms {_p50_p90(snap_ms)}; card: "
         f"{card}")
    return {"chain": chain, "pruner": pruner, "passes": passes,
            "roots": roots, "states": states, "launches": ek.launches,
            "chunk_bytes": chunk, "tree_ms": tree_ms}


def _ss_light_client(chain, device, primary=None):
    """The joiner's light client as the JAX new_rpc_state_provider makes
    it (skipping verification, a TrustedStore on MemDB, StateSyncConfig's
    trusting period), over the source's stores: a NodeProvider as primary
    and one as witness, the trust root at SS_TRUST with its hash read from
    the source's block store (the operator's out-of-band step)."""
    from cometbft_tpu_torch.config import StateSyncConfig
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.provider import NodeProvider
    from cometbft_tpu_torch.light.store import TrustedStore
    trust_hash = chain.block_store.load_block_meta(SS_TRUST).block_id.hash
    if primary is None:
        primary = NodeProvider(chain.block_store, chain.state_store,
                               chain.chain_id)
    witness = NodeProvider(chain.block_store, chain.state_store,
                           chain.chain_id)
    return Client(chain.chain_id,
                  TrustOptions(period_ns=StateSyncConfig().trust_period_ns,
                               height=SS_TRUST, header_hash=trust_hash),
                  primary, [witness], TrustedStore(MemDB()), device=device)


def _ss_syncer(node, sp, cfg, logger=None):
    """A Syncer and an active StatesyncReactor for ``node``, wired as the
    JAX node wires them (node.py:479-495)."""
    from cometbft_tpu_torch.statesync import StatesyncReactor, Syncer
    node.syncer = Syncer(
        node.conns, sp,
        request_chunk=lambda snap, i: node.ss.request_chunk(snap, i),
        chunk_timeout_s=cfg.statesync.chunk_request_timeout_ns / 1e9,
        chunk_dir=cfg.statesync.temp_dir or None, logger=logger)
    node.ss = StatesyncReactor(node.conns, node.syncer)
    return [node.ss]


async def _ss_bootstrap(node, cfg, discovery_ns=None):
    """The JAX node's state-sync tail (node.py:528-547): sync_any, the
    state store's bootstrap and the seen commit, the block-sync reactor
    given the synced state; returns (state, commit)."""
    ns = cfg.statesync.discovery_time_ns if discovery_ns is None \
        else discovery_ns
    new_state, commit = await node.syncer.sync_any(ns / 1e9)
    node.state_store.bootstrap(new_state)
    node.block_store.save_seen_commit_standalone(commit)
    if getattr(node, "bsync", None) is not None:
        node.bsync.state = new_state
    node.ss.metrics.syncing.set(0)
    return new_state, commit


async def _ss_snapshot_server(conns, key_seed, chain_id):
    """A Switch serving ``conns.snapshot``'s snapshots through a passive
    StatesyncReactor, and nothing else."""
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.p2p import NodeKey, Switch
    from cometbft_tpu_torch.statesync import StatesyncReactor
    sw = Switch(NodeKey(Ed25519PrivKey(key_seed)), chain_id,
                listen_addr="127.0.0.1:0")
    sw.add_reactor(StatesyncReactor(conns))
    await sw.start()
    return sw


def _db_rows(node):
    """The node's state-store, block-store and app rows."""
    return {k: list(db.iterator()) for k, db in node.dbs.items()}


def _ss_chain(seed, card, ek, device, loop, src, keep):
    """15a statesync-150x105: the source's stores and app behind a full
    node without a key (a StatesyncReactor with no syncer, a passive
    BlocksyncReactor, a ConsensusReactor); a fresh joiner wired as the JAX
    node wires a state-syncing one (node.py:411-558) runs sync_any over
    its light client, bootstraps, block-syncs the tail, switches to
    consensus and commits the source's top by catch-up.  Returns B1's
    launches."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.statesync import StateProvider, StatesyncReactor
    from cometbft_tpu_torch.store import store as bs
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    chain, n, top = src["chain"], EXEC_VALIDATORS, SS_HEIGHTS
    snap_h = max(chain.app._snapshots)
    _phase(f"15a statesync-{n}x{top}: the {n}-validator source of "
           f"{top} heights (snapshots every {SS_INTERVAL}, "
           f"retain_blocks {SS_RETAIN}, pruned by its Pruner) behind a "
           f"full node without a key; a fresh joiner (StatesyncReactor with "
           f"a Syncer, active BlocksyncReactor, ConsensusReactor(wait_sync), "
           f"EvidenceReactor, MempoolReactor) restores the snapshot at "
           f"{snap_h} through its light client (trust root {SS_TRUST}), "
           f"block-syncs {snap_h + 1}-{top - 1}, switches to consensus and "
           f"commits {top} by catch-up")
    cfg = Config()
    cfg.statesync.discovery_time_ns = SS_DISCOVERY_NS
    _log(f"statesync_{n}x{top} the joiner's StateSyncConfig: "
         f"discovery_time_ns {cfg.statesync.discovery_time_ns} (the JAX QA "
         f"joiner's, cometbft_tpu/tools/qa.py:374), chunk_request_timeout_ns "
         f"{cfg.statesync.chunk_request_timeout_ns}, trust_period_ns "
         f"{cfg.statesync.trust_period_ns}; P2PConfig send_rate "
         f"{cfg.p2p.send_rate} B/s")
    _clear_memos()
    stages, log, rec = _Stages(ek), {}, {"saved": {}, "launches": {}}
    gap = _LoopGap()

    async def run():
        server = await _sock_node(
            chain.doc, device, _seed(seed + 151, 0), dbs=chain.dbs,
            app=chain.app, reactors=lambda nd: _passive_bsync(nd, device) + [
                StatesyncReactor(nd.conns)])
        lc = _ss_light_client(chain, device)
        await lc.initialize()
        sp = StateProvider(lc, chain.chain_id, chain.doc)
        stages.wrap(sp, "app_hash", "app_hash(H): light blocks H+1, H+2")
        stages.wrap(sp, "state", "state(H): light blocks H, H+1, H+2")
        stages.wrap(sp, "commit", "commit(H): light block H")
        stages.wrap(lc, "verify_light_block_at_height",
                    lambda h, *a, **kw: f"light block {h}")

        def reactors(node):
            return _bsync_reactor(node, cfg, device, log) + _ss_syncer(
                node, sp, cfg)
        joiner = await _sock_node(
            chain.doc, device, _seed(seed + 151, 1), wait_sync=True,
            mempool_config=cfg.mempool, evidence=True, reactors=reactors)
        stages.wrap(joiner.conns.snapshot, "offer_snapshot", "offer")
        stages.wrap(joiner.conns.snapshot, "apply_snapshot_chunk",
                    "apply_snapshot_chunk")
        real_req, real_add = joiner.ss.request_chunk, joiner.syncer.add_chunk

        def request_chunk(snap, i):
            log.setdefault("chunk_req", time.perf_counter())
            return real_req(snap, i)

        def add_chunk(height, format_, index, chunk, sender=""):
            log["chunk_at"] = time.perf_counter()
            log["chunk_bytes"] = len(chunk)
            log["chunk_stall"] = gap.take()
            return real_add(height, format_, index, chunk, sender)
        joiner.ss.request_chunk = request_chunk
        joiner.syncer.add_chunk = add_chunk
        for store, name in ((joiner.state_store, "bootstrap"),
                            (joiner.block_store,
                             "save_seen_commit_standalone")):
            real = getattr(store, name)

            def timed(arg, real=real):
                t = time.perf_counter()
                real(arg)
                log["bootstrap_s"] = log.get("bootstrap_s", 0.0) + \
                    time.perf_counter() - t
            setattr(store, name, timed)
        real_save_block = joiner.block_store.save_block

        def save_block(block, parts, seen):
            real_save_block(block, parts, seen)
            h = block.header.height
            rec["saved"][h] = time.perf_counter()
            rec["launches"][h] = ek.launches
        joiner.block_store.save_block = save_block
        sub = joiner.bus.subscribe("chip-smoke-ss", EVENT_QUERY_NEW_BLOCK,
                                   out_capacity=1000)
        gap_task = asyncio.ensure_future(gap.run())
        try:
            await server.cs.start()
            t0 = time.perf_counter()
            await asyncio.wait_for(
                joiner.switch.dial_peer(server.switch.listen_addr), 30)
            gap.take()
            log["sync_at"] = time.perf_counter()
            l0 = ek.launches
            new_state, commit = await _ss_bootstrap(joiner, cfg)
            log["synced_at"] = time.perf_counter()
            log["sync_launches"] = ek.launches - l0
            await asyncio.sleep(0.005)      # the ticker sees the restore
            log["restore_stall"] = gap.take()
            info = await joiner.conns.query.info(abci.InfoRequest())
            keep["ss_rows"] = _db_rows(joiner)
            rec["launches"][snap_h] = ek.launches
            rec["saved"][snap_h] = time.perf_counter()
            with stages.stage("block sync, the switch and the catch-up"):
                await joiner.bsync.start_sync()
                deadline = time.perf_counter() + 120
                while "switched" not in log:
                    joiner.bsync.raise_if_failed()
                    server.cs.raise_if_failed()
                    if time.perf_counter() > deadline:
                        raise AssertionError(
                            f"15a: no switch to consensus in 120 s (joiner "
                            f"at {joiner.block_store.height})")
                    await asyncio.sleep(0.01)
                await _cs_new_block(joiner, sub, top)
            t_done = time.perf_counter()
            await joiner.bsync.stop_sync()
            final_rs = joiner.cs.rs.height
        finally:
            gap.stop = True
            await gap_task
            await _sock_stop([joiner, server])
        return joiner, new_state, commit, info, t0, t_done, final_rs

    out = {}
    with stages.batches(oe), _gc_pauses() as pauses:
        ek.launches = 0
        window_ms, busy_ms, _, n_dev = _device_busy(
            lambda: out.update(r=loop.run_until_complete(run())))
    joiner, new_state, commit, info, t0, t_done, final_rs = out["r"]
    launches = ek.launches
    # the gates: the restored app, the bootstrapped state, the synced rows
    src_blocks = chain.block_store
    hdr = {h: src_blocks.load_block_meta(h).header
           for h in (snap_h, snap_h + 1, snap_h + 2)}
    if info.last_block_height != snap_h or \
            info.last_block_app_hash != hdr[snap_h + 1].app_hash:
        raise AssertionError(f"15a: the restored app is at "
                             f"{info.last_block_height} with app hash "
                             f"{info.last_block_app_hash.hex()}, header "
                             f"{snap_h + 1} says {hdr[snap_h + 1].app_hash.hex()}")
    if new_state.last_block_height != snap_h or commit.height != snap_h or \
            new_state.app_hash != hdr[snap_h + 1].app_hash or \
            new_state.last_validators.hash() != hdr[snap_h].validators_hash or \
            new_state.validators.hash() != hdr[snap_h + 1].validators_hash or \
            new_state.next_validators.hash() != \
            hdr[snap_h + 2].validators_hash or \
            new_state.last_block_id != commit.block_id or \
            commit.block_id.hash != src_blocks.load_block_meta(
                snap_h).block_id.hash:
        raise AssertionError("15a: the bootstrapped state does not match the "
                             "source's headers")
    db_src, db_dst = chain.dbs["block"], joiner.dbs["block"]
    for h in range(snap_h + 1, top):
        meta = src_blocks.load_block_meta(h)
        keys = [bs._meta_key(h), bs._commit_key(h), bs._seen_commit_key(h),
                bs._ext_commit_key(h), bs._hash_key(meta.block_id.hash)] + [
            bs._part_key(h, i)
            for i in range(meta.block_id.part_set_header.total)]
        if any(db_src.get(k) != db_dst.get(k) for k in keys) or \
                db_dst.get(bs._meta_key(h)) is None:
            raise AssertionError(f"15a: the joiner's block-store rows at {h} "
                                 f"!= the source's")
    if joiner.app.tree.root(top - 1) != chain.app.tree.root(top - 1) or \
            joiner.app.tree.pairs(top - 1) != chain.app.tree.pairs(top - 1):
        raise AssertionError(f"15a: the joiner's app tree at {top - 1} != "
                             f"the source's")
    final = joiner.state_store.load()
    if final.last_block_height != top or \
            final.app_hash != src["states"][top][1] or \
            log["height"] != top - 1 or log["rs_height"] != top or \
            final_rs != top + 1:
        raise AssertionError(f"15a: the joiner ended at "
                             f"{final.last_block_height} (rs {final_rs}), "
                             f"switched at {log.get('height')}")
    keep["ss_joiner"] = joiner
    keep["ss_state"] = new_state.bytes()
    keep["ss_new_state"] = new_state
    synced = range(snap_h + 1, top)
    step = [(rec["saved"][h] - rec["saved"][h - 1]) * 1e3 for h in synced]
    per = [rec["launches"][h] - rec["launches"][h - 1] for h in synced]
    bsync_launches = rec["launches"][top - 1] - rec["launches"][snap_h]
    chunk_s = log["chunk_at"] - log["chunk_req"]
    discovery_s = stages.rows["app_hash(H): light blocks H+1, H+2"][
        "first"] - log["sync_at"]
    busy = f"{busy_ms / window_ms:.4f}" if busy_ms is not None else \
        "not measured (the profiler saw no device event)"
    _log(f"statesync_{n}x{top} stages: discovery {discovery_s * 1e3:.1f} ms; "
         + "; ".join(stages.line(k) for k in (
             "app_hash(H): light blocks H+1, H+2", "offer",
             "apply_snapshot_chunk", "state(H): light blocks H, H+1, H+2",
             "commit(H): light block H")))
    _log(f"statesync_{n}x{top} light verifications: " + "; ".join(
        stages.line(k) for k in sorted(
            (k for k in stages.rows if k.startswith("light block")),
            key=lambda k: int(k.split()[-1]))))
    _log(f"statesync_{n}x{top} chunk transfer {chunk_s * 1e3:.1f} ms for "
         f"{log['chunk_bytes']} bytes ({log['chunk_bytes'] / chunk_s / 1e6:.2f}"
         f" MB/s over the secret connection; send_rate "
         f"{cfg.p2p.send_rate / 1e6:.2f} MB/s); sync_any to the restored app "
         f"{(log['synced_at'] - log['sync_at']) * 1e3:.1f} ms with "
         f"{log['sync_launches']} B1 launches; the state store's bootstrap "
         f"and the seen commit {log['bootstrap_s'] * 1e3:.2f} ms; the "
         f"loop's longest stall: "
         f"{log['chunk_stall'] * 1e3:.1f} ms before the chunk landed, "
         f"{log['restore_stall'] * 1e3:.1f} ms over the restore (JSON "
         f"decode and import_snapshot on the loop)")
    _log(f"statesync_{n}x{top} block sync {snap_h + 1}-{top - 1}: save to "
         f"save ms {_p50_p90(step)}, B1 launches {bsync_launches} "
         f"({per} a height); the switch "
         f"{(log['switched'] - log['switch_at']) * 1e3:.1f} ms with "
         f"{log['switch_launches']} B1 launch(es) for LastCommit, batch "
         f"sizes from the sync to the catch-up "
         f"{stages.rows['block sync, the switch and the catch-up']['lanes']}, "
         f"rs.height {log['rs_height']}, then {final_rs} after the catch-up "
         f"of {top} ({(t_done - log['switched']) * 1e3:.1f} ms); total from "
         f"the dial to consensus {(log['switched'] - t0) * 1e3:.1f} ms; B1 "
         f"launches in all {launches} (the catch-up's "
         f"{launches - log['sync_launches'] - bsync_launches - log['switch_launches']}"
         f"); device busy share over the traced "
         f"run {busy} ({n_dev} device events, window {window_ms:.1f} ms); "
         f"gc in the run: {_gc_line(pauses)}; card: {card}")
    _log(f"statesync_{n}x{top} gates held: the restored app hash is header "
         f"{snap_h + 1}'s, the bootstrapped validator sets hash to headers "
         f"{snap_h}-{snap_h + 2}'s, block-store rows {snap_h + 1}-{top - 1} "
         f"and the app tree at {top - 1} equal the source's, the joiner's "
         f"app hash at {top} is the source's")
    return launches


def _tree_roots(tree):
    """Every retained version's root, rebuilt from the tree's node records
    in one ordered pass (independent of the version records the tree
    reports), by the merkle layer's own leaf and root functions."""
    from cometbft_tpu_torch.crypto import merkle
    from cometbft_tpu_torch.statetree import tree as st
    by_ver = collections.defaultdict(list)
    for raw, rec in tree._db.iterator(st._NODE, st._VERSION):
        key, ver = st._split_node_key(raw[len(st._NODE):])
        by_ver[ver].append((key, rec))
    versions = set(tree.versions())
    if min(by_ver) < min(versions):
        raise AssertionError(f"15b: node records at {min(by_ver)} below the "
                             f"tree's base {min(versions)}")
    live, roots = {}, {}
    for v in sorted(set(by_ver) | versions):
        for key, rec in by_ver.get(v, ()):
            if rec[:1] == st._TOMBSTONE:
                live.pop(key, None)
            else:
                live[key] = merkle.leaf_hash(
                    merkle.value_op_leaf(key, rec[1:]))
        if v in versions:
            roots[v] = merkle.root_from_leaf_hashes(
                [live[k] for k in sorted(live)])
    return roots


def _ss_prune(card, src, keep):
    """15b prune-150: the pruner's passes over the source while 15a built
    it, the pruned stores and tree held to the retain height, then
    rollback_state(remove_block=True) on 15a's stopped joiner."""
    import struct
    from cometbft_tpu_torch.state.rollback import rollback_state
    from cometbft_tpu_torch.state import store as ss
    chain, passes = src["chain"], src["passes"]
    n, top = EXEC_VALIDATORS, SS_HEIGHTS
    _phase(f"15b prune-{n}: the source's Pruner passes (retain_blocks "
           f"{SS_RETAIN}), its stores and state tree below the retain "
           f"height, and rollback_state on 15a's stopped joiner")
    base, retain = chain.block_store.base, chain.exec.last_retain_height
    if base != retain or retain != top - SS_RETAIN + 1:
        raise AssertionError(f"15b: block store base {base}, the app's "
                             f"retain height {retain}")
    # what the JAX stores leave below the base: block 1's empty LastCommit
    # (commit key 0, below PruneBlocks' first base) and the full validator
    # records a pass kept as its retain height's lookback target; nothing
    # else, and every retained lookback pointer still finds its record
    left, kept = [], []
    for k, v in chain.dbs["block"].iterator():
        if k[:1] in (b"\x00", b"\x01", b"\x02", b"\x03", b"\x04"):
            h = struct.unpack(">q", k[1:9])[0]
        elif k[:1] == b"\x05":
            h = struct.unpack(">q", v)[0]
        else:
            continue
        if h < base and (k[:1], h) != (b"\x02", 0):
            left.append(("block", k[:1], h))
    sdb = chain.dbs["state"]
    for k, v in sdb.iterator():
        if k[:1] not in (ss._VALIDATORS, ss._CONSENSUS_PARAMS,
                         ss._ABCI_RESPONSES):
            continue
        h = struct.unpack(">q", k[1:9])[0]
        if h >= base:
            continue
        if k[:1] == ss._VALIDATORS and ss.decode(
                ss.state_pb.VALIDATORS_INFO, v).get("validator_set"):
            kept.append(h)
        else:
            left.append(("state", k[:1], h))
    if left:
        raise AssertionError(f"15b: rows left below the base {base}: "
                             f"{left[:8]}")
    store = ss.Store(sdb)
    for h in range(base, top + 2):
        store.load_validators(h)        # raises if a pointer dangles
    tree = chain.app.tree
    rebuilt = _tree_roots(tree)
    versions = sorted(rebuilt)
    bad = [v for v in versions
           if rebuilt[v] != src["roots"][v] or tree.root(v) != src["roots"][v]]
    if bad or versions[0] != retain - 1 or versions[-1] != top or \
            tree.base_version != retain - 1:
        raise AssertionError(f"15b: tree versions {versions[0]}-"
                             f"{versions[-1]}, roots changed at {bad}")
    pruned = [p for p, _ in passes]
    ms = [m for p, m in passes if p]
    _log(f"prune_{n} the Pruner ran {len(passes)} passes while the source "
         f"was built, {sum(1 for p in pruned if p)} of them pruning "
         f"(heights a pruning pass {sorted(collections.Counter(p for p in pruned if p).items())}"
         f", {sum(pruned)} in all): ms a pruning pass {_p50_p90(ms)}, max "
         f"{max(ms):.3f}; ms a pass that pruned nothing "
         f"{_p50_p90([m for p, m in passes if not p] or [0.0])}; the block "
         f"store's base {base} = the app's last retain_height; below it no "
         f"meta, part, seen, extended-commit, hash, params or "
         f"FinalizeBlock-response row, no commit row but block 1's empty "
         f"LastCommit (key height 0), no validator pointer, only the full "
         f"validator records at {kept} that passes kept as lookback targets "
         f"(the JAX stores leave the same), every retained height's "
         f"validator set loads; the tree keeps "
         f"versions {versions[0]}-{versions[-1]}, each rebuilt from its node "
         f"records to the root it had at its commit; the app's tree prune "
         f"in Commit ({len(src['tree_ms'])} commits) ms "
         f"{_p50_p90(src['tree_ms'])}, max {max(src['tree_ms']):.1f}, "
         f"{sum(src['tree_ms']) / 1e3:.2f} s in all; card: {card}")
    joiner = keep.pop("ss_joiner")
    t0 = time.perf_counter()
    height, app_hash = rollback_state(joiner.state_store, joiner.block_store,
                                      remove_block=True)
    rb_ms = (time.perf_counter() - t0) * 1e3
    if (height, app_hash) != src["states"][top - 1] or \
            joiner.block_store.height != top - 1 or \
            joiner.state_store.load().last_block_height != top - 1:
        raise AssertionError(f"15b: the rollback left ({height}, "
                             f"{app_hash.hex()}), the source's state at "
                             f"{top - 1} is {src['states'][top - 1][1].hex()}")
    _log(f"prune_{n} rollback_state(remove_block=True) on the stopped joiner "
         f"in {rb_ms:.2f} ms: height {height}, app hash {app_hash.hex()[:16]}"
         f"..., the source's state at {top - 1}; the joiner's block store "
         f"now ends at {joiner.block_store.height}")


class _SnapshotLiar:
    """A snapshot connection that advertises ``snaps`` ([(Snapshot, chunk
    or None)]) and serves each snapshot's one chunk; a None chunk is never
    served (the reactor answers it missing)."""

    def __init__(self, snaps):
        self.snaps = snaps

    async def list_snapshots(self, req):
        from cometbft_tpu_torch.abci import types as abci
        return abci.ListSnapshotsResponse(snapshots=[s for s, _ in self.snaps])

    async def load_snapshot_chunk(self, req):
        from cometbft_tpu_torch.abci import types as abci
        for s, chunk in self.snaps:
            if (s.height, s.format) == (req.height, req.format):
                return abci.LoadSnapshotChunkResponse(chunk=chunk or b"")
        return abci.LoadSnapshotChunkResponse()


class _LogRecorder:
    """A logger that keeps (message, fields) of every call."""

    def __init__(self):
        self.lines = []

    def info(self, msg, **kv):
        self.lines.append((msg, kv))

    debug = warn = error = info


def _ss_reject(seed, card, ek, ek8, oe, device, loop, src, keep):
    """15c statesync-reject: a liar's snapshots (a format the app refuses,
    a chunk that does not hash to its snapshot) rejected before the
    source's good one, a chunk that never comes under a short
    chunk_request_timeout_ns, a snapshot at the source's tip, a
    corrupted signature in light block H+1, a raising stand-in kernel,
    and one state sync under cuda8.  Returns (B1 launches, B2
    launches)."""
    import copy
    from types import SimpleNamespace
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.abci.client import AppConns
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.crypto import tmhash
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.light.provider import NodeProvider
    from cometbft_tpu_torch.p2p import NodeKey, Switch
    from cometbft_tpu_torch.statesync import StateProvider
    from cometbft_tpu_torch.statesync.syncer import RejectSnapshotError
    chain, top = src["chain"], SS_HEIGHTS
    snap_h = max(chain.app._snapshots)
    _phase(f"15c statesync-reject: a liar's snapshots at {snap_h + 3} (format "
           f"2) and {snap_h + 2} (a chunk off its hash) before the source's "
           f"{snap_h}; a chunk never served under a {SS_CHUNK_TIMEOUT_NS} ns "
           f"chunk timeout; a snapshot at the tip {top}; a flipped signature "
           f"bit in light block {snap_h + 1}; a raising stand-in kernel; one "
           f"state sync under cuda8")
    cfg = Config()
    short = copy.deepcopy(cfg)
    short.statesync.chunk_request_timeout_ns = SS_CHUNK_TIMEOUT_NS
    out = []
    l0 = ek.launches

    def snap(h, fmt=1, chunk=b"advertised"):
        return abci.Snapshot(height=h, format=fmt, chunks=1,
                             hash=tmhash.sum(chunk))

    class Flipped(NodeProvider):
        """The source's stores with one signature bit of light block
        ``bad`` flipped."""
        bad = snap_h + 1

        async def light_block(self, height):
            lb = await super().light_block(height)
            if height == self.bad:
                sig = lb.signed_header.commit.signatures[0]
                sig.signature = bytes([sig.signature[0] ^ 1]) + \
                    sig.signature[1:]
            return lb

    def rejections(logger):
        return [(kv.get("height"), kv.get("err")) for msg, kv in logger.lines
                if msg == "snapshot rejected; trying next"]

    async def attempt(i, servers, primary=None, conf=cfg, until=None):
        """A fresh node state-syncs from ``servers``; with ``until``, the
        sync is cancelled once until(rejections) holds."""
        lc = _ss_light_client(chain, device, primary=primary)
        await lc.initialize()
        sp = StateProvider(lc, chain.chain_id, chain.doc)
        node = await _CsNode.make(chain.doc, device)
        logger = _LogRecorder()
        node.switch = Switch(NodeKey(Ed25519PrivKey(_seed(seed + 153, i))),
                             chain.chain_id, listen_addr="127.0.0.1:0")
        for r in _ss_syncer(node, sp, conf, logger=logger):
            node.switch.add_reactor(r)
        await node.switch.start()
        try:
            for sw in servers:
                await asyncio.wait_for(node.switch.dial_peer(sw.listen_addr),
                                       30)
            task = asyncio.ensure_future(
                _ss_bootstrap(node, conf, SS_REJECT_DISCOVERY_NS))
            deadline = time.perf_counter() + 60
            while until is not None and not task.done() and \
                    not until(rejections(logger)):
                if time.perf_counter() > deadline:
                    raise AssertionError("15c: the sync's outcome never came")
                await asyncio.sleep(0.005)
            if until is not None and not task.done():
                task.cancel()
            try:
                res = await task
            except asyncio.CancelledError:
                res = None
            except Exception as e:  # noqa: BLE001 — the case's outcome
                res = e
        finally:
            await node.switch.stop()
        return node, res, rejections(logger)

    def untouched(node, what):
        info = loop.run_until_complete(node.conns.query.info(
            abci.InfoRequest()))
        if info.last_block_height != 0 or node.block_store.height != 0 or \
                node.state_store.load().last_block_height != 0:
            raise AssertionError(f"15c: {what} bootstrapped something")

    async def server(conns, i):
        return await _ss_snapshot_server(conns, _seed(seed + 152, i),
                                         chain.chain_id)

    def liar(snaps):
        return SimpleNamespace(snapshot=_SnapshotLiar(snaps))

    good = loop.run_until_complete(server(AppConns(chain.app), 0))
    try:
        # (i) a format the app refuses, a chunk off its hash, then the good
        _clear_memos()
        bad = loop.run_until_complete(server(liar([
            (snap(snap_h + 3, fmt=2), b"x"),
            (snap(snap_h + 2), b"not the advertised chunk")]), 1))
        try:
            node, res, rejected = loop.run_until_complete(
                attempt(0, [good, bad]))
        finally:
            loop.run_until_complete(bad.stop())
        want = [(snap_h + 3, "app rejected snapshot: 4"),
                (snap_h + 2, "chunk apply failed: 5")]
        if isinstance(res, Exception) or rejected != want or \
                res[0].bytes() != keep["ss_state"]:
            raise AssertionError(f"15c: the liar's snapshots gave {res!r}, "
                                 f"rejections {rejected}")
        for h, err in rejected:
            out.append(f"snapshot at {h} rejected: RejectSnapshotError "
                       f"{err!r}, sync_any went on")
        out.append(f"then the source's {snap_h} restored, the bootstrapped "
                   f"State 15a's")

        # (ii) a chunk that never comes: rejected, then rediscovery
        never = _SnapshotLiar([(snap(snap_h + 1), None)])
        listed = []
        real_list = never.list_snapshots

        async def list_snapshots(req):
            listed.append(time.perf_counter())
            return await real_list(req)
        never.list_snapshots = list_snapshots
        srv = loop.run_until_complete(server(
            SimpleNamespace(snapshot=never), 2))
        try:
            node, res, rejected = loop.run_until_complete(attempt(
                1, [srv], conf=short,
                until=lambda rej: rej and len(listed) >= 2))
        finally:
            loop.run_until_complete(srv.stop())
        want = [(snap_h + 1, "timed out waiting for chunks (4 rounds)")]
        if res is not None or rejected != want or len(listed) < 2:
            raise AssertionError(f"15c: the missing chunk gave {res!r}, "
                                 f"{rejected}, {len(listed)} listings")
        untouched(node, "the missing chunk")
        out.append(f"a chunk never served (chunk_request_timeout_ns "
                   f"{SS_CHUNK_TIMEOUT_NS}): snapshot {snap_h + 1} rejected, "
                   f"RejectSnapshotError {want[0][1]!r}, and the syncer asked "
                   f"its peers for snapshots again")

        # (iii) a snapshot at the tip: H+1 and H+2 do not exist yet, so
        # the snapshot is dropped for the next one (ROADMAP.md C.8)
        srv = loop.run_until_complete(server(liar([(snap(top), b"x")]), 3))
        try:
            node, res, rejected = loop.run_until_complete(attempt(
                2, [srv], until=lambda rej: rej))
        finally:
            loop.run_until_complete(srv.stop())
        want = [(top, "failed to fetch and verify app hash: no light block "
                      f"at height {top + 1}")]
        if res is not None or rejected != want:
            raise AssertionError(f"15c: the tip snapshot gave {res!r}, "
                                 f"{rejected}")
        untouched(node, "the tip snapshot")
        out.append(f"a snapshot at the tip {top}: rejected, "
                   f"RejectSnapshotError {want[0][1]!r}, nothing bootstrapped")

        # (iv) a flipped signature bit in light block H+1
        _clear_memos()
        l_flip = ek.launches
        node, res, rejected = loop.run_until_complete(attempt(
            3, [good], primary=Flipped(chain.block_store, chain.state_store,
                                       chain.chain_id)))
        if type(res).__name__ != "InvalidHeaderError" or \
                not str(res).startswith("wrong signature (#0): ") or \
                ek.launches == l_flip:
            raise AssertionError(f"15c: the flipped bit gave {res!r}")
        untouched(node, "the flipped bit")
        out.append(f"a flipped signature bit in light block {snap_h + 1}: B1 "
                   f"({ek.launches - l_flip} launch(es)) refused it, "
                   f"sync_any raised {type(res).__name__} {str(res)[:40]!r}"
                   f"..., nothing bootstrapped")

        # (v) a raising stand-in kernel
        real_kernel = ek.verify_cols

        def raising(*a, **kw):
            raise RuntimeError("stand-in kernel failure (15c)")

        _clear_memos()
        ek.verify_cols = raising
        try:
            node, res, rejected = loop.run_until_complete(attempt(4, [good]))
        finally:
            ek.verify_cols = real_kernel
        if not isinstance(res, RuntimeError) or \
                str(res) != "stand-in kernel failure (15c)" or rejected:
            raise AssertionError(f"15c: the raising kernel was hidden: "
                                 f"{res!r}")
        untouched(node, "the raising kernel")
        out.append(f"a raising stand-in kernel: sync_any raised RuntimeError "
                   f"{str(res)!r}, no fallback, nothing bootstrapped")

        # (vi) one state sync under cuda8
        _clear_memos()
        b1, ek8.launches = ek.launches, 0
        os.environ[oe.KERNEL_ENV] = "cuda8"
        try:
            node, res, rejected = loop.run_until_complete(attempt(5, [good]))
        finally:
            os.environ.pop(oe.KERNEL_ENV, None)
        launches8, b1_in_8 = ek8.launches, ek.launches - b1
        if isinstance(res, Exception):
            raise res
        if _db_rows(node) != keep["ss_rows"] or b1_in_8 or not launches8:
            raise AssertionError(f"15c: the cuda8 sync launched B1 {b1_in_8}"
                                 f", B2 {launches8}, or its rows differ")
        out.append(f"a state sync under cuda8: {launches8} B2 launches, 0 B1, "
                   f"its state-store, block-store and app rows at the "
                   f"bootstrap equal 15a's under B1")
    finally:
        loop.run_until_complete(good.stop())
    for line in out:
        _log(f"statesync_reject {line}")
    _log(f"statesync_reject all {len(out)} outcomes as the JAX package "
         f"decides them; card: {card}")
    return ek.launches - l0 - b1_in_8, launches8


def _statesync_phases(seed, card, keep, device=None):
    """Phases 15a-15c: state sync and pruning (statesync/, state/pruner.py,
    state/rollback.py, the stores' bootstrap and pruning, the kvstore's
    snapshots, the state tree's prune and import).  Returns B1's launches
    by part and B2's."""
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    t_phase = time.perf_counter()
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        src = _ss_source(seed, card, ek, device, loop)
        sync = _ss_chain(seed, card, ek, device, loop, src, keep)
        _ss_prune(card, src, keep)
        reject, reject8 = _ss_reject(seed, card, ek, ek8, oe, device, loop,
                                     src, keep)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
    keep["ss_src"] = src
    _log(f"phase 15 took {time.perf_counter() - t_phase:.1f} s")
    n, top = EXEC_VALIDATORS, SS_HEIGHTS
    return ({f"statesync_source_{n}x{top}": src["launches"],
             f"statesync_{n}x{top}": sync,
             "statesync_reject": reject},
            {f"statesync_{n}_cuda8": reject8})


class _StoreNode:
    """A chain's stores and app connections behind an RPCServer, with the
    JAX Node's attribute names (rpc/core reads them); parts a store server
    lacks are None, so the routes that need them answer as a JAX node
    without them.  With ``cache`` (a lightserve ResponseCache) the routes
    serve settled heights from it, and the chain's kvstore keeps the
    cached heights' tree versions past its pruning horizon through the
    node's own wiring (node/node.pin_cache_heights)."""

    moniker = "anonymous"
    mempool = consensus_state = switch = event_bus = None
    tx_indexer = block_indexer = pruner = None
    consensus_reactor = blocksync_reactor = None

    def __init__(self, chain, evidence_pool=None, cache=None):
        from cometbft_tpu_torch.config import Config
        from cometbft_tpu_torch.node.node import pin_cache_heights
        self.block_store, self.state_store = chain.block_store, \
            chain.state_store
        self.genesis_doc, self.config = chain.doc, Config()
        self.app_conns = chain.conns
        self.evidence_pool = evidence_pool
        self.lightserve_cache = cache
        if cache is not None:
            pin_cache_heights(chain.app, cache)


class _RpcCount:
    """Route calls by name and response bytes of the port's RPC servers
    while installed: the servers' module ``json`` is swapped for one whose
    ``dumps`` counts what it returns, and each server's ``_call`` records
    its method."""

    def __init__(self, servers):
        from cometbft_tpu_torch.rpc import server as rpc_server
        self.mod, self.servers = rpc_server, servers
        self.calls, self.bytes = collections.Counter(), 0

    def __enter__(self):
        count = self

        class _Json:
            JSONDecodeError = json.JSONDecodeError
            loads = staticmethod(json.loads)

            @staticmethod
            def dumps(obj, **kw):
                out = json.dumps(obj, **kw)
                count.bytes += len(out)
                return out
        self.mod.json = _Json
        for srv in self.servers:
            real = srv._call

            async def call(name, params, rpc_id, real=real):
                count.calls[name] += 1
                return await real(name, params, rpc_id)
            srv._call = call
        return self

    def __exit__(self, *exc):
        self.mod.json = json
        for srv in self.servers:
            del srv._call
        return False

    def take(self):
        out = (dict(self.calls), self.bytes)
        self.calls, self.bytes = collections.Counter(), 0
        return out


def _rpc_light_client(chain, device, primary, witnesses, mode):
    """A light client over ``primary`` and ``witnesses`` from the trust root
    SS_TRUST, its hash read from the source's block store."""
    from cometbft_tpu_torch.config import StateSyncConfig
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.light.client import Client, TrustOptions
    from cometbft_tpu_torch.light.store import TrustedStore
    trust_hash = chain.block_store.load_block_meta(SS_TRUST).block_id.hash
    return Client(chain.chain_id,
                  TrustOptions(period_ns=StateSyncConfig().trust_period_ns,
                               height=SS_TRUST, header_hash=trust_hash),
                  primary, witnesses, TrustedStore(MemDB()),
                  verification_mode=mode, device=device)


async def _light_sync(chain, device, ek, providers, mode, top):
    """A light client over ``providers`` (primary first) from the trust
    root SS_TRUST to ``top``: every height sequentially, or ``top`` alone
    skipping.  Returns (client, ms a hop, B1 launches, the loop's longest
    stall in seconds)."""
    from cometbft_tpu_torch.light.client import SEQUENTIAL
    lc = _rpc_light_client(chain, device, providers[0], providers[1:], mode)
    await lc.initialize()
    gap, ms, l0 = _LoopGap(), [], ek.launches
    gap_task = asyncio.ensure_future(gap.run())
    try:
        heights = range(SS_TRUST + 1, top + 1) if mode == SEQUENTIAL \
            else [top]
        for h in heights:
            t = time.perf_counter()
            await lc.verify_light_block_at_height(h)
            ms.append((time.perf_counter() - t) * 1e3)
    finally:
        gap.stop = True
        await gap_task
    return lc, ms, ek.launches - l0, gap.worst


def _unproposed(vals) -> bytes:
    """A validator set's bytes but its proposer, which /validators does
    not carry (the codec derives it as the reference's
    findPreviousProposer does)."""
    from cometbft_tpu_torch.wire import encode, pb
    d = vals.to_proto()
    d.pop("proposer", None)
    return encode(pb.VALIDATOR_SET, d)


async def _stored_light_blocks(chain, provider, count, what):
    """Fetch every light block from the trust root to the top through
    ``provider``, each held to the stores' own (signed header bytes, the
    validator set's but its proposer, its hash the header's); returns the
    (calls, response bytes) of each fetch."""
    from cometbft_tpu_torch.light.provider import NodeProvider
    from cometbft_tpu_torch.wire import encode, pb
    npv = NodeProvider(chain.block_store, chain.state_store, chain.chain_id)
    per = []
    for h in range(SS_TRUST, SS_HEIGHTS + 1):
        got = await provider.light_block(h)
        per.append(count.take())
        want = await npv.light_block(h)
        if encode(pb.SIGNED_HEADER, got.signed_header.to_proto()) != \
                encode(pb.SIGNED_HEADER, want.signed_header.to_proto()) \
                or _unproposed(got.validator_set) != \
                _unproposed(want.validator_set) or \
                got.validator_set.hash() != \
                want.signed_header.header.validators_hash:
            raise AssertionError(f"{what}: the light block at {h} over "
                                 f"HTTP != the stores' own")
    return per


def _rpc_light(seed, card, ek, tracing, device, loop, src, urls, count):
    """16a rpc-light-150x105: a light client over two RPC servers (primary
    and witness, HttpProviders) from the trust root to the source's top,
    sequentially and skipping, against the same syncs over NodeProviders;
    every light block the HTTP path brings held to the stores' own bytes.
    Returns B1's launches over HTTP."""
    from cometbft_tpu_torch.light.client import SEQUENTIAL, SKIPPING
    from cometbft_tpu_torch.light.provider import HttpProvider, NodeProvider
    chain, n, top = src["chain"], EXEC_VALIDATORS, SS_HEIGHTS
    _phase(f"16a rpc-light-{n}x{top}: a light client over two RPCServers on "
           f"127.0.0.1 (primary and witness) serving the {n}-validator "
           f"source, HttpProviders from the trust root {SS_TRUST} to {top}, "
           f"sequentially ({top - SS_TRUST} hops) and skipping, against the "
           f"same syncs over NodeProviders")
    _clear_memos()
    out = {}

    def node_provider():
        return NodeProvider(chain.block_store, chain.state_store,
                            chain.chain_id)

    def http_provider(url):
        return HttpProvider(url, chain.chain_id)

    async def sync(make, mode):
        return await _light_sync(chain, device, ek, [make(0), make(1)],
                                 mode, top)

    def http(i):
        return http_provider(urls[i])

    def node(i):
        return node_provider()

    async def run():
        for mode in (SEQUENTIAL, SKIPPING):
            _clear_memos()
            out[("node", mode)] = await sync(node, mode)
            _clear_memos()
            tracing.clear()
            count.take()
            out[("http", mode)] = await sync(http, mode)
            out[("http_lanes", mode)] = [
                ev["attrs"]["batch"]
                for ev in tracing.snapshot(category=tracing.CRYPTO)
                if ev["name"] == "batch_verify"]
            out[("rpc", mode)] = count.take()
        # the codec's round trip: each light block over HTTP as stored
        out["per_block"] = await _stored_light_blocks(
            chain, http_provider(urls[0]), count, "16a")

    loop.run_until_complete(run())
    want_hash = chain.block_store.load_block_meta(top).block_id.hash
    for mode in (SEQUENTIAL, SKIPPING):
        for via in ("node", "http"):
            lc = out[(via, mode)][0]
            latest = lc.store.latest()
            if latest.height != top or \
                    latest.signed_header.header.hash() != want_hash:
                raise AssertionError(f"16a: the {via} {mode} sync ends at "
                                     f"{latest.height}, not {top} with the "
                                     f"source's hash")
    launches = sum(out[("http", m)][2] for m in (SEQUENTIAL, SKIPPING))
    seq_calls, seq_bytes = out[("rpc", SEQUENTIAL)]
    first_calls, first_bytes = out["per_block"][0]
    rest = out["per_block"][1:]
    _log(f"rpc_light_{n}x{top} sequential {top - SS_TRUST} hops, ms a hop "
         f"over HTTP {_p50_p90(out[('http', SEQUENTIAL)][1])} against "
         f"NodeProvider {_p50_p90(out[('node', SEQUENTIAL)][1])}; skipping "
         f"{SS_TRUST}->{top} over HTTP "
         f"{out[('http', SKIPPING)][1][0]:.1f} ms against NodeProvider "
         f"{out[('node', SKIPPING)][1][0]:.1f} ms; B1 launches over HTTP "
         f"{out[('http', SEQUENTIAL)][2]} sequential + "
         f"{out[('http', SKIPPING)][2]} skipping (NodeProvider "
         f"{out[('node', SEQUENTIAL)][2]} + {out[('node', SKIPPING)][2]}), "
         f"lanes a launch {sorted(collections.Counter(out[('http_lanes', SEQUENTIAL)] + out[('http_lanes', SKIPPING)]).items())}; "
         f"the loop's longest stall {out[('http', SEQUENTIAL)][3] * 1e3:.1f} "
         f"ms sequential, {out[('http', SKIPPING)][3] * 1e3:.1f} ms skipping "
         f"(NodeProvider {out[('node', SEQUENTIAL)][3] * 1e3:.1f}); card: "
         f"{card}")
    _log(f"rpc_light_{n}x{top} HTTP a light block (a fresh HttpProvider): "
         f"first {sum(first_calls.values())} round trips {first_calls}, "
         f"{first_bytes} response bytes; then "
         f"{sorted(collections.Counter(sum(c.values()) for c, _ in rest).items())} "
         f"round trips, {_p50_p90([b for _, b in rest])} bytes a block; the "
         f"sequential sync in all {seq_calls}, {seq_bytes} bytes "
         f"(primary and witness, one TCP connection a call); every light "
         f"block {SS_TRUST}-{top} over HTTP equals the stores' own (signed "
         f"header bytes, the validator set's but its proposer), both "
         f"syncs trust {top} at the source's hash")
    return launches


def _unproposed_state(state) -> bytes:
    """A State's bytes with its three validator sets' proposers left out."""
    st = state.copy()
    for name in ("last_validators", "validators", "next_validators"):
        vs = getattr(st, name)
        if vs is not None:
            vs = vs.copy()
            vs.proposer = None
            setattr(st, name, vs)
    return st.bytes()


def _rpc_statesync(seed, card, ek, oe, device, loop, src, keep, urls, count):
    """16b rpc-statesync-150x105: 15a's joiner with the state provider the
    JAX node builds when statesync.rpc_servers is set (node.py:599-606):
    new_rpc_state_provider over 16a's two servers; the snapshot over p2p.
    The run stops at the bootstrap, whose rows are held to 15a's.  Returns
    the state provider's B1 launches."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.abci.client import AppConns
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.p2p import NodeKey, Switch
    from cometbft_tpu_torch.statesync.syncer import new_rpc_state_provider
    chain, n, top = src["chain"], EXEC_VALIDATORS, SS_HEIGHTS
    snap_h = max(chain.app._snapshots)
    _phase(f"16b rpc-statesync-{n}x{top}: 15a's joiner with "
           f"new_rpc_state_provider(chain_id, genesis, [primary, witness], "
           f"{SS_TRUST}, hash) over 16a's servers, the snapshot at {snap_h} "
           f"over p2p; stops at the bootstrap")
    cfg = Config()
    cfg.statesync.discovery_time_ns = SS_DISCOVERY_NS
    trust_hash = chain.block_store.load_block_meta(SS_TRUST).block_id.hash
    stages = _Stages(ek)
    _clear_memos()
    log = {}

    async def run():
        good = await _ss_snapshot_server(AppConns(chain.app),
                                         _seed(seed + 162, 0), chain.chain_id)
        node = await _CsNode.make(chain.doc, device)
        node.switch = Switch(NodeKey(Ed25519PrivKey(_seed(seed + 162, 1))),
                             chain.chain_id, listen_addr="127.0.0.1:0")
        try:
            count.take()
            with stages.stage("new_rpc_state_provider (trust root over HTTP)"):
                sp = await new_rpc_state_provider(
                    chain.chain_id, chain.doc, urls, SS_TRUST, trust_hash,
                    cfg.statesync.trust_period_ns, device=device)
            stages.wrap(sp, "app_hash", "app_hash(H): light blocks H+1, H+2")
            stages.wrap(sp, "state", "state(H): light blocks H, H+1, H+2")
            stages.wrap(sp, "commit", "commit(H): light block H")
            stages.wrap(sp.light_client, "verify_light_block_at_height",
                        lambda h, *a, **kw: f"light block {h}")
            for r in _ss_syncer(node, sp, cfg):
                node.switch.add_reactor(r)
            stages.wrap(node.conns.snapshot, "offer_snapshot", "offer")
            stages.wrap(node.conns.snapshot, "apply_snapshot_chunk",
                        "apply_snapshot_chunk")
            await node.switch.start()
            await asyncio.wait_for(node.switch.dial_peer(good.listen_addr),
                                   30)
            t0 = time.perf_counter()
            new_state, commit = await _ss_bootstrap(node, cfg)
            log["sync_ms"] = (time.perf_counter() - t0) * 1e3
            log["rpc"] = count.take()
            info = await node.conns.query.info(abci.InfoRequest())
        finally:
            await node.switch.stop()
            await good.stop()
        return node, new_state, commit, info

    ek.launches = 0
    with stages.batches(oe):
        node, new_state, commit, info = loop.run_until_complete(run())
    launches = ek.launches
    app_hash = chain.block_store.load_block_meta(snap_h + 1).header.app_hash
    if info.last_block_height != snap_h or \
            info.last_block_app_hash != app_hash or \
            new_state.app_hash != app_hash:
        raise AssertionError(f"16b: the restored app is at "
                             f"{info.last_block_height} with app hash "
                             f"{info.last_block_app_hash.hex()}, header "
                             f"{snap_h + 1} says {app_hash.hex()}")
    rows, want = _db_rows(node), keep["ss_rows"]
    if rows["block"] != want["block"]:
        raise AssertionError("16b: the bootstrapped block-store rows != "
                             "15a's joiner's")
    # the state store: byte for byte, but the validator sets' proposer,
    # which /validators does not carry
    ref_state = keep["ss_new_state"]
    same_rows = sum(a == b for a, b in zip(rows["state"], want["state"]))
    if [k for k, _ in rows["state"]] != [k for k, _ in want["state"]] or \
            _unproposed_state(new_state) != _unproposed_state(ref_state) or \
            any(_unproposed(node.state_store.load_validators(h)) !=
                _unproposed(chain.state_store.load_validators(h))
                for h in (snap_h, snap_h + 1, snap_h + 2)):
        raise AssertionError("16b: the bootstrapped state-store rows != "
                             "15a's joiner's but the sets' proposer")
    proposers = sum(
        a.proposer.address != b.proposer.address
        for a, b in ((new_state.last_validators, ref_state.last_validators),
                     (new_state.validators, ref_state.validators),
                     (new_state.next_validators, ref_state.next_validators)))
    calls, nbytes = log["rpc"]
    _log(f"rpc_statesync_{n}x{top} stages: " + "; ".join(
        stages.line(k) for k in (
            "new_rpc_state_provider (trust root over HTTP)",
            "app_hash(H): light blocks H+1, H+2", "offer",
            "apply_snapshot_chunk",
            "state(H): light blocks H, H+1, H+2",
            "commit(H): light block H")))
    _log(f"rpc_statesync_{n}x{top} light verifications: " + "; ".join(
        stages.line(k) for k in sorted(
            (k for k in stages.rows if k.startswith("light block")),
            key=lambda k: int(k.split()[-1]))))
    _log(f"rpc_statesync_{n}x{top} sync_any {log['sync_ms']:.1f} ms "
         f"(discovery {cfg.statesync.discovery_time_ns / 1e9:.1f} s "
         f"included); the state provider's B1 launches {launches}; HTTP "
         f"round trips {sum(calls.values())} {calls}, {nbytes} response "
         f"bytes; the restored app hash is header {snap_h + 1}'s; the "
         f"bootstrapped block-store rows equal 15a's joiner's byte for byte, "
         f"its state-store rows {same_rows} of {len(rows['state'])} byte "
         f"for byte and the rest but the sets' proposer ({proposers} of "
         f"the state's three sets name another proposer than 15a's: "
         f"/validators does not carry it); card: {card}")
    return launches


def _forked_header(chain, h):
    """A lunatic fork of the source's header h (another app hash) and its
    commit, signed by every validator of h's set."""
    import dataclasses
    from cometbft_tpu_torch.types.block_id import BlockID
    meta = chain.block_store.load_block_meta(h)
    header = dataclasses.replace(meta.header, app_hash=b"\x66" * 32)
    bid = BlockID(hash=header.hash(),
                  part_set_header=meta.block_id.part_set_header)
    return header, chain.sign_commit(chain.state_store.load_validators(h),
                                     h, bid)


def _rpc_reject(seed, card, ek, ek8, oe, device, loop, src, servers, urls):
    """16e rpc-reject (the RPC half): a lying server's corrupted commit
    signature (under B1, then cuda8), a witness serving a forked header
    (divergence, evidence to both servers, verified by the primary's pool on
    B1), the unsafe routes, an unknown method, a bad parameter, a body over
    max_body_bytes, the lightserve routes, a raising stand-in kernel under
    an HTTP hop.  Returns (lines, B1 launches, B2 launches)."""
    import base64
    from cometbft_tpu_torch.config import RPCConfig
    from cometbft_tpu_torch.evidence import EvidencePool
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.light.client import (
        SEQUENTIAL, SKIPPING, DivergenceError)
    from cometbft_tpu_torch.light.provider import HttpProvider
    from cometbft_tpu_torch.rpc import core as rpc_core
    from cometbft_tpu_torch.rpc.client import HTTPClient, RPCClientError
    from cometbft_tpu_torch.rpc.server import RPCServer
    chain, top = src["chain"], SS_HEIGHTS
    lie_h = SS_TRUST + 5
    lines, l0 = [], ek.launches
    primary, witness = servers

    async def liar_server(patch):
        srv = RPCServer(_StoreNode(chain), RPCConfig(laddr="tcp://127.0.0.1:0"))
        await srv.start()
        patch(srv)
        return srv

    def flip(commit_json):
        sig = commit_json["signatures"][0]
        raw = base64.b64decode(sig["signature"])
        sig["signature"] = base64.b64encode(bytes([raw[0] ^ 1]) +
                                            raw[1:]).decode()

    def lie(srv):
        # both routes a light block comes by: light_block, and /commit of
        # the fallback
        real, real_lb = srv.routes["commit"], srv.routes["light_block"]

        async def commit(height="0"):
            res = await real(height=height)
            if int(height) == lie_h:
                flip(res["signed_header"]["commit"])
            return res

        async def light_block(height="0"):
            res = await real_lb(height=height)
            if int(height) == lie_h:
                flip(res["light_block"]["signed_header"]["commit"])
            return res
        srv.routes["commit"] = commit
        srv.routes["light_block"] = light_block

    fork_header, fork_commit = _forked_header(chain, top)

    def fork(srv):
        real, real_lb = srv.routes["commit"], srv.routes["light_block"]

        async def commit(height="0"):
            if int(height) == top:
                return {"signed_header": {
                    "header": rpc_core._header_json(fork_header),
                    "commit": rpc_core._commit_json(fork_commit)},
                    "canonical": True}
            return await real(height=height)

        async def light_block(height="0"):
            res = await real_lb(height=height)
            if int(height) == top:
                res["light_block"]["signed_header"] = {
                    "header": rpc_core._header_json(fork_header),
                    "commit": rpc_core._commit_json(fork_commit)}
            return res
        srv.routes["commit"] = commit
        srv.routes["light_block"] = light_block

    async def http_sync(primary_url, witness_urls, mode, height):
        lc = _rpc_light_client(chain, device,
                               HttpProvider(primary_url, chain.chain_id),
                               [HttpProvider(u, chain.chain_id)
                                for u in witness_urls], mode)
        await lc.initialize()
        try:
            await lc.verify_light_block_at_height(height)
        except Exception as e:  # noqa: BLE001 — the case's outcome
            return e
        return None

    async def expect_rpc(call, code, text):
        try:
            await call
        except RPCClientError as e:
            got = str(e)
        else:
            raise AssertionError(f"16e: no refusal for {text!r}")
        if f"({code})" not in got or text not in got:
            raise AssertionError(f"16e: {got!r} is not {text!r} ({code})")
        return got

    async def run():
        out = {}
        srv = await liar_server(lie)
        try:
            url = f"http://127.0.0.1:{srv.port}"
            # (i) the lying commit under B1, then cuda8
            _clear_memos()
            l1 = ek.launches
            out["lie"] = (await http_sync(url, [urls[1]], SEQUENTIAL, lie_h),
                          ek.launches - l1)
            _clear_memos()
            b1, ek8.launches = ek.launches, 0
            os.environ[oe.KERNEL_ENV] = "cuda8"
            try:
                out["lie8"] = (await http_sync(url, [urls[1]], SEQUENTIAL,
                                               lie_h), ek8.launches,
                               ek.launches - b1)
            finally:
                os.environ.pop(oe.KERNEL_ENV, None)
        finally:
            await srv.stop()
        # (ii) a witness forking the top: divergence and evidence
        evpools = [EvidencePool(MemDB(), chain.state_store, chain.block_store,
                                device=device) for _ in range(2)]
        fsrv = await liar_server(fork)
        fsrv.node.evidence_pool = evpools[1]
        primary.node.evidence_pool = evpools[0]
        try:
            _clear_memos()
            l1 = ek.launches
            evs = []
            real_add = evpools[0].add_evidence

            def add_evidence(ev):
                t = time.perf_counter()
                a = ek.launches
                real_add(ev)
                evs.append(((time.perf_counter() - t) * 1e3,
                            ek.launches - a))
            evpools[0].add_evidence = add_evidence
            out["fork"] = (await http_sync(
                urls[0], [f"http://127.0.0.1:{fsrv.port}"], SKIPPING, top),
                ek.launches - l1, evs,
                [len(p.pending_evidence(1 << 20)[0]) for p in evpools])
        finally:
            primary.node.evidence_pool = None
            await fsrv.stop()
        # (iii)-(vii) the server's refusals
        cli = HTTPClient(urls[0])
        out["unsafe"] = await expect_rpc(cli.call("dial_seeds", seeds="a"),
                                         -32601, "unsafe RPC commands disabled"
                                         " (enable with rpc.unsafe)")
        out["unknown"] = await expect_rpc(cli.call("no_such_method"), -32601,
                                          "Method not found")
        out["bad_param"] = await expect_rpc(cli.call("block", bogus="1"),
                                            -32602, "Invalid params")
        big = "x" * (primary.config.max_body_bytes + 1)
        try:
            await cli.call("broadcast_tx_sync", tx=big)
        except (RPCClientError, OSError) as e:
            # the server closes unanswered: an empty answer, or a reset
            # when the unread body is still in flight
            out["body"] = f"{type(e).__name__} {str(e)!r}"
        out["lightserve"] = [
            await expect_rpc(cli.call("light_block", height=str(top + 50)),
                             -32603, f"no light block at height {top + 50}"),
            await expect_rpc(cli.call("multiproof", height=str(top),
                                      indices="x"),
                             -32602, "invalid indices 'x'"),
            await expect_rpc(cli.call("abci_query_batch", data=""), -32602,
                             "no keys provided")]
        # (viii) a raising stand-in kernel under an HTTP hop
        real_kernel = ek.verify_cols

        def raising(*a, **kw):
            raise RuntimeError("stand-in kernel failure (16e)")
        _clear_memos()
        ek.verify_cols = raising
        try:
            out["raising"] = await http_sync(urls[0], [urls[1]], SEQUENTIAL,
                                             SS_TRUST + 1)
        finally:
            ek.verify_cols = real_kernel
        return out

    out = loop.run_until_complete(run())
    err, launches = out["lie"]
    if err is None or "signature" not in str(err) or not launches:
        raise AssertionError(f"16e: the lying commit gave {err!r}")
    lines.append(f"a lying server's commit at {lie_h} (one signature bit): "
                 f"B1 ({launches} launch(es)) refused it, the HTTP sync "
                 f"raised {type(err).__name__} {str(err)[:60]!r}")
    err8, launches8, b1_in_8 = out["lie8"]
    if type(err8) is not type(err) or str(err8) != str(err) or \
            not launches8 or b1_in_8:
        raise AssertionError(f"16e: under cuda8 the lying commit gave "
                             f"{err8!r} with {launches8} B2 and {b1_in_8} "
                             f"B1 launches")
    lines.append(f"the same under cuda8: {launches8} B2 launch(es), 0 B1, "
                 f"the same text")
    ferr, flaunches, evs, pending = out["fork"]
    fwant = f"witness http{{http://127.0.0.1:"
    if not isinstance(ferr, DivergenceError) or \
            not str(ferr).startswith(fwant) or \
            not str(ferr).endswith("} diverges from primary") or \
            len(evs) != 1 or pending != [1, 1]:
        raise AssertionError(f"16e: the forked witness gave {ferr!r}, "
                             f"evidence added {evs}, pending {pending}")
    lines.append(f"a witness forking {top}: DivergenceError {str(ferr)!r}; "
                 f"light-client-attack evidence reported to both servers "
                 f"over broadcast_evidence, the primary's pool verified it "
                 f"in {evs[0][0]:.1f} ms with {evs[0][1]} B1 launch(es) "
                 f"({flaunches} in the case), one pending in each pool")
    for key, what in (("unsafe", "dial_seeds with rpc.unsafe off"),
                      ("unknown", "an unknown method"),
                      ("bad_param", "a bad parameter")):
        lines.append(f"{what}: {out[key][:90]!r}")
    if out.get("body") not in ('RPCClientError "HTTP error: b\'\'"',
                               "ConnectionResetError "
                               "'[Errno 104] Connection reset by peer'"):
        raise AssertionError(f"16e: a body over max_body_bytes gave "
                             f"{out.get('body')!r}")
    lines.append(f"a body over max_body_bytes "
                 f"({primary.config.max_body_bytes} bytes): the connection "
                 f"closed unanswered, the client raised {out['body']}")
    lines.append(f"light_block above the top, multiproof with indices 'x', "
                 f"abci_query_batch with no keys: {out['lightserve']!r}")
    r = out["raising"]
    if not isinstance(r, RuntimeError) or \
            str(r) != "stand-in kernel failure (16e)":
        raise AssertionError(f"16e: the raising kernel was hidden: {r!r}")
    lines.append("a raising stand-in kernel under an HTTP hop: RuntimeError "
                 "'stand-in kernel failure (16e)' surfaced, no fallback")
    return lines, ek.launches - l0 - b1_in_8, launches8


def _signer_proc(addr, chain_id, key_file, state_file):
    """The port's remote signer process dialing ``addr``."""
    import subprocess
    return subprocess.Popen(
        [sys.executable, "-m", "cometbft_tpu_torch.privval.signer",
         "--address", addr, "--chain-id", chain_id, "--key-file", key_file,
         "--state-file", state_file],
        cwd=os.path.dirname(os.path.abspath(__file__)),
        stdout=subprocess.DEVNULL, stderr=subprocess.DEVNULL)


def _privval_net(seed, card, ek, tracing, device, loop, sig):
    """16c privval-4x20 and 16d rpc-tx-4x20: config 1 over sockets as 13a
    wires it, validators 1-3 signing with FilePVs on disk and validator 0
    through the port's signer process (SignerListenerEndpoint and
    RetrySignerClient, as node.py:243-251 wires them), each node with a
    mempool, kv indexers, an IndexerService and an RPCServer; 13a's MockPV
    net as the control.  After PV_HEIGHTS heights, loadtime.generate over
    HTTP, broadcast_tx_commit and a WebSocket client; then the signer is
    killed and restarted from its files.  Returns (B1 launches of the 16c
    heights, what 16d measured, the signer's 16e line)."""
    import copy
    from cometbft_tpu_torch.config import Config, RPCConfig, test_config
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.indexer import (
        BlockIndexer, IndexerService, TxIndexer)
    from cometbft_tpu_torch.privval import file as pvfile
    from cometbft_tpu_torch.privval.file import FilePV, LastSignState
    from cometbft_tpu_torch.privval.signer import RemoteSignerError
    from cometbft_tpu_torch.rpc.client import WSClient
    from cometbft_tpu_torch.rpc.server import RPCServer
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.proposal import Proposal
    from cometbft_tpu_torch.types.timestamp import Timestamp
    n, top = PV_VALIDATORS, PV_HEIGHTS
    _phase(f"16c privval-{n}x{top}: config 1 over sockets (13a's wiring, "
           f"test_config timeouts), validators 1-{n - 1} with FilePVs on "
           f"disk, validator 0 through `python -m "
           f"cometbft_tpu_torch.privval.signer` over TCP; 13a's MockPV net "
           f"for {top} heights as the control")
    doc, pvs = _net_doc(seed + 160, n, "privval-chip")
    tcfg, cfg = test_config(), Config()
    chain_id = doc.chain_id
    ep, client, proc0, tmp = sig["ep"], sig["client"], sig["proc"], sig["dir"]
    _clear_memos()

    async def run_net(make_pv, heights, rpc):
        nodes = [await _sock_node(doc, device, _seed(seed + 161, i),
                                  pv=make_pv(i), config=tcfg.consensus,
                                  mempool_config=cfg.mempool if rpc else None)
                 for i in range(n)]
        extra = {}
        try:
            if rpc:
                for node in nodes:
                    node.tx_indexer = TxIndexer(MemDB())
                    node.block_indexer = BlockIndexer(MemDB())
                    node.indexer = IndexerService(
                        node.tx_indexer, node.block_indexer, node.bus)
                    await node.indexer.start()
                    node.rpc = RPCServer(node, RPCConfig(
                        laddr="tcp://127.0.0.1:0"))
                    await node.rpc.start()
                extra["urls"] = [f"http://127.0.0.1:{nd.rpc.port}"
                                 for nd in nodes]
                ws = WSClient(extra["urls"][0])
                await ws.connect()
                extra["ws"] = ws
                extra["ws_blocks"] = await ws.subscribe(
                    "tm.event = 'NewBlock'")
                extra["ws_txs"] = await ws.subscribe("tm.event = 'Tx'")
            await _sock_mesh(nodes)
            sub = nodes[0].bus.subscribe("chip-smoke-pv",
                                         EVENT_QUERY_NEW_BLOCK,
                                         out_capacity=100_000)
            stamps = [time.perf_counter()]
            l0 = ek.launches
            for node in nodes:
                await node.cs.start()
            for h in range(1, heights + 1):
                for node in nodes:
                    node.cs.raise_if_failed()
                await _cs_new_block(nodes[0], sub, h)
                stamps.append(time.perf_counter())
            extra["launches"] = ek.launches - l0
            if rpc:
                l1 = ek.launches
                extra.update(await _rpc_tx(nodes, extra, heights))
                extra["tx_launches"] = ek.launches - l1
        finally:
            if rpc:
                await extra["ws"].close()
                for node in nodes:
                    await node.indexer.stop()
                    await node.rpc.stop()
            await _sock_stop(nodes)
        return nodes, stamps, extra

    # the FilePVs of validators 1..n-1 on disk; validator 0's key and state
    # live with the signer process
    file_pvs = {}
    for i in range(1, n):
        pv = FilePV(pvs[i].priv_key, os.path.join(tmp, f"key{i}.json"),
                    os.path.join(tmp, f"state{i}.json"))
        pv.save()
        file_pvs[i] = pv
    signed = []                  # what validator 0's signer signed last
    remote_ms, local_ms = [], []
    for name in ("sign_vote_async", "sign_proposal_async"):
        real = getattr(client, name)

        async def timed(chain, obj, *a, real=real):
            t = time.perf_counter()
            await real(chain, obj, *a)
            remote_ms.append((time.perf_counter() - t) * 1e3)
            signed.append(copy.deepcopy(obj))
        setattr(client, name, timed)
    with _timed(FilePV, "sign_vote") as sv, \
            _timed(FilePV, "sign_proposal") as sp_:
        nodes, stamps, extra = loop.run_until_complete(run_net(
            lambda i: client if i == 0 else file_pvs[i], top, rpc=True))
    local_ms = [s * 1e3 for s in list(sv) + list(sp_)]
    launches16c = extra["launches"]
    # kill the signer and restart it from its files; 13a's MockPV net, the
    # control, runs while the new process loads
    proc0.kill()
    proc0.wait(30)
    ep._drop_conn()
    sig["t_restart"] = time.perf_counter()
    proc = _signer_proc(ep.listen_addr, chain_id, sig["key_file"],
                        sig["state_file"])
    sig["proc"] = proc
    nodes_c, stamps_c, extra_c = loop.run_until_complete(
        run_net(lambda i: pvs[i], top, rpc=False))
    ms = [(b - a) * 1e3 for a, b in zip(stamps[1:top + 1],
                                        stamps[2:top + 1])]
    ms_c = [(b - a) * 1e3 for a, b in zip(stamps_c[1:], stamps_c[2:])]
    _log(f"privval_{n}x{top} ms a height (NewBlock to NewBlock on node 0, "
         f"heights 2-{top}) {_p50_p90(ms)} against the MockPV net's "
         f"{_p50_p90(ms_c)} in this call; sign ms a local FilePV "
         f"({len(local_ms)} signs, the fsync'd state file each) "
         f"{_p50_p90(local_ms)}, the remote signer ({len(remote_ms)} "
         f"round trips over TCP) {_p50_p90(remote_ms)}; B1 launches "
         f"{launches16c} ({launches16c / top:.2f} a height; MockPV net "
         f"{extra_c['launches']}); the signer process reached the node "
         f"{sig['connected'][0] - sig['t0']:.2f} s after its start; card: "
         f"{card}")
    # the FilePVs' state files: parse, and hold the last signed height
    for i, pv in file_pvs.items():
        with open(pv.state_file_path) as f:
            lss = LastSignState.from_json(json.load(f))
        if lss != pv.last_sign_state or lss.height < top:
            raise AssertionError(f"16c: validator {i}'s state file says "
                                 f"{lss.height}, it signed "
                                 f"{pv.last_sign_state.height}")
    loop.run_until_complete(ep.wait_for_signer(120))
    restart_s = sig["connected"][1] - sig["t_restart"]
    with open(sig["state_file"]) as f:
        lss = LastSignState.from_json(json.load(f))
    # the file is at or past the last signature node 0 received: a request
    # in flight when the net stopped may be signed and never received
    seen = signed[-1]
    seen_hrs = (seen.height, seen.round, pvfile.STEP_PROPOSE
                if isinstance(seen, Proposal)
                else pvfile._STEP_BY_VOTE_TYPE[seen.type])
    if (lss.height, lss.round, lss.step) < seen_hrs or \
            ((lss.height, lss.round, lss.step) == seen_hrs and
             lss.signature != seen.signature):
        raise AssertionError(f"16c: the signer's state file holds "
                             f"{lss.height}/{lss.round}/{lss.step}, node 0 "
                             f"received {seen_hrs}")
    last = _signed_from_state(lss, chain_id, seen)
    inner = client.client
    attempts = []
    real_vote = inner.sign_vote_async
    real_prop = inner.sign_proposal_async

    async def counted_vote(*a):
        attempts.append(1)
        return await real_vote(*a)

    async def counted_prop(*a):
        attempts.append(1)
        return await real_prop(*a)
    inner.sign_vote_async, inner.sign_proposal_async = counted_vote, \
        counted_prop
    is_prop = isinstance(last, Proposal)
    conflict = copy.deepcopy(last)
    conflict.block_id = BlockID(hash=b"\x99" * 32,
                                part_set_header=PartSetHeader(1, b"\x98" * 32))
    conflict.signature = b""
    stamp = copy.deepcopy(last)
    stamp.timestamp = Timestamp(last.timestamp.seconds + 1,
                                last.timestamp.nanos)
    stamp.signature = b""

    async def sign(obj):
        if is_prop:
            await client.sign_proposal_async(chain_id, obj)
        else:
            await client.sign_vote_async(chain_id, obj, False)
    step = lss.step
    want = (f"conflicting proposal data at {last.height}/{last.round}"
            if is_prop else f"conflicting vote data at "
            f"{last.height}/{last.round}/{step}")
    try:
        loop.run_until_complete(sign(conflict))
        got = None
    except pvfile.DoubleSignError as e:
        got = str(e)
    if got != want or len(attempts) != 1:
        raise AssertionError(f"16c: the conflicting request gave {got!r} "
                             f"after {len(attempts)} attempt(s)")
    loop.run_until_complete(sign(stamp))
    if stamp.signature != lss.signature or \
            stamp.timestamp != last.timestamp:
        raise AssertionError("16c: the timestamp-only request was re-signed")
    lines = [f"the restarted signer (up in {restart_s:.2f} s) refused "
             f"{'a proposal' if is_prop else 'a vote'} at the last signed "
             f"{last.height}/{last.round}/{step} with another block: "
             f"DoubleSignError {got!r}, in 1 attempt (not retried); the same "
             f"request differing only in its timestamp got back the stored "
             f"signature and timestamp"]
    # the signer gone: RetrySignerClient gives up after its retries
    proc.kill()
    proc.wait(30)
    attempts.clear()
    try:
        loop.run_until_complete(sign(copy.deepcopy(stamp)))
        gone = None
    except RemoteSignerError as e:
        gone = str(e)
    if gone != "no signer connected" or len(attempts) != client.retries:
        raise AssertionError(f"16c: with the signer gone the client gave "
                             f"{gone!r} after {len(attempts)} attempts")
    lines.append(f"the signer gone: RetrySignerClient gave up after "
                 f"{len(attempts)} attempts with RemoteSignerError {gone!r}")
    _log(f"privval_{n}x{top} gates held: each FilePV state file parses and "
         f"holds its validator's last signed height; the signer's state file "
         f"holds {lss.height}/{lss.round}/{lss.step}, at or past the last "
         f"signature node 0 received ({'/'.join(map(str, seen_hrs))}; a "
         f"request in flight at the stop can be signed and not received); "
         + "; ".join(lines[:1]))
    return launches16c, extra, lines[1:]


def _signed_from_state(lss, chain_id, like):
    """The vote or proposal whose sign bytes a LastSignState holds, rebuilt
    from its canonical form (validator fields from ``like``, a vote node 0
    signed); raises unless its sign bytes are the stored ones."""
    import copy
    from cometbft_tpu_torch.privval import file as pvfile
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.part_set import PartSetHeader
    from cometbft_tpu_torch.types.proposal import Proposal
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import Vote
    from cometbft_tpu_torch.wire import pb, unmarshal_delimited
    is_prop = lss.step == pvfile.STEP_PROPOSE
    d, _ = unmarshal_delimited(
        pb.CANONICAL_PROPOSAL if is_prop else pb.CANONICAL_VOTE,
        lss.sign_bytes)
    bid = d.get("block_id") or {}
    psh = bid.get("part_set_header") or {}
    block_id = BlockID(hash=bid.get("hash", b""), part_set_header=PartSetHeader(
        psh.get("total", 0), psh.get("hash", b"")))
    ts = Timestamp.from_proto(d.get("timestamp") or {})
    if is_prop:
        obj = Proposal(height=d.get("height", 0), round=d.get("round", 0),
                       pol_round=d.get("pol_round", 0), block_id=block_id,
                       timestamp=ts)
    else:
        base = like if isinstance(like, Vote) else Vote()
        obj = copy.deepcopy(base)
        obj.type, obj.height, obj.round = d.get("type", 0), \
            d.get("height", 0), d.get("round", 0)
        obj.block_id, obj.timestamp = block_id, ts
        obj.extension = obj.non_rp_extension = b""
    obj.signature = lss.signature
    if obj.sign_bytes(chain_id) != lss.sign_bytes:
        raise AssertionError("16c: the signer's last sign bytes do not "
                             "decode to a vote or proposal")
    return obj


async def _rpc_tx(nodes, extra, start):
    """16d's load over the running privval net: loadtime.generate over HTTP
    round-robin, broadcast_tx_commit, then every tx looked up over RPC."""
    import base64
    import inspect
    from cometbft_tpu_torch.types.events import EventBus
    from cometbft_tpu_torch.rpc.client import HTTPClient
    from cometbft_tpu_torch.tools import loadtime
    from cometbft_tpu_torch.types.tx import tx_hash, txs_proof
    urls, exp = extra["urls"], "chip-smoke-rpc"
    sent = []
    real_payload = loadtime.payload_bytes

    def recording(*a, **kw):
        tx = real_payload(*a, **kw)
        sent.append(tx)
        return tx
    loadtime.payload_bytes = recording
    t0 = time.perf_counter()
    try:
        res = await loadtime.generate(
            urls, rate=RPC_LOAD_RATE, connections=1,
            duration_s=RPC_LOAD_SECONDS, size=RPC_TX_BYTES,
            experiment_id=exp, method="async")
    finally:
        loadtime.payload_bytes = real_payload
    commits = [loadtime.payload_bytes(exp, size=RPC_TX_BYTES,
                                      rate=RPC_LOAD_RATE)
               for _ in range(RPC_COMMIT_TXS)]
    answers = await asyncio.gather(*(
        HTTPClient(urls[i % len(urls)]).broadcast_tx_commit(tx)
        for i, tx in enumerate(commits)))
    if any(int(a["check_tx"].get("code", 0)) or
           int(a["tx_result"].get("code", 0)) for a in answers):
        raise AssertionError(f"16d: a broadcast_tx_commit failed: {answers}")
    want = sent + commits
    deadline = time.perf_counter() + 120
    while not all(nd.mempool.size() == 0 for nd in nodes) or \
            nodes[0].block_store.height < start + RPC_TX_HEIGHTS:
        for nd in nodes:
            nd.cs.raise_if_failed()
        if time.perf_counter() > deadline:
            raise AssertionError(
                f"16d: the pools hold "
                f"{[nd.mempool.size() for nd in nodes]} txs at height "
                f"{nodes[0].block_store.height} after 120 s")
        await asyncio.sleep(0.01)
    done_s = time.perf_counter() - t0
    top = min(nd.block_store.height for nd in nodes)
    await asyncio.sleep(0.05)                   # the indexers' last events
    # every acknowledged tx by /tx and by tx_search at its block's height
    where = {}
    for h in range(1, top + 1):
        for tx in nodes[0].block_store.load_block(h).data.txs:
            where[tx] = h
    missing = [tx for tx in want if tx not in where]
    if missing or res.errors or res.accepted != len(sent):
        raise AssertionError(f"16d: {len(missing)} of {len(want)} acked txs "
                             f"not committed ({res.accepted} of {len(sent)} "
                             f"generate sends acked)")
    calls = collections.Counter()
    by_height = collections.defaultdict(set)
    for i, tx in enumerate(want):
        cli = HTTPClient(urls[i % len(urls)])
        got = await cli.tx(tx_hash(tx))
        calls["tx"] += 1
        if int(got["height"]) != where[tx] or \
                base64.b64decode(got["tx"]) != tx:
            raise AssertionError(f"16d: /tx gave height {got['height']} for "
                                 f"a tx of {where[tx]}")
        by_height[where[tx]].add(tx_hash(tx).hex().upper())
    for h, hashes in by_height.items():
        found, page = set(), 1
        while True:
            r = await HTTPClient(urls[h % len(urls)]).call(
                "tx_search", query=f"tx.height={h}", page=str(page),
                per_page="100")
            calls["tx_search"] += 1
            found |= {t["hash"] for t in r["txs"]}
            if len(found) >= int(r["total_count"]) or not r["txs"]:
                break
            page += 1
        if not hashes <= found:
            raise AssertionError(f"16d: tx_search tx.height={h} misses "
                                 f"{len(hashes - found)} txs")
    heights, page = set(), 1
    while True:
        r = await HTTPClient(urls[0]).call(
            "block_search", query="block.height >= 1", page=str(page),
            per_page="100")
        calls["block_search"] += 1
        heights |= {int(b["block"]["header"]["height"]) for b in r["blocks"]}
        if len(heights) >= int(r["total_count"]) or not r["blocks"]:
            break
        page += 1
    if not set(range(1, top + 1)) <= heights:
        raise AssertionError(f"16d: block_search misses heights "
                             f"{sorted(set(range(1, top + 1)) - heights)[:5]}")
    # the WebSocket saw every height and every committed tx
    ws_heights, ws_txs = set(), set()
    while True:
        try:
            item = await extra["ws_blocks"].next(0.01)
        except asyncio.TimeoutError:
            break
        ws_heights.add(int(item["data"]["value"]["block"]["header"]["height"]))
    while True:
        try:
            item = await extra["ws_txs"].next(0.01)
        except asyncio.TimeoutError:
            break
        ws_txs.add(base64.b64decode(item["data"]["value"]["tx"]))
    # a block of more Tx events than the session's subscription holds
    # cancels it (the JAX WsSession's buffer, EventBus.subscribe's, as
    # the reference cancels a subscriber past its buffer): from that block
    # on the WebSocket sees no Tx
    cap = inspect.signature(EventBus.subscribe).parameters[
        "out_capacity"].default
    per_block = {h: len(nodes[0].block_store.load_block(h).data.txs)
                 for h in range(1, top + 1)}
    over = [h for h in sorted(per_block) if per_block[h] > cap]
    seen_before = {tx for tx, h in where.items() if not over or h < over[0]}
    if not set(range(1, top + 1)) <= ws_heights or \
            not seen_before <= ws_txs or not ws_txs <= set(where):
        raise AssertionError(f"16d: the WebSocket saw {len(ws_heights)} of "
                             f"{top} heights, {len(ws_txs)} of {len(where)} "
                             f"txs")
    rep = await loadtime.report(urls[0], exp)
    calls["report"] = rep.heights + 1
    if rep.latency.count != len(want):
        raise AssertionError(f"16d: report counts {rep.latency.count}, "
                             f"{len(want)} committed")
    # the largest block the net committed (its commit checked on B1): each
    # tx's txs_proof against the header's data_hash
    proof_h = max(per_block, key=lambda h: (per_block[h], h))
    blk = nodes[0].block_store.load_block(proof_h)
    for i, tx in enumerate(blk.data.txs):
        root, proof = txs_proof(blk.data.txs, i)
        if root != blk.header.data_hash:
            raise AssertionError(f"16d: txs_proof's root at {proof_h} is not "
                                 f"the header's data_hash")
        proof.verify(root, tx_hash(tx))
    widths = [len(nd.cs.sm_state.validators) for nd in nodes]
    if widths != [PV_VALIDATORS] * len(nodes):
        raise AssertionError(f"16d: len(state.validators) {widths}, the net "
                             f"has {PV_VALIDATORS}")
    return {"load": res, "report": rep, "want": len(want), "calls": calls,
            "proof": (proof_h, len(blk.data.txs), widths),
            "ws_txs": len(ws_txs), "ws_cut": (over[0], per_block[over[0]],
                                              cap) if over else None,
            "max_block": max(per_block.values()),
            "done_s": done_s, "tx_top": top, "commit_answers": answers}


def _rpc_phases(seed, card, keep, device=None):
    """Phases 16a-16e: privval and the JSON-RPC (privval/, indexer/, rpc/,
    light/provider.HttpProvider, statesync/syncer.new_rpc_state_provider,
    tools/loadtime.generate / report) over 15a's source.  Returns B1's
    launches by part and B2's."""
    import tempfile
    from cometbft_tpu_torch.config import RPCConfig
    from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    from cometbft_tpu_torch.privval.file import FilePV
    from cometbft_tpu_torch.privval.signer import (
        RetrySignerClient, SignerClient, SignerListenerEndpoint)
    from cometbft_tpu_torch.rpc.server import RPCServer
    t_phase = time.perf_counter()
    src, n, top = keep["ss_src"], EXEC_VALIDATORS, SS_HEIGHTS
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    tmp = tempfile.TemporaryDirectory()
    sig = {"dir": tmp.name, "proc": None}
    servers = []
    try:
        # validator 0's signer process starts first (torch's import and the
        # host ed25519 library's load), and dials in while 16a-16b run
        key0 = Ed25519PrivKey(_seed(seed + 160, 0))
        sig["key_file"] = os.path.join(tmp.name, "signer_key.json")
        sig["state_file"] = os.path.join(tmp.name, "signer_state.json")
        FilePV(key0, sig["key_file"], sig["state_file"]).save()
        ep = SignerListenerEndpoint("tcp://127.0.0.1:0")
        real_on_connect = ep._on_connect

        async def on_connect(reader, writer):
            sig.setdefault("connected", []).append(time.perf_counter())
            await real_on_connect(reader, writer)
        ep._on_connect = on_connect
        loop.run_until_complete(ep.start())
        sig["t0"] = time.perf_counter()
        sig["proc"] = _signer_proc(ep.listen_addr, "privval-chip",
                                   sig["key_file"], sig["state_file"])
        sig["ep"] = ep
        for _ in range(2):
            srv = RPCServer(_StoreNode(src["chain"]),
                            RPCConfig(laddr="tcp://127.0.0.1:0"))
            loop.run_until_complete(srv.start())
            servers.append(srv)
        urls = [f"http://127.0.0.1:{s.port}" for s in servers]
        with _RpcCount(servers) as count:
            light = _rpc_light(seed, card, ek, tracing, device, loop, src,
                               urls, count)
            ss = _rpc_statesync(seed, card, ek, oe, device, loop, src, keep,
                                urls, count)
        reject_lines, reject, reject8 = _rpc_reject(
            seed, card, ek, ek8, oe, device, loop, src, servers, urls)
        for srv in servers:
            loop.run_until_complete(srv.stop())
        servers = []
        loop.run_until_complete(ep.wait_for_signer(120))
        client = RetrySignerClient(SignerClient(ep, "privval-chip"))
        loop.run_until_complete(client.fetch_pub_key())
        if client.get_pub_key() != key0.pub_key():
            raise AssertionError("16c: the signer serves another key")
        sig["client"] = client
        pv_launches, extra, signer_lines = _privval_net(
            seed, card, ek, tracing, device, loop, sig)
        _phase(f"16d rpc-tx-{PV_VALIDATORS}x{RPC_TX_HEIGHTS}: 16c's net, "
               f"each node with an RPCServer, kv indexers and an "
               f"IndexerService; loadtime.generate {RPC_LOAD_RATE} tx/s of "
               f"{RPC_TX_BYTES}-byte payloads over HTTP (broadcast_tx_async, "
               f"round-robin) for {RPC_LOAD_SECONDS:.0f} s, "
               f"{RPC_COMMIT_TXS} broadcast_tx_commit, a WebSocket on "
               f"NewBlock and Tx, then report over RPC")
        res, rep = extra["load"], extra["report"]
        lat = rep.latency
        _log(f"rpc_tx_{PV_VALIDATORS}x{RPC_TX_HEIGHTS} generate sent "
             f"{res.sent} (acked {res.accepted}, errors {res.errors}, "
             f"dropped {res.dropped}) in {res.duration_s:.2f} s; "
             f"{extra['want']} txs committed by height {extra['tx_top']}, "
             f"{extra['want'] / extra['done_s']:.1f} tx/s from the first "
             f"send to the last pool drained ({extra['done_s']:.2f} s); "
             f"report: latency p50 {lat.p50_s * 1e3:.1f} ms, p90 "
             f"{lat.p90_s * 1e3:.1f} ms, max {lat.max_s * 1e3:.1f} ms over "
             f"{lat.count} txs, {rep.heights} heights, block interval p50 "
             f"{rep.block_interval.p50_s * 1e3:.1f} ms; RPC calls "
             f"{dict(extra['calls'])} plus {res.sent} broadcast_tx_async and "
             f"{RPC_COMMIT_TXS} broadcast_tx_commit; card: {card}")
        cut = extra["ws_cut"]
        ws = ("every committed tx" if cut is None else
              f"every tx committed before height {cut[0]}, whose {cut[1]} "
              f"Tx events overflowed its subscription's {cut[2]} and "
              f"canceled it, as the JAX and reference servers cancel a "
              f"subscriber past its buffer ({extra['ws_txs']} txs seen)")
        _log(f"rpc_tx_{PV_VALIDATORS}x{RPC_TX_HEIGHTS} gates held: every "
             f"acknowledged tx found by /tx and by tx_search tx.height=H at "
             f"its block's height (the largest block {extra['max_block']} "
             f"txs), block_search finds every height, the WebSocket saw "
             f"every height and {ws}, report's count is the txs committed")
        proof_h, proof_n, widths = extra["proof"]
        _log(f"rpc_tx_{PV_VALIDATORS}x{RPC_TX_HEIGHTS} txs_proof: block "
             f"{proof_h}'s {proof_n} txs, each proof's root the header's "
             f"data_hash and each proof verified; len(state.validators) "
             f"{widths} on the nodes, the net's {PV_VALIDATORS}")
        _phase(f"16e rpc-reject (run before 16c, and after it for the "
               f"signer): a lying server's commit at {SS_TRUST + 5} (one "
               f"signature bit) under B1 and cuda8; a witness forking {top}; "
               f"the unsafe routes, an unknown method, a bad parameter, a "
               f"body over max_body_bytes, the lightserve routes; a raising "
               f"stand-in kernel under an HTTP hop; the signer gone")
        for line in reject_lines + signer_lines:
            _log(f"rpc_reject {line}")
        _log(f"rpc_reject all {len(reject_lines) + len(signer_lines)} "
             f"outcomes as the JAX package decides them; card: {card}")
    finally:
        for srv in servers:
            loop.run_until_complete(srv.stop())
        if sig.get("proc") is not None and sig["proc"].poll() is None:
            sig["proc"].kill()
            sig["proc"].wait(30)
        if "ep" in sig:
            loop.run_until_complete(sig["ep"].stop())
        logging.disable(logging.NOTSET)
        loop.close()
        tmp.cleanup()
    _log(f"phase 16 took {time.perf_counter() - t_phase:.1f} s")
    return ({f"rpc_light_{n}x{top}": light,
             f"rpc_statesync_{n}x{top}": ss,
             f"privval_{PV_VALIDATORS}x{PV_HEIGHTS}": pv_launches,
             f"rpc_tx_{PV_VALIDATORS}x{RPC_TX_HEIGHTS}":
                 extra["tx_launches"],
             "rpc_reject": reject},
            {"rpc_reject_cuda8": reject8})


LIGHTSERVE_ROUTES = ("light_block", "multiproof", "abci_query_batch")


def _ls_servers(loop, chain, lightserve=True):
    """Primary and witness RPCServers over the source's stores.  With
    ``lightserve`` each keeps a ResponseCache of the JAX default budget
    (the JAX Node's wiring) and the source's kvstore pins the heights
    either cache holds; without, the route table lacks the three
    lightserve routes (a server from before them: HttpProvider falls back
    to /commit and paged /validators)."""
    from cometbft_tpu_torch.config import RPCConfig
    from cometbft_tpu_torch.lightserve import ResponseCache
    from cometbft_tpu_torch.rpc import core as rpc_core
    from cometbft_tpu_torch.rpc.server import RPCServer
    servers = []
    for _ in range(2):
        if lightserve:
            node = _StoreNode(chain, cache=ResponseCache(
                RPCConfig().cache_max_bytes))
            routes = None
        else:
            node = _StoreNode(chain)
            routes = {k: v for k, v in rpc_core.routes(
                rpc_core.Environment(node)).items()
                if k not in LIGHTSERVE_ROUTES}
        srv = RPCServer(node, RPCConfig(laddr="tcp://127.0.0.1:0"),
                        routes=routes)
        loop.run_until_complete(srv.start())
        servers.append(srv)
    if lightserve:
        caches = [srv.node.lightserve_cache for srv in servers]
        chain.app.version_pin = lambda: set().union(
            *(c.heights() for c in caches))
    return servers


def _ls_cache_stats(servers):
    return {k: sum(srv.node.lightserve_cache.stats()[k] for srv in servers)
            for k in ("hits", "misses", "entries", "bytes", "evictions")}


def _ls_light(card, ek, tracing, device, loop, src, servers, fallback):
    """17a rpc-lightserve: 16a's syncs from the trust root to the top over
    servers that serve light_block, against NodeProviders and against
    servers without the lightserve routes, in one run; then a second
    client's pass over the lightserve servers.  Returns B1's launches
    over the lightserve servers."""
    from cometbft_tpu_torch.light.client import SEQUENTIAL, SKIPPING
    from cometbft_tpu_torch.light.provider import HttpProvider, NodeProvider
    chain, n, top = src["chain"], EXEC_VALIDATORS, SS_HEIGHTS
    _phase(f"17a rpc-lightserve-{n}x{top}: 16a's syncs from the trust root "
           f"{SS_TRUST} to {top} ({top - SS_TRUST} sequential hops, one "
           f"skip) over two RPCServers serving light_block with a response "
           f"cache, against NodeProviders and against two servers without "
           f"the lightserve routes; then a second client's pass")
    urls = {via: [f"http://127.0.0.1:{s.port}" for s in srvs]
            for via, srvs in (("lightserve", servers),
                              ("fallback", fallback))}
    out = {}

    def providers(via):
        if via == "node":
            return [NodeProvider(chain.block_store, chain.state_store,
                                 chain.chain_id) for _ in range(2)]
        return [HttpProvider(u, chain.chain_id) for u in urls[via]]

    async def run():
        with _RpcCount(servers + fallback) as count:
            for mode in (SEQUENTIAL, SKIPPING):
                for via in ("node", "lightserve", "fallback"):
                    _clear_memos()
                    tracing.clear()
                    count.take()
                    out[(via, mode)] = await _light_sync(
                        chain, device, ek, providers(via), mode, top)
                    out[(via, "lanes", mode)] = sorted(
                        ev["attrs"]["batch"]
                        for ev in tracing.snapshot(category=tracing.CRYPTO)
                        if ev["name"] == "batch_verify")
                    out[(via, "rpc", mode)] = count.take()
            # round trips and bytes a light block, a fresh provider each
            for via in ("lightserve", "fallback"):
                out[(via, "per_block")] = await _stored_light_blocks(
                    chain, providers(via)[0], count, f"17a ({via})")
            # a second client's pass over the same heights
            before = _ls_cache_stats(servers)
            _clear_memos()
            out["second"] = await _light_sync(
                chain, device, ek, providers("lightserve"), SEQUENTIAL, top)
            after = _ls_cache_stats(servers)
            out["second_cache"] = {k: after[k] - before[k]
                                   for k in ("hits", "misses")}
            out["cache"] = after
            out["second_rpc"] = count.take()

    loop.run_until_complete(run())
    want_hash = chain.block_store.load_block_meta(top).block_id.hash
    for key in [(via, mode) for via in ("node", "lightserve", "fallback")
                for mode in (SEQUENTIAL, SKIPPING)] + ["second"]:
        latest = out[key][0].store.latest()
        if latest.height != top or \
                latest.signed_header.header.hash() != want_hash:
            raise AssertionError(f"17a: the {key} sync ends at "
                                 f"{latest.height}, not {top} with the "
                                 f"source's hash")
    # the gates
    for mode in (SEQUENTIAL, SKIPPING):
        calls, _ = out[("lightserve", "rpc", mode)]
        if set(calls) != {"light_block"}:
            raise AssertionError(f"17a: the {mode} sync over the lightserve "
                                 f"servers called {calls}")
        if out[("lightserve", mode)][2] != out[("node", mode)][2] or \
                out[("lightserve", "lanes", mode)] != \
                out[("node", "lanes", mode)]:
            raise AssertionError(
                f"17a: {mode} B1 launches / lanes over lightserve "
                f"{out[('lightserve', mode)][2]} / "
                f"{out[('lightserve', 'lanes', mode)]} != NodeProvider's "
                f"{out[('node', mode)][2]} / {out[('node', 'lanes', mode)]}")
    per = out[("lightserve", "per_block")]
    if any(c != {"light_block": 1} for c, _ in per):
        raise AssertionError(f"17a: a light block over lightserve took "
                             f"{[c for c, _ in per]}")
    if set(out["second_rpc"][0]) != {"light_block"} or \
            out["second_cache"]["hits"] <= 0:
        raise AssertionError(f"17a: the second pass called "
                             f"{out['second_rpc'][0]} with cache "
                             f"{out['second_cache']}")
    launches = sum(out[("lightserve", m)][2] for m in (SEQUENTIAL, SKIPPING))
    fper = out[("fallback", "per_block")]
    for mode in (SEQUENTIAL, SKIPPING):
        row = ", ".join(
            f"{via} " + (_p50_p90(out[(via, mode)][1])
                         if mode == SEQUENTIAL else
                         f"{out[(via, mode)][1][0]:.1f}") +
            f" ms, {out[(via, mode)][2]} B1 launch(es), stall "
            f"{out[(via, mode)][3] * 1e3:.1f} ms" +
            ("" if via == "node" else
             f", {sum(out[(via, 'rpc', mode)][0].values())} calls "
             f"{out[(via, 'rpc', mode)][1]} bytes")
            for via in ("lightserve", "node", "fallback"))
        _log(f"rpc_lightserve_{n}x{top} {mode} "
             f"({top - SS_TRUST if mode == SEQUENTIAL else 1} hop(s), ms a "
             f"hop): {row}; B1 lanes a launch over lightserve "
             f"{sorted(collections.Counter(out[('lightserve', 'lanes', mode)]).items())}"
             f" (NodeProvider the same); card: {card}")
    _log(f"rpc_lightserve_{n}x{top} a light block over lightserve: "
         f"{sorted(collections.Counter(sum(c.values()) for c, _ in per).items())}"
         f" round trips (light_block only), bytes "
         f"{_p50_p90([b for _, b in per])}; over the fallback: first "
         f"{sum(fper[0][0].values())} round trips {fper[0][0]}, "
         f"{fper[0][1]} bytes, then "
         f"{sorted(collections.Counter(sum(c.values()) for c, _ in fper[1:]).items())}"
         f" round trips, bytes {_p50_p90([b for _, b in fper[1:]])}; no "
         f"/commit or /validators reached a light_block server")
    second = out["second"]
    _log(f"rpc_lightserve_{n}x{top} second client's sequential pass: ms a "
         f"hop {_p50_p90(second[1])}, {second[2]} B1 launches, cache hits "
         f"{out['second_cache']['hits']} misses "
         f"{out['second_cache']['misses']} (the tip {top} is never cached); "
         f"the two caches hold {out['cache']['entries']} entries, "
         f"{out['cache']['bytes']} bytes, {out['cache']['evictions']} "
         f"evictions; every sync trusts {top} at the source's hash")
    return launches + second[2]


def _ls_proofs(seed, card, ek, ek8, oe, device, loop, src, servers, count):
    """17b state-proofs: abci_query_batch with prove=true at LS_VERSION
    (LS_PRESENT present keys, LS_ABSENT absent) checked against the
    app_hash of the header at LS_VERSION + 1, which the light client
    verifies on B1 (and again under cuda8); multiproof over every tx of
    that block and over LS_MP_PICK of them against its data_hash; the
    tampered checks.  Returns (B1 launches, B2 launches)."""
    import numpy as np
    from cometbft_tpu_torch.crypto.merkle import Multiproof
    from cometbft_tpu_torch.light.client import SKIPPING
    from cometbft_tpu_torch.light.provider import HttpProvider
    from cometbft_tpu_torch.light.state_proof import verify_state_proof
    from cometbft_tpu_torch.lightserve.core import verify_kv_multiproof
    from cometbft_tpu_torch.rpc.client import HTTPClient
    chain, n, v = src["chain"], EXEC_VALIDATORS, LS_VERSION
    _phase(f"17b state-proofs-{n}x{SS_HEIGHTS}: abci_query_batch prove=true "
           f"at version {v} ({LS_PRESENT} present keys, {LS_ABSENT} absent) "
           f"against the app_hash of header {v + 1}, verified by the light "
           f"client on B1; multiproof over block {v + 1}'s {EXEC_TXS} txs "
           f"and over {LS_MP_PICK} of them")
    rng = np.random.default_rng(seed + 171)
    # every keyed tx's key up to v, but the val= txs' slots
    pool_keys = [b"%d.%d" % (h, j) for h in range(1, v + 1)
                 for j in range(EXEC_TXS)
                 if not (h in EXEC_UPDATES and j == EXEC_TXS - 1)]
    present = [pool_keys[i] for i in sorted(rng.choice(
        len(pool_keys), min(LS_PRESENT, len(pool_keys)), replace=False))]
    absent = [b"absent.%d" % i for i in range(LS_ABSENT)]
    urls = [f"http://127.0.0.1:{s.port}" for s in servers]
    out = {}

    async def verified_header(kernel_env):
        _clear_memos()
        if kernel_env:
            os.environ[oe.KERNEL_ENV] = kernel_env
        try:
            lc = _rpc_light_client(
                chain, device, HttpProvider(urls[0], chain.chain_id),
                [HttpProvider(urls[1], chain.chain_id)], SKIPPING)
            await lc.initialize()
            lb = await lc.verify_light_block_at_height(v + 1)
        finally:
            os.environ.pop(oe.KERNEL_ENV, None)
        return lb.signed_header.header

    async def run():
        cli = HTTPClient(urls[0], timeout=60.0)
        l0 = ek.launches
        out["hdr"] = await verified_header(None)
        out["b1"] = ek.launches - l0
        b1, ek8.launches = ek.launches, 0
        out["hdr8"] = await verified_header("cuda8")
        out["b2"], out["b1_in_8"] = ek8.launches, ek.launches - b1
        count.take()
        data = ",".join("0x" + k.hex() for k in present + absent)
        t = time.perf_counter()
        out["batch"] = await cli.call("abci_query_batch", data=data,
                                      height=str(v), prove=True)
        out["batch_ms"] = (time.perf_counter() - t) * 1e3
        out["batch_rpc"] = count.take()
        t = time.perf_counter()
        out["singles"] = [await cli.abci_query("", k, height=v)
                          for k in present]
        out["singles_ms"] = (time.perf_counter() - t) * 1e3
        out["singles_rpc"] = count.take()
        picks = sorted(rng.choice(EXEC_TXS, min(LS_MP_PICK, EXEC_TXS),
                                  replace=False).tolist())
        for name, idx in (("all", list(range(EXEC_TXS))), ("pick", picks)):
            t = time.perf_counter()
            out[name] = await cli.call(
                "multiproof", height=str(v + 1),
                indices=",".join(map(str, idx)))
            out[name + "_ms"] = (time.perf_counter() - t) * 1e3
            out[name + "_rpc"] = count.take()
            out[name + "_idx"] = idx

    loop.run_until_complete(run())
    hdr = out["hdr"]
    want = chain.block_store.load_block_meta(v + 1).header
    if hdr.hash() != want.hash() or out["hdr8"].hash() != want.hash() or \
            not out["b1"] or not out["b2"] or out["b1_in_8"]:
        raise AssertionError(f"17b: header {v + 1} over the light client: "
                             f"{out['b1']} B1, {out['b2']} B2 and "
                             f"{out['b1_in_8']} B1 under cuda8 launches")
    res = out["batch"]
    proof = res["proof"]
    kv = [(base64.b64decode(r["key"]), base64.b64decode(r["value"]))
          for r in res["responses"][:len(present)]]
    logs = [r["log"] for r in res["responses"]]
    if [k for k, _ in kv] != present or \
            logs != ["exists"] * len(present) + \
            ["does not exist"] * len(absent) or \
            int(proof["version"]) != v or \
            int(proof["header_height"]) != v + 1:
        raise AssertionError(f"17b: the batch answered {logs[:3]}... at "
                             f"version {proof.get('version')}")
    verify_kv_multiproof(proof, kv, absent, verified_header=hdr)
    verify_state_proof(hdr, proof, present=kv, absent=absent)
    # the tampered ones, refused with the JAX texts
    bad = json.loads(json.dumps(proof))
    x = bad["values"][0]
    bad["values"][0] = ("0" if x[0] != "0" else "1") + x[1:]
    refusals = []
    for pr, kw, text in (
            (bad, {"present": kv, "absent": absent},
             "invalid multiproof: root mismatch"),
            (proof, {"present": kv + [(absent[0], b"")],
                     "absent": absent[1:]},
             f"key {absent[0].hex()} not covered by proof")):
        try:
            verify_state_proof(hdr, pr, **kw)
        except ValueError as e:
            if str(e) != text:
                raise AssertionError(f"17b: refused with {e!r}, not "
                                     f"{text!r}")
            refusals.append(str(e))
        else:
            raise AssertionError(f"17b: no refusal for {text!r}")
    block = chain.block_store.load_block(v + 1)
    for name in ("all", "pick"):
        mp = Multiproof.from_dict(out[name]["multiproof"])
        txs = [base64.b64decode(t) for t in out[name]["txs"]]
        if txs != [block.data.txs[i] for i in out[name + "_idx"]]:
            raise AssertionError(f"17b: multiproof {name} brought other txs")
        mp.verify(hdr.data_hash, [hashlib.sha256(t).digest() for t in txs])
    singles_bytes = out["singles_rpc"][1]
    _log(f"state_proofs_{n}x{SS_HEIGHTS} abci_query_batch prove=true at "
         f"{v}: {len(present)} present + {len(absent)} absent keys in "
         f"{out['batch_ms']:.1f} ms, {out['batch_rpc'][1]} response bytes, "
         f"{len(proof['indices'])} proven leaves of {proof['total']}, "
         f"{len(proof['multiproof']['aunts'])} aunts; {len(present)} single "
         f"abci_query calls: {out['singles_ms']:.1f} ms, {singles_bytes} "
         f"bytes and no proof; verify_kv_multiproof and verify_state_proof "
         f"hold it to header {v + 1}'s app_hash (header verified over "
         f"HTTP with {out['b1']} B1 launch(es); under cuda8 "
         f"{out['b2']} B2, 0 B1); card: {card}")
    _log(f"state_proofs_{n}x{SS_HEIGHTS} multiproof of block {v + 1}: all "
         f"{EXEC_TXS} txs {out['all_ms']:.1f} ms {out['all_rpc'][1]} bytes "
         f"({len(out['all']['multiproof']['aunts'])} aunts), "
         f"{len(out['pick_idx'])} seeded txs {out['pick_ms']:.1f} ms "
         f"{out['pick_rpc'][1]} bytes "
         f"({len(out['pick']['multiproof']['aunts'])} aunts), both verify "
         f"against its data_hash; refused with the JAX texts: {refusals}")
    return out["b1"], out["b2"]


def _ls_pins(seed, card, loop, src, servers):
    """17c pins: a proven batch cached at LS_PIN, below the retain horizon
    that LS_PIN_HEIGHTS more commits move the tree to; the pinned version
    stays provable, unpinned ones below the horizon are gone."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.light.state_proof import verify_state_proof
    from cometbft_tpu_torch.rpc.client import HTTPClient
    chain, tree, pin = src["chain"], src["chain"].app.tree, LS_PIN
    top = chain.block_store.height
    new_top = top + LS_PIN_HEIGHTS
    horizon = new_top - SS_RETAIN
    _phase(f"17c pins: a proven batch cached at {pin}, then {LS_PIN_HEIGHTS} "
           f"commits ({top + 1}-{new_top}) move the tree's horizon from "
           f"{tree.base_version} to {horizon}")
    keys = [b"%d.%d" % (h, 0) for h in range(pin - 4, pin + 1)] + \
        [b"absent.pin"]
    data = json.dumps({"keys": [k.hex() for k in keys]}).encode()

    async def run():
        cli = HTTPClient(f"http://127.0.0.1:{servers[0].port}")
        res = await cli.call(
            "abci_query_batch", data=",".join("0x" + k.hex() for k in keys),
            height=str(pin), prove=True)
        header = chain.block_store.load_block_meta(pin + 1).header
        cached = pin in servers[0].node.lightserve_cache.heights()
        before = tree.versions()
        ms = []
        for h in range(top + 1, new_top + 1):
            t = time.perf_counter()
            await chain.astep([_keyed_tx(seed, h, j)
                               for j in range(EXEC_TXS)])
            ms.append((time.perf_counter() - t) * 1e3)
        after = tree.versions()
        q = await chain.conns.query.query(abci.QueryRequest(
            path="/multistore", data=data, height=pin, prove=True))
        pinned = chain.app.version_pin()
        gone = [x for x in before if x < horizon and x not in pinned]
        g = await chain.conns.query.query(abci.QueryRequest(
            path="/multistore", data=data, height=gone[-1], prove=True)) \
            if gone else None
        return res, header, cached, before, after, q, gone, g, ms

    res, header, cached, before, after, q, gone, g, ms = \
        loop.run_until_complete(run())
    env = json.loads(q.value) if q.code == 0 else None
    if not cached or pin not in after or env is None or \
            any(env[k] != res["proof"][k] for k in
                ("root", "version", "keys", "values", "multiproof")):
        raise AssertionError(f"17c: version {pin} after the commits: "
                             f"cached {cached}, kept {pin in after}, query "
                             f"{q.code} {q.log!r}")
    present = [(k, chain.app.tree.get(k, pin)) for k in keys[:-1]]
    verify_state_proof(header, env, present=present, absent=keys[-1:])
    want = f"multistore: 'state tree has no version {gone[-1]}'" \
        if gone else None
    if not gone or any(x in after for x in gone) or g.code == 0 or \
            g.log != want:
        raise AssertionError(f"17c: unpinned versions {gone} below "
                             f"{horizon}: kept {sorted(set(gone) & set(after))}"
                             f", query {g and (g.code, g.log)!r}")
    _log(f"pins {LS_PIN_HEIGHTS} commits past the horizon ({top + 1}-"
         f"{new_top}, ms a height {_p50_p90(ms)}): the tree holds "
         f"{len(after)} versions, {horizon}-{new_top} and the pinned "
         f"{sorted(x for x in after if x < horizon)} below the horizon; "
         f"the {len(gone)} unpinned below it ({gone[0]}-{gone[-1]}) are "
         f"gone; version {pin}'s proof from the app equals the cached one "
         f"and verifies against header {pin + 1}'s app_hash; version "
         f"{gone[-1]} answers {g.log!r}; card: {card}")


def _ls_proxy(card, ek, device, loop, src, servers):
    """17d light-proxy: a LightProxy over the two lightserve servers; an
    HTTPClient to it asks commit and block at LS_PROXY_HEIGHTS and both
    pages of validators at LS_PROXY_HEIGHTS[1]; every answer equals the
    stores'; a primary that attaches a forged tx is refused.  Returns B1's
    launches."""
    from cometbft_tpu_torch.config import StateSyncConfig
    from cometbft_tpu_torch.light.proxy import LightProxy, LightProxyError
    from cometbft_tpu_torch.rpc import core as rpc_core
    from cometbft_tpu_torch.rpc.client import HTTPClient
    chain, n = src["chain"], EXEC_VALIDATORS
    hs, vh = LS_PROXY_HEIGHTS, LS_PROXY_HEIGHTS[1]
    _phase(f"17d light-proxy-{n}x{SS_HEIGHTS}: a LightProxy (trust root "
           f"{SS_TRUST}) over the two servers; commit and block at "
           f"{', '.join(map(str, hs))}, validators at {vh} in pages of 100; "
           f"a primary attaching a forged tx")
    trust = chain.block_store.load_block_meta(SS_TRUST).block_id.hash
    urls = [f"http://127.0.0.1:{s.port}" for s in servers]
    env = rpc_core.Environment(_StoreNode(chain))
    period = StateSyncConfig().trust_period_ns

    async def forged_server():
        from cometbft_tpu_torch.config import RPCConfig
        from cometbft_tpu_torch.rpc.server import RPCServer
        srv = RPCServer(_StoreNode(chain),
                        RPCConfig(laddr="tcp://127.0.0.1:0"))
        await srv.start()
        real = srv.routes["block"]

        async def block(height="0"):
            res = await real(height=height)
            res["block"]["data"]["txs"].append(
                base64.b64encode(b"forged=1").decode())
            return res
        srv.routes["block"] = block
        return srv

    async def run():
        _clear_memos()
        l0 = ek.launches
        proxy = LightProxy(chain.chain_id, urls[0], urls[1:], SS_TRUST,
                           trust, "tcp://127.0.0.1:0",
                           trust_period_ns=period, device=device)
        fsrv = await forged_server()
        forged = LightProxy(chain.chain_id, f"http://127.0.0.1:{fsrv.port}",
                            urls[1:], SS_TRUST, trust, "tcp://127.0.0.1:0",
                            trust_period_ns=period, device=device)
        calls, err = [], None
        try:
            await proxy.start()
            await forged.start()
            cli = HTTPClient(f"http://{proxy.rpc_listen_addr}", timeout=60.0)
            todo = [("commit", {"height": str(h)}) for h in hs] + \
                [("block", {"height": str(h)}) for h in hs] + \
                [("validators", {"height": str(vh), "page": str(p),
                                 "per_page": "100"})
                 for p in range(1, (n + 99) // 100 + 1)]
            for method, params in todo:
                t = time.perf_counter()
                res = await cli.call(method, **params)
                calls.append((method, params, res,
                              (time.perf_counter() - t) * 1e3))
            try:
                await forged.client.block(hs[1])
            except LightProxyError as e:
                err = str(e)
        finally:
            await proxy.stop()
            await forged.stop()
            await fsrv.stop()
        return calls, err, ek.launches - l0

    calls, err, launches = loop.run_until_complete(run())

    async def stores(method, params):
        h = int(params["height"])
        if method == "commit":
            return (await rpc_core._build_commit(env, h))["signed_header"]
        if method == "block":
            return await rpc_core._build_block(env, h)
        return await rpc_core._validators(env, h, params["page"], "100")
    for method, params, res, _ in calls:
        got = res["signed_header"] if method == "commit" else res
        want = json.loads(json.dumps(loop.run_until_complete(
            stores(method, params))))
        if got != want:
            raise AssertionError(f"17d: the proxy's {method} {params} != "
                                 f"the stores'")
    want_err = f"block {hs[1]} data does not hash to the verified data_hash"
    if err != want_err or not launches:
        raise AssertionError(f"17d: the forged primary gave {err!r} "
                             f"({launches} B1 launches)")
    _log(f"light_proxy_{n}x{SS_HEIGHTS} ms a call: " + ", ".join(
        f"{m} {p['height']}" + (f" p{p['page']}" if m == "validators"
                                else "") + f" {ms:.1f}"
        for m, p, _, ms in calls) + f"; every answer equals the stores' "
        f"(signed headers, blocks, validator pages with the stores' "
        f"priorities); B1 launches {launches}; the forged primary: "
        f"LightProxyError {err!r}; card: {card}")
    return launches


def _ls_repairs(seed, card, ek, device, loop, src):
    """17e repairs on the card: ROADMAP C.1's signed garbage proposal and
    C.2's mutated prevote into 12c's in-process net (config 1), C.3's
    three evidence inputs into an evidence reactor on its node 0 and the
    third through validate_block, C.4's zero limits.  The byzantine
    proposer's node is replaced by its messages: the three honest
    validators hold 30 of 40 power, so each commit needs all three, and
    none can be left without a block the others committed (the
    in-process net has no gossip to send it again).  Returns B1's
    launches."""
    from types import SimpleNamespace
    from cometbft_tpu_torch.config import RPCConfig, test_config
    from cometbft_tpu_torch.consensus.messages import (
        BlockPartMessage, ProposalMessage, VoteMessage, decode_p2p,
        encode_p2p)
    from cometbft_tpu_torch.evidence.reactor import (
        EVIDENCE_LIST_MSG, EvidenceReactor)
    from cometbft_tpu_torch.rpc.client import HTTPClient
    from cometbft_tpu_torch.rpc.server import RPCServer
    from cometbft_tpu_torch.state import make_genesis_state
    from cometbft_tpu_torch.state.validation import BlockValidationError
    from cometbft_tpu_torch.types.block import LightBlock, SignedHeader
    from cometbft_tpu_torch.types.block_id import BlockID
    from cometbft_tpu_torch.types.canonical import PREVOTE_TYPE
    from cometbft_tpu_torch.types.evidence import (
        LightClientAttackEvidence, evidence_from_proto_wrapped)
    from cometbft_tpu_torch.types.part_set import PartSet, PartSetHeader
    from cometbft_tpu_torch.types.proposal import Proposal
    from cometbft_tpu_torch.types.timestamp import Timestamp
    from cometbft_tpu_torch.types.vote import Vote
    from cometbft_tpu_torch.wire import encode
    n, heights = NET_VALIDATORS, REPAIR_HEIGHTS
    _phase(f"17e repairs: C.1's signed garbage proposal and C.2's mutated "
           f"prevote into config 1's in-process net ({n} validators, "
           f"{heights} heights); C.3's three evidence inputs into an "
           f"evidence reactor and validate_block; C.4's zero RPC limits")
    doc, pvs = _net_doc(seed + 170, n, "repair-chip")
    proposer = make_genesis_state(doc).validators.get_proposer()
    byz = next(i for i, pv in enumerate(pvs)
               if pv.get_pub_key().address() == proposer.address)
    parts = PartSet.from_data(b"\xff\xff\xff")
    prop = Proposal(height=1, round=0, pol_round=-1,
                    block_id=BlockID(hash=bytes(range(32)),
                                     part_set_header=parts.header()),
                    timestamp=Timestamp.now())
    pvs[byz].sign_proposal(doc.chain_id, prop)
    garbage = [encode_p2p(ProposalMessage(prop)),
               encode_p2p(BlockPartMessage(1, 0, parts.get_part(0)))]
    vals = make_genesis_state(doc).validators
    honest = next(i for i in range(n) if i != byz)
    idx, val = vals.get_by_address(pvs[honest].get_pub_key().address())
    vote = Vote(type=PREVOTE_TYPE, height=1, round=0,
                block_id=BlockID(hash=bytes(range(32)),
                                 part_set_header=PartSetHeader(
                                     total=1, hash=bytes(range(32, 64)))),
                timestamp=Timestamp.now(), validator_address=val.address,
                validator_index=idx)
    pvs[honest].sign_vote(doc.chain_id, vote, False)
    raw = encode_p2p(VoteMessage(vote))
    at = raw.index(b"\x22\x48\x0a\x20")
    mutated = raw[:at + 1] + b"\x22" + raw[at + 2:]
    out = {"refused": [], "decode_errors": 0}

    class _Errors:
        """The node's logger, counting the undecodable proposal blocks."""

        def __init__(self, real):
            self.real = real

        def __getattr__(self, name):
            return getattr(self.real, name)

        def error(self, msg, **kw):
            if msg == "failed to decode proposal block":
                out["decode_errors"] += 1
            self.real.error(msg, **kw)

    def deliver(node, raw_msg, peer):
        # the consensus reactor's receive: a message that does not decode
        # is dropped there (consensus/reactor.py)
        try:
            msg = decode_p2p(raw_msg)
        except ValueError as e:
            out["refused"].append(str(e))
            return
        node.cs.send_peer(msg, peer)

    async def run():
        nodes = [await _CsNode.make(doc, device, pv=pv,
                                    config=test_config().consensus,
                                    evidence=(i == honest))
                 for i, pv in enumerate(pvs) if i != byz]
        for i, node in enumerate(nodes):
            node.cs.logger = _Errors(node.cs.logger)

            def hook(msg, i=i):
                if isinstance(msg, (ProposalMessage, BlockPartMessage,
                                    VoteMessage)):
                    msg_raw = encode_p2p(msg)
                    for j, other in enumerate(nodes):
                        if j != i:
                            other.cs.send_peer(decode_p2p(msg_raw),
                                               f"node{i}")
            node.cs.broadcast_hooks.append(hook)
        for node in nodes:
            for m in garbage + [mutated]:
                deliver(node, m, "byzantine")
        t0 = time.perf_counter()
        for node in nodes:
            await node.cs.start()
        try:
            await _cs_until(nodes[0], lambda: all(
                x.block_store.height >= heights for x in nodes),
                f"every node at height {heights}")
            for node in nodes:
                node.cs.raise_if_failed()
        finally:
            for node in nodes:
                await node.cs.stop()
        out["net_s"] = time.perf_counter() - t0
        out["failures"] = [node.cs.failure for node in nodes]
        bs = nodes[0].block_store
        out["rounds"] = [(bs.load_block_commit(h) or
                          bs.load_seen_commit(h)).round
                         for h in range(1, heights + 1)]
        out["hashes"] = {h: {x.block_store.load_block(h).hash()
                             for x in nodes}
                         for h in range(1, heights + 1)}
        # C.3
        node = nodes[0]
        reactor = EvidenceReactor(node.evpool)
        meta = node.block_store.load_block_meta(2)
        attack = LightClientAttackEvidence(
            conflicting_block=LightBlock(
                signed_header=SignedHeader(
                    header=meta.header,
                    commit=node.block_store.load_block_commit(2)),
                validator_set=node.state_store.load_validators(2)),
            common_height=1, byzantine_validators=[],
            total_voting_power=10 * n, timestamp=meta.header.time)
        raw_attack = encode(EVIDENCE_LIST_MSG,
                            {"evidence": [attack.to_proto_wrapped()]})
        k = raw_attack.index(b"ed25519")
        flipped = raw_attack[:k + 3] + bytes([raw_attack[k + 3] ^ 1]) + \
            raw_attack[k + 4:]
        headless = {"light_client_attack_evidence": {"common_height": 2}}
        inputs = [bytes.fromhex("0a0612041a002a00"), flipped,
                  encode(EVIDENCE_LIST_MSG, {"evidence": [headless]})]
        peer = SimpleNamespace(id="ab" * 20)
        for m in inputs:
            await reactor.receive(0x38, peer, m)
        reactor.raise_if_failed()
        out["evidence"] = (reactor.failure, len(node.evpool.all_pending()))
        block = node.block_store.load_block(heights)
        block.evidence = [evidence_from_proto_wrapped(headless)]
        node.exec._last_validated_hash = block.hash()
        try:
            node.exec.validate_block(node.state_store.load(), block)
        except BlockValidationError as e:
            out["validate"] = str(e)
        # C.4
        srv = RPCServer(_StoreNode(src["chain"]), RPCConfig(
            laddr="tcp://127.0.0.1:0", max_open_connections=0,
            max_header_bytes=0))
        await srv.start()
        try:
            out["health"] = await HTTPClient(
                f"http://127.0.0.1:{srv.port}").health()
        finally:
            await srv.stop()

    _clear_memos()
    l0 = ek.launches
    loop.run_until_complete(run())
    launches = ek.launches - l0
    if any(out["failures"]) or \
            any(len(v) != 1 for v in out["hashes"].values()) or \
            out["decode_errors"] != n - 1 or \
            out["refused"] != ["cometbft.types.v2.Vote.height: bad wire "
                               "type 2"] * (n - 1):
        raise AssertionError(f"17e: failures {out['failures']}, decode "
                             f"errors {out['decode_errors']}, refused "
                             f"{out['refused']}")
    if out["evidence"] != (None, 0) or out.get("validate") != \
            "invalid evidence: conflicting block missing header" or \
            (out.get("health") or {}).get("status") != "ok":
        raise AssertionError(f"17e: evidence {out['evidence']}, "
                             f"validate_block {out.get('validate')!r}, "
                             f"health {out.get('health')!r}")
    _log(f"repairs net_{n}x{heights}: the {n - 1} honest validators (the "
         f"byzantine proposer's node replaced by its messages) dropped the "
         f"garbage proposal block with a log line each, {n - 1} mutated "
         f"prevotes "
         f"refused at decode ({out['refused'][0]!r}); the net committed "
         f"{heights} heights in {out['net_s']:.2f} s (commit rounds "
         f"{out['rounds']}), every node's failure None, {launches} B1 "
         f"launches; C.3's three inputs dropped by the evidence reactor "
         f"(failure None, nothing pending), the headless attack in a block: "
         f"BlockValidationError {out['validate']!r}; an RPCServer with "
         f"max_open_connections=0 and max_header_bytes=0 answers /health "
         f"(status {out['health']['status']!r}); card: {card}")
    return launches


def _lightserve_phases(seed, card, keep, device=None):
    """Phases 17a-17e: the proof-serving light path (lightserve/, the
    state tree's prove and pins, light/state_proof.py, light/proxy.py,
    the lightserve routes) over 15a's source, and the repairs of ROADMAP
    C.1-C.4.  Returns B1's launches by part and B2's."""
    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    t_phase = time.perf_counter()
    src, n, top = keep["ss_src"], EXEC_VALIDATORS, SS_HEIGHTS
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    servers, fallback = [], []
    try:
        servers = _ls_servers(loop, src["chain"])
        fallback = _ls_servers(loop, src["chain"], lightserve=False)
        light = _ls_light(card, ek, tracing, device, loop, src, servers,
                          fallback)
        for srv in fallback:
            loop.run_until_complete(srv.stop())
        fallback = []
        with _RpcCount(servers) as count:
            proofs, proofs8 = _ls_proofs(seed, card, ek, ek8, oe, device,
                                         loop, src, servers, count)
        _ls_pins(seed, card, loop, src, servers)
        proxy = _ls_proxy(card, ek, device, loop, src, servers)
        repairs = _ls_repairs(seed, card, ek, device, loop, src)
    finally:
        for srv in servers + fallback:
            loop.run_until_complete(srv.stop())
        src["chain"].app.version_pin = None
        logging.disable(logging.NOTSET)
        loop.close()
    _log(f"phase 17 took {time.perf_counter() - t_phase:.1f} s")
    return ({f"rpc_lightserve_{n}x{top}": light,
             f"state_proofs_{n}x{top}": proofs,
             f"light_proxy_{n}x{top}": proxy,
             f"repairs_{NET_VALIDATORS}x{REPAIR_HEIGHTS}": repairs},
            {f"state_proofs_{n}_cuda8": proofs8})


# -- phase 18: the rest of ABCI and the gRPC surface --------------------------

# an app process with a fault (18d): python -c _FAULTY_APP ADDRESS MODE ARG;
# MODE "raise" raises in FinalizeBlock from height ARG on, "sleep" sleeps
# ARG s in FinalizeBlock and Query
_FAULTY_APP = """
import asyncio, sys
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.abci.server import SocketServer
address, mode, arg = sys.argv[1], sys.argv[2], float(sys.argv[3])


class App(KVStoreApplication):
    async def finalize_block(self, req):
        if mode == "raise" and req.height >= arg:
            raise RuntimeError(f"app fault at height {req.height}")
        if mode == "sleep":
            await asyncio.sleep(arg)
        return await super().finalize_block(req)

    async def query(self, req):
        if mode == "sleep":
            await asyncio.sleep(arg)
        return await super().query(req)


async def main():
    srv = SocketServer(address, App())
    await srv.start()
    print(f"abci-server listening {address}", flush=True)
    await srv.serve_forever()

asyncio.run(main())
"""


class _AppProc:
    """An ABCI app in a process of its own, on a unix socket in
    ``sock_dir``: ``python -m cometbft_tpu_torch.abci.server --address
    unix://... --app kvstore``, or ``_FAULTY_APP`` with ``fault=(mode,
    arg)``.  Its environment hides every CUDA device (the app runs the
    kvstore only); ``start`` returns once the server printed its ready
    line (``spawn`` then ``wait_ready`` starts several side by side), its
    stderr goes to ``<name>.log`` beside the socket."""

    def __init__(self, sock_dir, name, fault=None):
        self.address = f"unix://{os.path.join(sock_dir, name + '.sock')}"
        self.log_path = os.path.join(sock_dir, name + ".log")
        if fault is None:
            self.argv = [sys.executable, "-m", "cometbft_tpu_torch.abci.server",
                         "--address", self.address, "--app", "kvstore"]
        else:
            self.argv = [sys.executable, "-c", _FAULTY_APP, self.address,
                         fault[0], str(fault[1])]
        self.proc = None
        self.ready_s = None

    def start(self, timeout_s=60.0):
        return self.spawn().wait_ready(timeout_s)

    def spawn(self):
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "CUDA_VISIBLE_DEVICES": "",
               "PYTHONPATH": root + os.pathsep +
               os.environ.get("PYTHONPATH", "")}
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(self.argv, stdout=subprocess.PIPE,
                                         stderr=log, cwd=root, env=env,
                                         text=True)
        return self

    def wait_ready(self, timeout_s=60.0):
        import select
        want = f"abci-server listening {self.address}"
        while True:
            left = self.t0 + timeout_s - time.perf_counter()
            ready, _, _ = select.select([self.proc.stdout], [], [],
                                        max(left, 0.0))
            if not ready:
                self.stop()
                raise AssertionError(f"app process {self.address}: no ready "
                                     f"line in {timeout_s} s")
            line = self.proc.stdout.readline()
            if not line:
                raise AssertionError(
                    f"app process {self.address} exited with "
                    f"{self.proc.wait()} before its ready line: "
                    f"{self.log_tail()}")
            if line.strip() == want:
                self.ready_s = time.perf_counter() - self.t0
                return self

    def log_tail(self, n=600) -> str:
        with open(self.log_path) as f:
            return f.read()[-n:]

    def stop(self):
        if self.proc is not None and self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(5)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
        if self.proc is not None:
            self.proc.stdout.close()


async def _socket_conns(address, registry, calls):
    """SocketAppConns to an app process, wrapped as the JAX node wraps
    them (cometbft_tpu/node/node.py:255-289): apply_deadlines with the
    node's default (20 s, 2 retries), apply_tracing, instrument_app_conns
    on ``registry``'s proxy metrics, then a RecordingClient per
    connection writing one call trace into ``calls``."""
    from cometbft_tpu_torch.abci.client import (
        SocketAppConns, apply_deadlines, apply_tracing)
    from cometbft_tpu_torch.abci.grammar import RecordingClient
    from cometbft_tpu_torch.abci.metrics import Metrics, instrument_app_conns
    conns = SocketAppConns(address)
    await conns.start()
    # the four SocketClients, under the wrappers
    conns.clients = {name: getattr(conns, name) for name in (
        "consensus", "mempool", "query", "snapshot")}
    apply_deadlines(conns, ABCI_TIMEOUT_S, retries=ABCI_RETRIES)
    apply_tracing(conns)
    conns.metrics = Metrics(registry)
    instrument_app_conns(conns, conns.metrics)
    for name in ("consensus", "mempool", "query", "snapshot"):
        setattr(conns, name, RecordingClient(getattr(conns, name), calls))
    return conns


def _abci_ms(hists) -> dict:
    """{(method, conn): (calls, mean ms, p50 ms, p90 ms, calls over the
    0.65 s bucket)} over proxy method-timing histograms, their buckets
    summed; p50 and p90 are the buckets' estimates."""
    from cometbft_tpu_torch.libs.metrics import Histogram
    acc = {}
    for hist in hists:
        for key, child in hist._children.items():
            m = acc.setdefault(key, Histogram("merged", "",
                                              buckets=child.buckets))
            m._counts = [a + b for a, b in zip(m._counts, child._counts)]
            m._count += child.count
            m._sum += child.sum
    out = {}
    for key, m in sorted(acc.items()):
        slow = m.count - m._counts[m.buckets.index(0.65)]
        out[key] = (m.count, m.sum * 1e3 / max(m.count, 1),
                    m.quantile(0.5) * 1e3, m.quantile(0.9) * 1e3, slow)
    return out


def _abci_ms_line(table, keys=None) -> str:
    return "; ".join(f"{conn}/{method} {n} calls mean {mean:.3f} p50 "
                     f"{p50:.3f} p90 {p90:.3f} over 0.65 s {slow}"
                     for (method, conn), (n, mean, p50, p90, slow)
                     in table.items()
                     if keys is None or (method, conn) in keys)


async def _http_get(port, path, close=False) -> bytes:
    """One GET; ``close`` asks a keep-alive server to end the connection
    after its answer."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    extra = "Connection: close\r\n" if close else ""
    writer.write(f"GET {path} HTTP/1.1\r\nHost: x\r\n{extra}\r\n".encode())
    await writer.drain()
    raw = await reader.read()
    writer.close()
    return raw


def _sockapp_net(seed, card, ek, tracing, device, loop, sock_dir, sock):
    """18a: 13a's four validators with each app in a process of its own
    behind SocketAppConns (deadlines, tracing, proxy metrics and a call
    trace), a CListMempool and a MempoolReactor on each node, keyed txs
    sent through each node's mempool connection, an SQL event sink on
    :memory: and a loop-lag sampler per node, and a pprof listener.
    ``sock`` is what 13a recorded in this call.  Returns B1 launches."""
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.abci.grammar import GrammarChecker
    from cometbft_tpu_torch.config import Config, test_config
    from cometbft_tpu_torch.indexer.service import IndexerService
    from cometbft_tpu_torch.indexer.sink_sql import SQLEventSink
    from cometbft_tpu_torch.libs import health
    from cometbft_tpu_torch.libs.metrics import Registry
    from cometbft_tpu_torch.libs.pprof import PprofServer
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.wire import encode, pb
    n, top = SOCK_VALIDATORS, SOCKAPP_HEIGHTS
    _phase(f"18a sockapp-{n}x{top}: 13a's {n} validators, each app a kvstore "
           f"process behind SocketAppConns (deadlines {ABCI_TIMEOUT_S:.0f} s, "
           f"{ABCI_RETRIES} retries, tracing, proxy metrics), a CListMempool, "
           f"an SQL sink and a loop-lag sampler per node, {top} heights of "
           f"keyed txs through each node's mempool connection")
    doc, pvs = _net_doc(seed + 130, n, "sockapp-chip")
    apps = [_AppProc(sock_dir, f"net{i}") for i in range(n)]
    t0 = time.perf_counter()
    for app in apps:
        app.spawn()
    for app in apps:
        app.wait_ready()
    spawn_s = time.perf_counter() - t0
    _clear_memos()
    ek.launches = 0
    tracing.clear()
    traces = [[] for _ in range(n)]
    registries = [Registry() for _ in range(n)]
    lags = [health.Metrics(r) for r in registries]
    sent = []

    async def run():
        nodes, sinks, services, samplers = [], [], [], []
        pprof, tasks_bytes, stopped = PprofServer("127.0.0.1:0"), 0, False
        await pprof.start()
        try:
            for i, pv in enumerate(pvs):
                conns = await _socket_conns(apps[i].address, registries[i],
                                            traces[i])
                node = await _sock_node(doc, device, _seed(seed + 131, i),
                                        pv=pv, config=test_config().consensus,
                                        mempool_config=Config().mempool,
                                        conns=conns)
                sink = SQLEventSink(":memory:", doc.chain_id)
                svc = IndexerService(sink.tx_indexer, sink.block_indexer,
                                     node.bus)
                await svc.start()
                sampler = health.LoopLagSampler(lags[i], LAG_INTERVAL_S)
                samplers.append(asyncio.ensure_future(sampler.run()))
                nodes.append(node)
                sinks.append(sink)
                services.append(svc)
            await _sock_mesh(nodes)
            sub = nodes[0].bus.subscribe("chip-smoke-sockapp",
                                         EVENT_QUERY_NEW_BLOCK,
                                         out_capacity=1000)
            stamps = [time.perf_counter()]
            for node in nodes:
                await node.cs.start()
            for h in range(1, top + 1):
                for j, node in enumerate(nodes):
                    node.cs.raise_if_failed()
                    tx = _keyed_tx(seed + 180, h, j)
                    await node.mempool.check_tx(tx)
                    sent.append(tx)
                await _cs_new_block(nodes[0], sub, h)
                stamps.append(time.perf_counter())
                if h == top // 2:
                    raw = await _http_get(
                        int(pprof.listen_addr.rsplit(":", 1)[1]),
                        "/debug/pprof/tasks")
                    tasks_bytes = len(raw)
            await _cs_until(nodes[0], lambda: all(
                nd.mempool.size() == 0 and nd.block_store.height >= top
                for nd in nodes), "every node at the last height, every "
                "mempool drained")
            stamps.append(time.perf_counter())
            tip = min(nd.block_store.height for nd in nodes)
            await _cs_until(nodes[0], lambda: all(
                sink._conn.execute("SELECT count(*) FROM blocks WHERE "
                                   "height <= ?", (tip,)).fetchone()[0]
                >= tip for sink in sinks), "every sink at the tip")
            stopped = True
            await _sock_stop(nodes)
            stamps.append(time.perf_counter())
            # each app process against its node's stores, both at rest
            infos = [(await nd.conns.query.info(abci.InfoRequest()),
                      nd.state_store.load()) for nd in nodes]
        finally:
            for t in samplers:
                t.cancel()
            for svc in services:
                await svc.stop()
            await pprof.stop()
            try:
                if not stopped:
                    await _sock_stop(nodes)
            finally:
                for node in nodes:
                    await node.conns.stop()
        return nodes, sinks, stamps, infos, tasks_bytes, tip

    try:
        with _commit_checks(ek) as checks:
            nodes, sinks, stamps, infos, tasks_bytes, tip = \
                loop.run_until_complete(run())
    finally:
        for app in apps:
            app.stop()
    launches = ek.launches
    lanes = _batch_lanes(tracing)
    drain_s, stop_s = stamps[-2] - stamps[-3], stamps[-1] - stamps[-2]
    stamps = stamps[:-2]
    ms = [(b - a) * 1e3 for a, b in zip(stamps[1:], stamps[2:])]
    # the gates: the four stores and app hashes agree at every height,
    # every sent tx is committed once and has one row in every sink, each
    # LastCommit check launched B1 as 13a's did, the traces are grammatical
    for h in range(1, tip + 1):
        blocks = {encode(pb.BLOCK, node.block_store.load_block(h).to_proto())
                  for node in nodes}
        hashes = {node.state_store.load_finalize_block_response(h).app_hash
                  for node in nodes}
        if len(blocks) != 1 or len(hashes) != 1:
            raise AssertionError(f"18a: the nodes' blocks or app hashes at "
                                 f"{h} differ")
    for i, (info, state) in enumerate(infos):
        if (info.last_block_height, info.last_block_app_hash) != \
                (state.last_block_height, state.app_hash):
            raise AssertionError(
                f"18a: app process {i}'s Info ({info.last_block_height}, "
                f"{info.last_block_app_hash.hex()}) != its node's state "
                f"({state.last_block_height}, {state.app_hash.hex()})")
    want = collections.Counter(sent)
    for i, node in enumerate(nodes):
        got = collections.Counter()
        for h in range(1, node.block_store.height + 1):
            got.update(node.block_store.load_block(h).data.txs)
        rows = sinks[i]._conn.execute(
            "SELECT count(*) FROM tx_results").fetchone()[0]
        if got != want or rows != len(sent):
            raise AssertionError(f"18a: node {i} committed "
                                 f"{sum(got.values())} of {len(sent)} sent "
                                 f"txs, its sink holds {rows} rows")
    mine = _node_checks(checks, [nd.exec for nd in nodes],
                        range(1, top + 1))
    theirs = sock["checks"]
    for i, (counts, ref) in enumerate(zip(mine, theirs)):
        for h, (got, want) in enumerate(zip(counts, ref), 1):
            if got != want or (h > 1 and got != 1):
                raise AssertionError(
                    f"18a: node {i}'s LastCommit check at {h} launched B1 "
                    f"{got} times, 13a's node {i} {want}")
    if len(mine) != n or any(len(r) < top for r in theirs):
        raise AssertionError(f"18a: LastCommit checks for {len(mine)} nodes "
                             f"against 13a's {[len(r) for r in theirs]} "
                             f"heights")
    checker = GrammarChecker()
    for i, calls in enumerate(traces):
        checker.verify(calls)
    lag = [m.event_loop_lag_seconds for m in lags]
    abci_ms = _abci_ms([c.conns.metrics.method_timing_seconds
                        for c in nodes])
    _log(f"sockapp_{n}x{top} ms a height (NewBlock to NewBlock on node 0, "
         f"heights 2-{top}) {_p50_p90(ms)} against 13a's sock_{n}x"
         f"{SOCK_HEIGHTS} {_p50_p90(sock['ms'])} in this call; B1 launches "
         f"{launches} ({launches / top:.2f} a height) against 13a's "
         f"{sock['launches']} ({sock['launches'] / SOCK_HEIGHTS:.2f}); "
         f"LastCommit check launches a height by node, heights 1-{top} "
         f"{[_tally(c) for c in mine]}, 13a's "
         f"{[_tally(c[:top]) for c in theirs]}; lanes a "
         f"launch {sorted(collections.Counter(lanes).items())}; "
         f"{len(sent)} keyed txs committed once on every node, one row "
         f"each in every sink; the four app hashes agree at every height; "
         f"{n} app processes ready in {spawn_s:.2f} s; heights 1-{top} "
         f"{stamps[-1] - stamps[0]:.2f} s, then the drain {drain_s:.2f} s and "
         f"the stop {stop_s:.2f} s; card: {card}")
    sock["sockapp_ms"] = ms
    _log(f"sockapp_{n}x{top} ABCI ms by connection/method (proxy histogram "
         f"over the four nodes): {_abci_ms_line(abci_ms)}")
    _log(f"sockapp_{n}x{top} loop lag p95 by node (ms, histogram estimate) "
         f"{[round(h.quantile(0.95) * 1e3, 3) for h in lag]} over "
         f"{sum(h.count for h in lag)} samples; /debug/pprof/tasks "
         f"{tasks_bytes} bytes; GrammarChecker accepted the {n} call traces "
         f"({[len(t) for t in traces]} calls)")
    return launches


def _sockapp_cs(seed, card, ek, ek8, oe, tracing, device, loop, sock_dir,
                chain):
    """18b: 12a's full node fed the twin's 150-validator chain as wire
    bytes again, its app a kvstore process behind SocketAppConns, for
    SOCKAPP_CS_HEIGHTS heights, then one more under cuda8; kv indexers
    and a companion-enabled Pruner on its stores for 18c.  Returns (node,
    B1 launches, B2 launches)."""
    import tempfile

    from cometbft_tpu_torch.abci.pb import fbr_to_proto
    from cometbft_tpu_torch.consensus.messages import decode_p2p
    from cometbft_tpu_torch.db import MemDB
    from cometbft_tpu_torch.indexer import BlockIndexer, TxIndexer
    from cometbft_tpu_torch.indexer.service import IndexerService
    from cometbft_tpu_torch.libs.metrics import Registry
    from cometbft_tpu_torch.libs.pubsub import Query
    from cometbft_tpu_torch.state.pruner import Pruner
    from cometbft_tpu_torch.types.events import EVENT_QUERY_NEW_BLOCK
    from cometbft_tpu_torch.wire import abci_pb, encode, pb
    n, top, live = EXEC_VALIDATORS, SOCKAPP_CS_HEIGHTS, chain.live
    _phase(f"18b sockapp-cs-{n}x{top}: 12a's full node fed the twin's chain "
           f"as wire bytes, its app a kvstore process behind SocketAppConns, "
           f"{top} heights, then height {top + 1} under "
           f"{oe.KERNEL_ENV}=cuda8")
    app = _AppProc(sock_dir, "cs").start()
    wal_dir = tempfile.mkdtemp(prefix="chip-smoke-sockapp-wal-",
                               dir=sock_dir)
    registry, calls = Registry(), []
    _clear_memos()
    tracing.clear()
    rows = {}

    # the loop runs as in 12a: the start, each height and the stop in a
    # run_until_complete of their own, a 1 ms ticker beside them, so the
    # receive routine takes each height's messages in 12a's bursts
    async def start():
        conns = await _socket_conns(app.address, registry, calls)
        node = await _CsNode.make(chain.doc, device,
                                  wal_path=os.path.join(wal_dir, "wal"),
                                  conns=conns)
        node.tx_indexer, node.block_indexer = TxIndexer(MemDB()), \
            BlockIndexer(MemDB())
        node.indexer = IndexerService(node.tx_indexer, node.block_indexer,
                                      node.bus)
        await node.indexer.start()
        node.sub = node.bus.subscribe("chip-smoke-sockapp-cs",
                                      EVENT_QUERY_NEW_BLOCK,
                                      out_capacity=1000)
        await node.cs.start()
        node.gap = _LoopGap()
        node.gap.task = asyncio.ensure_future(node.gap.run())
        return node

    async def drive(node, h):
        node.gap.take()
        t0 = time.perf_counter()
        for msg_raw in live["raw"][h]:
            node.cs.send_peer(decode_p2p(msg_raw), CS_PEER)
        await _cs_new_block(node, node.sub, h)
        return (time.perf_counter() - t0) * 1e3, node.gap.take() * 1e3

    async def stop(node):
        node.gap.stop = True
        try:
            await node.cs.stop()
        finally:
            await node.indexer.stop()
            await node.conns.stop()

    node = None
    try:
        node = loop.run_until_complete(start())
        for h in range(1, top + 2):
            if h == top + 1:
                os.environ[oe.KERNEL_ENV] = "cuda8"
            try:
                l0, l80 = ek.launches, ek8.launches
                b0 = len(_batch_lanes(tracing))
                ms_h, gap_ms = loop.run_until_complete(drive(node, h))
                rows[h] = (ms_h, ek.launches - l0, ek8.launches - l80,
                           _batch_lanes(tracing)[b0:], gap_ms)
            finally:
                os.environ.pop(oe.KERNEL_ENV, None)
        loop.run_until_complete(_cs_until(
            node, lambda: node.block_indexer.search(
                Query(f"block.height = {top + 1}")) == [top + 1],
            "the indexers at the last height"))
    finally:
        try:
            if node is not None:
                loop.run_until_complete(stop(node))
        finally:
            app.stop()
    # the gates: the node's blocks, FinalizeBlock responses (app hashes)
    # and state equal the in-process twin's at every height; B1's launches
    # and lanes a height equal 12a's; the cuda8 height launches B2 only
    for h in range(1, top + 2):
        mine, twin = node.block_store.load_block(h), \
            chain.block_store.load_block(h)
        fb_mine = node.state_store.load_finalize_block_response(h)
        fb_twin = chain.state_store.load_finalize_block_response(h)
        if encode(pb.BLOCK, mine.to_proto()) != \
                encode(pb.BLOCK, twin.to_proto()) or \
                node.block_store.load_block_meta(h).block_id != \
                chain.block_store.load_block_meta(h).block_id or \
                fb_mine.app_hash != fb_twin.app_hash or \
                encode(abci_pb.FINALIZE_BLOCK_RESPONSE,
                       fbr_to_proto(fb_mine)) != \
                encode(abci_pb.FINALIZE_BLOCK_RESPONSE, fbr_to_proto(fb_twin)):
            raise AssertionError(f"18b: the node's block or FinalizeBlock "
                                 f"response at {h} != the twin's")
        ms_h, b1, b2, lanes_h, _ = rows[h]
        want_b1 = live["launches"][h] if h <= top else 0
        want_b2 = live["launches"][h] if h > top else 0
        if (b1, b2) != (want_b1, want_b2) or \
                (h <= top and lanes_h != live["lanes"][h]):
            raise AssertionError(f"18b: height {h} launched B1 {b1} / B2 "
                                 f"{b2} times with lanes {lanes_h}, 12a "
                                 f"{live['launches'][h]} with lanes "
                                 f"{live['lanes'][h]}")
    if node.state_store.load().bytes() != chain.states[top + 1]:
        raise AssertionError("18b: the node's state != the twin's")
    from cometbft_tpu_torch.abci.grammar import GrammarChecker
    GrammarChecker().verify(calls)
    node.pruner = Pruner(node.state_store, node.block_store, MemDB(),
                         companion_enabled=True, tx_indexer=node.tx_indexer,
                         block_indexer=node.block_indexer)
    b1 = sum(rows[h][1] for h in range(1, top + 1))
    b2 = rows[top + 1][2]
    hs = range(2, top + 1)
    abci_ms = _abci_ms([node.conns.metrics.method_timing_seconds])
    _log(f"sockapp_cs_{n}x{top} ms a height (first message to NewBlock, "
         f"heights 2-{top}) {_p50_p90([rows[h][0] for h in hs])} against "
         f"12a's {_p50_p90([live['ms'][h] for h in hs])} over the same "
         f"heights in this call; B1 launches {b1} "
         f"({_p50_p90([rows[h][1] for h in hs])} a height), launches and "
         f"lanes a height equal to 12a's at every height; lanes a launch "
         f"{sorted(collections.Counter(x for h in rows for x in rows[h][3]).items())}; "
         f"loop's longest stall a height ms "
         f"{_p50_p90([rows[h][4] for h in hs])}; "
         f"height {top + 1} under cuda8: B2 {b2}, B1 "
         f"{rows[top + 1][1]}; blocks, FinalizeBlock responses and state "
         f"equal the in-process twin's at every height; app ready in "
         f"{app.ready_s:.2f} s; card: {card}")
    _log(f"sockapp_cs_{n}x{top} ABCI ms over the socket: "
         f"{_abci_ms_line(abci_ms, {('finalize_block', 'consensus'), ('commit', 'consensus')})}"
         f"; every call: {_abci_ms_line(abci_ms)}")
    return node, b1, b2


def _companion(card, loop, node, twin):
    """18c: the data-companion services on 18b's stores, through their
    servicer classes in process: version, block by height, block results;
    then the pruning service's four retain heights, the app's, and one
    pruner pass, with the rows left held to what the heights imply."""
    from cometbft_tpu_torch import version as ver
    from cometbft_tpu_torch.libs.pubsub import Query
    from cometbft_tpu_torch.rpc.grpc.services import (
        BlockResultsServicer, BlockServicer, PruningServicer, ServiceError,
        VersionServicer)
    top, r = node.block_store.height, COMPANION_RETAIN
    _phase(f"18c companion services on 18b's stores ({top} heights): "
           f"version, block, block results, pruning to retain heights "
           f"{r}")
    blocks = BlockServicer(node.block_store, node.bus)
    results = BlockResultsServicer(node.block_store, node.state_store)
    pruning = PruningServicer(node.pruner)
    out, t0 = {}, time.perf_counter()

    async def refused(coro, code, text):
        try:
            await coro
        except ServiceError as e:
            if (e.code, e.message) != (code, text):
                raise AssertionError(f"18c: refused with {e.code} "
                                     f"{e.message!r}, want {code} {text!r}")
            return
        raise AssertionError(f"18c: not refused, want {code} {text!r}")

    async def run():
        out["version"] = await VersionServicer().get_version({})
        latest = await blocks.get_by_height({})
        mid = await blocks.get_by_height({"height": top // 2})
        res = await results.get_block_results({"height": r["results"]})
        if out["version"] != {"node": ver.CMT_SEM_VER,
                              "abci": ver.ABCI_SEM_VER,
                              "p2p": ver.P2P_PROTOCOL,
                              "block": ver.BLOCK_PROTOCOL} or \
                latest["block"]["header"]["height"] != top or \
                mid["block_id"] != node.block_store.load_block_meta(
                    top // 2).block_id.to_proto() or \
                len(res["tx_results"]) != len(
                    twin.block_store.load_block(r["results"]).data.txs) or \
                res["app_hash"] != node.state_store.\
                load_finalize_block_response(r["results"]).app_hash:
            raise AssertionError("18c: the version, block or block results "
                                 "answer is not the stores'")
        await pruning.set_block_retain_height({"height": r["block"]})
        await pruning.set_block_results_retain_height(
            {"height": r["results"]})
        await pruning.set_tx_indexer_retain_height(
            {"height": r["tx_indexer"]})
        await pruning.set_block_indexer_retain_height(
            {"height": r["block_indexer"]})
        node.pruner.set_application_retain_height(r["app"])
        out["retain"] = (await pruning.get_block_retain_height({}),
                         await pruning.get_block_results_retain_height({}),
                         await pruning.get_tx_indexer_retain_height({}),
                         await pruning.get_block_indexer_retain_height({}))
        t = time.perf_counter()
        out["pass"] = node.pruner.prune_once()
        out["pass_ms"] = (time.perf_counter() - t) * 1e3
        base = node.block_store.base
        await refused(blocks.get_by_height({"height": base - 1}),
                      "NOT_FOUND", f"height {base - 1} not in store "
                      f"[{base},{top}]")
        await refused(results.get_block_results({"height": 2}),
                      "NOT_FOUND", "no results for height 2")
        await refused(pruning.set_tx_indexer_retain_height(
            {"height": r["tx_indexer"] - 1}), "INVALID_ARGUMENT",
            "retain height cannot move backwards")
        await refused(pruning.set_block_retain_height({"height": top + 1}),
                      "INVALID_ARGUMENT", "retain height beyond store height")

    loop.run_until_complete(run())
    # the rows the retain heights imply: blocks from min(app, block), ABCI
    # results from the results height, each index from its own
    base = min(r["app"], r["block"])
    fbr = [h for h in range(1, top + 1)
           if node.state_store.load_finalize_block_response(h) is not None]
    tx_heights = sorted(node.tx_indexer.get(t).height
                        for t in node.tx_indexer.search(
                            Query("tx.height > 0"), limit=None))
    want_tx = sorted(h for h in range(r["tx_indexer"], top + 1)
                     for _ in twin.block_store.load_block(h).data.txs)
    blk_heights = node.block_indexer.search(Query("block.height > 0"),
                                            limit=None)
    if out["pass"] != (base - 1, base) or node.block_store.base != base or \
            node.block_store.load_block(base - 1) is not None or \
            fbr != list(range(max(r["results"], base), top + 1)) or \
            tx_heights != want_tx or \
            blk_heights != list(range(r["block_indexer"], top + 1)):
        raise AssertionError(f"18c: pass {out['pass']}, base "
                             f"{node.block_store.base}, results kept from "
                             f"{fbr[:1]}, tx index {len(tx_heights)} rows "
                             f"(want {len(want_tx)}), block index from "
                             f"{blk_heights[:1]}")
    _log(f"companion: version {out['version']}; block, block results as "
         f"the stores; pruning retain heights {out['retain']}; one pass "
         f"{out['pass_ms']:.1f} ms pruned {out['pass'][0]} blocks to base "
         f"{base}, ABCI results kept {fbr[0]}-{top}, tx index {len(want_tx)} "
         f"rows of heights {r['tx_indexer']}-{top}, block index heights "
         f"{r['block_indexer']}-{top}; below the base, pruned results, a "
         f"backwards and a too-high retain height refused with the JAX "
         f"texts; {(time.perf_counter() - t0) * 1e3:.1f} ms; card: {card}")


def _sockapp_reject(seed, card, ek, device, loop, sock_dir):
    """18d: the rejects, each surfacing its error with nothing restarted:
    an app raising in FinalizeBlock (ExceptionResponse), an app sleeping
    past a deadline, an app killed between two heights, a frame over
    MAX_MSG_SIZE either way.  Returns B1 launches."""
    from cometbft_tpu_torch.abci import pb as abci_pb
    from cometbft_tpu_torch.abci import types as abci
    from cometbft_tpu_torch.abci.client import (
        ABCIClientError, ABCITimeoutError, DeadlineClient, SocketClient,
        _RETRIABLE_METHODS)
    from cometbft_tpu_torch.abci.server import ABCIServerError
    from cometbft_tpu_torch.config import test_config
    from cometbft_tpu_torch.libs.metrics import Registry
    from cometbft_tpu_torch.wire.proto import encode_uvarint
    _phase("18d rejects: an app raising in FinalizeBlock, an app past a "
           f"{REJECT_DEADLINE_S} s deadline, an app killed between heights, "
           f"frames over MAX_MSG_SIZE")
    _clear_memos()
    ek.launches = 0
    out = {}

    async def node_until_failure(address):
        conns = await _socket_conns(address, Registry(), [])
        node = await _CsNode.make(doc, device, pv=pvs[0],
                                  config=test_config().consensus,
                                  conns=conns)
        await node.cs.start()
        try:
            deadline = time.perf_counter() + 30.0
            while node.cs.failure is None:
                if time.perf_counter() > deadline:
                    raise AssertionError("18d: consensus did not stop")
                await asyncio.sleep(0.01)
            height = (node.block_store.height,
                      node.state_store.load().last_block_height)
            await asyncio.sleep(0.5)
            try:
                node.cs.raise_if_failed()
            except Exception as e:  # noqa: BLE001 — the error checked below
                err = e
            else:
                raise AssertionError("18d: raise_if_failed did not raise")
            if (node.block_store.height,
                    node.state_store.load().last_block_height) != height:
                raise AssertionError("18d: consensus went on after the "
                                     "failure")
            try:
                await node.conns.consensus.echo("after")
                after = None
            except ABCIClientError as e:
                after = str(e)
            return err, height, after
        finally:
            try:
                await node.cs.stop()
            except Exception:  # noqa: BLE001 — the failure, seen above
                pass
            await conns.stop()

    doc, pvs = _net_doc(seed + 185, 1, "sockapp-reject")
    raising = _AppProc(sock_dir, "raising",
                       ("raise", REJECT_FAULT_HEIGHT)).start()
    try:
        err, height, after = loop.run_until_complete(
            node_until_failure(raising.address))
    finally:
        raising.stop()
    text = f"app exception: app fault at height {REJECT_FAULT_HEIGHT}"
    # the block of the fault's height is stored, its execution is not
    if type(err) is not ABCIClientError or str(err) != text or \
            height != (REJECT_FAULT_HEIGHT, REJECT_FAULT_HEIGHT - 1) or \
            after != f"ABCI client dead: {text}":
        raise AssertionError(f"18d(i): {type(err).__name__} {err!r} at "
                             f"height {height}, then {after!r}")
    out["raise"] = (str(err), height)

    sleeping = _AppProc(sock_dir, "sleeping",
                        ("sleep", 2 * REJECT_DEADLINE_S)).start()

    class Flaky:
        """A transport whose first ``fail`` calls of each method raise
        ConnectionResetError, then pass to ``inner``; counts attempts."""

        def __init__(self, inner, fail):
            self.inner, self.fail = inner, fail
            self.attempts = collections.Counter()

        def __getattr__(self, name):
            real = getattr(self.inner, name)

            async def call(*a, **kw):
                self.attempts[name] += 1
                if self.attempts[name] <= self.fail:
                    raise ConnectionResetError("transport reset")
                return await real(*a, **kw)
            return call

    async def deadlines():
        cli = SocketClient(sleeping.address)
        await cli.connect()
        try:
            got = {}
            for method, req in (("query", abci.QueryRequest(path="/store")),
                                ("finalize_block",
                                 abci.FinalizeBlockRequest(height=1))):
                flaky = Flaky(cli, 0)
                dc = DeadlineClient(flaky, default_timeout_s=REJECT_DEADLINE_S,
                                    slow_timeout_s=REJECT_DEADLINE_S,
                                    retries=ABCI_RETRIES)
                try:
                    await getattr(dc, method)(req)
                    raise AssertionError(f"18d(ii): {method} answered")
                except ABCITimeoutError as e:
                    got[method] = (str(e), flaky.attempts[method])
                # transient transport errors: retried for a read-only
                # method only
                flaky = Flaky(cli, ABCI_RETRIES + 1)
                dc = DeadlineClient(flaky, default_timeout_s=REJECT_DEADLINE_S,
                                    slow_timeout_s=REJECT_DEADLINE_S,
                                    retries=ABCI_RETRIES,
                                    retry_backoff_s=0.01)
                try:
                    await getattr(dc, method)(req)
                    raise AssertionError(f"18d(ii): {method} answered")
                except ConnectionResetError:
                    got[method + "_reset"] = flaky.attempts[method]
            return got
        finally:
            await cli.close()

    try:
        got = loop.run_until_complete(deadlines())
    finally:
        sleeping.stop()
    for method in ("query", "finalize_block"):
        retries = ABCI_RETRIES if method in _RETRIABLE_METHODS else 0
        if got[method] != (f"ABCI {method} exceeded its {REJECT_DEADLINE_S}s "
                           f"deadline", 1) or \
                got[method + "_reset"] != 1 + retries:
            raise AssertionError(f"18d(ii): {got}")
    out["deadline"] = got

    async def killed_between_heights(app):
        """The app process killed once the node's state is at height 2.
        The consensus connection's client sees the transport go down and
        stays dead; the chain stops.  The error surfaces where the next
        call meets it: a FinalizeBlock or Commit stops consensus
        (``raise_if_failed``), a PrepareProposal is logged by the state
        machine ("unable to create proposal block") and the round times
        out, as in the JAX package and the reference's state machine
        (whose node then stops on the dead client: proxy/multi_app_conn.go
        killTMOnClientError, the node's to carry)."""
        conns = await _socket_conns(app.address, Registry(), [])
        node = await _CsNode.make(doc, device, pv=pvs[0],
                                  config=test_config().consensus,
                                  conns=conns)
        node.cs.logger = log = _LogRecorder()
        client = conns.clients["consensus"]
        await node.cs.start()
        try:
            await _cs_until(node, lambda: node.state_store.load(
                ).last_block_height >= 2, "the heights before the kill")
            app.proc.kill()
            app.proc.wait()
            await _cs_until(node, lambda: client._err is not None,
                            "the client seeing the transport go down",
                            timeout_s=10.0)
            heights = node.state_store.load().last_block_height
            await asyncio.sleep(2.0)
            if node.state_store.load().last_block_height != heights:
                raise AssertionError("18d(iii): the chain went on after "
                                     "the kill")
            try:
                await node.conns.consensus.echo("after")
                after = None
            except ABCIClientError as e:
                after = str(e)
            logged = [kv.get("err") for msg, kv in log.lines
                      if msg == "unable to create proposal block"]
            return client._err, node.cs.failure, logged, heights, after
        finally:
            try:
                await node.cs.stop()
            except Exception:  # noqa: BLE001 — the failure, seen above
                pass
            await conns.stop()

    killed = _AppProc(sock_dir, "killed").start()
    try:
        err, failure, logged, height, after = loop.run_until_complete(
            killed_between_heights(killed))
    finally:
        killed.stop()
    # the receive loop's error, whichever way the socket went down; the
    # call whose write meets the closed transport before that loop marks
    # the client dead gets asyncio's own error for it from drain()
    dead = f"ABCI client dead: {err}"
    seen = {str(err), dead, str(ConnectionResetError("Connection lost"))}
    surfaced = (failure is not None and str(failure) in seen) \
        or (failure is None and logged and set(logged) <= seen)
    if not (isinstance(err, (ConnectionError, asyncio.IncompleteReadError))
            or str(err) == "ABCI connection closed by app") or \
            after != dead or not surfaced:
        raise AssertionError(f"18d(iii): client {type(err).__name__} "
                             f"{err!r}, consensus failure {failure!r}, "
                             f"logged {logged[:3]}, then {after!r}")
    out["killed"] = (f"{type(err).__name__}: {err}", height,
                     f"raise_if_failed: {failure}" if failure is not None
                     else f"{len(logged)} rounds logged 'unable to create "
                          f"proposal block' with it, consensus not stopped")

    big = encode_uvarint(abci_pb.MAX_MSG_SIZE + 1)
    victim = _AppProc(sock_dir, "frames").start()

    async def frames():
        path = victim.address[len("unix://"):]
        reader, writer = await asyncio.open_unix_connection(path)
        writer.write(big + b"\x00" * 16)
        await writer.drain()
        closed = await asyncio.wait_for(reader.read(), 10.0) == b""
        writer.close()
        cli = SocketClient(victim.address)
        await cli.connect()
        echo = (await cli.echo("still serving")).message
        await cli.close()

        async def oversized(r, w):
            await r.read(1)
            w.write(big)
            await w.drain()
        srv = await asyncio.start_unix_server(
            oversized, path=os.path.join(sock_dir, "oversized.sock"))
        cli = SocketClient(f"unix://{os.path.join(sock_dir, 'oversized.sock')}")
        await cli.connect()
        try:
            await cli.echo("x")
            refused = None
        except ABCIServerError as e:
            refused = str(e)
        await cli.close()
        srv.close()
        return closed, echo, refused

    try:
        closed, echo, refused = loop.run_until_complete(frames())
    finally:
        victim.stop()
    if not closed or echo != "still serving" or \
            refused != f"message too large: {abci_pb.MAX_MSG_SIZE + 1}":
        raise AssertionError(f"18d(iv): closed {closed}, echo {echo!r}, "
                             f"client {refused!r}")
    _log(f"sockapp_reject: FinalizeBlock raising at height "
         f"{REJECT_FAULT_HEIGHT}: consensus stopped with (blocks, state) at "
         f"{out['raise'][1]}, {out['raise'][0]!r}, raise_if_failed raised it, the client "
         f"stays dead; an app {2 * REJECT_DEADLINE_S} s late: "
         f"{got['query'][0]!r} after {got['query'][1]} attempt, "
         f"{got['finalize_block'][0]!r} after {got['finalize_block'][1]}; "
         f"a transport reset: query {got['query_reset']} attempts, "
         f"finalize_block {got['finalize_block_reset']}; the app killed "
         f"at state height {out['killed'][1]}: the client's "
         f"{out['killed'][0]!r}, every later call 'ABCI client dead', the "
         f"chain stopped, {out['killed'][2]}; "
         f"a frame of {abci_pb.MAX_MSG_SIZE + 1} bytes: the server closed "
         f"that connection and serves the next, the client refused "
         f"{refused!r}; nothing restarted; B1 launches {ek.launches}; "
         f"card: {card}")
    return ek.launches


def _sockapp_phases(seed, card, keep, device=None):
    """Phases 18a-18d: the rest of ABCI and the gRPC surface (abci/
    server, pb, client's SocketAppConns, DeadlineClient and
    TracingClient, metrics, grammar; indexer/sink_sql, libs/health and
    pprof; rpc/grpc's servicers; the pruner's companion retain heights)
    over apps in processes of their own.  ``keep`` holds what phases 12
    and 13 leave: the twin chain with 12a's feed and figures, and 13a's
    figures.  Returns B1's launches by part and B2's."""
    import shutil
    import tempfile

    from cometbft_tpu_torch.libs import tracing
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    t_phase = time.perf_counter()
    # in TMPDIR unless its socket paths would pass the ~107-byte limit
    sock_dir = tempfile.mkdtemp(prefix="cs18-")
    if len(os.path.join(sock_dir, "oversized.sock")) > 100:
        os.rmdir(sock_dir)
        sock_dir = tempfile.mkdtemp(prefix="cs18-", dir="/tmp")
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        net = _sockapp_net(seed, card, ek, tracing, device, loop, sock_dir,
                           keep["sock"])
        node, cs, cs8 = _sockapp_cs(seed, card, ek, ek8, oe, tracing, device,
                                    loop, sock_dir, keep["chain"])
        _companion(card, loop, node, keep["chain"])
        reject = _sockapp_reject(seed, card, ek, device, loop, sock_dir)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
        shutil.rmtree(sock_dir, ignore_errors=True)
    _log(f"phase 18 took {time.perf_counter() - t_phase:.1f} s")
    return ({f"sockapp_{SOCK_VALIDATORS}x{SOCKAPP_HEIGHTS}": net,
             f"sockapp_cs_{EXEC_VALIDATORS}x{SOCKAPP_CS_HEIGHTS}": cs,
             "sockapp_reject": reject},
            {f"sockapp_cs_{EXEC_VALIDATORS}_cuda8": cs8})


# -- phase 19: the node and its entry points ---------------------------------


def _free_port_base(n: int) -> int:
    """A base port b with b..b+n-1 all free on 127.0.0.1 (cmd testnet
    numbers its nodes' ports from a base)."""
    import random
    import socket
    rng = random.Random()
    for _ in range(200):
        base = rng.randrange(20000, 60000 - n)
        socks = []
        try:
            for p in range(base, base + n):
                s = socket.socket()
                socks.append(s)
                s.bind(("127.0.0.1", p))
            return base
        except OSError:
            continue
        finally:
            for s in socks:
                s.close()
    raise AssertionError(f"no {n} consecutive free ports")


def _free_port() -> int:
    return _free_port_base(1)


def _compute_apps() -> list:
    """One pid for each process nvidia-smi lists as holding the card (a
    container may report pids outside its own pid namespace)."""
    out = subprocess.run(
        ["nvidia-smi", "--query-compute-apps=pid", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout
    return [int(x) for x in out.split() if x.strip().isdigit()]


def _node_cli(*args) -> list:
    """argv of the port's documented entry point, ``python -m
    cometbft_tpu_torch.cmd``, with ``args``."""
    return [*NODE_CLI, *map(str, args)]


class _NodeProc:
    """A ``cmd start --home HOME`` process, its stderr in HOME/node.log;
    the card is the default device, as a user runs it."""

    def __init__(self, home, *extra):
        self.home = home
        self.log_path = os.path.join(home, "node.log")
        root = os.path.dirname(os.path.abspath(__file__))
        env = {**os.environ, "PYTHONPATH": root + os.pathsep +
               os.environ.get("PYTHONPATH", "")}
        self.t0 = time.perf_counter()
        with open(self.log_path, "w") as log:
            self.proc = subprocess.Popen(
                _node_cli("--home", home, "start", *extra),
                stdout=subprocess.DEVNULL, stderr=log, cwd=root, env=env)

    def log(self) -> str:
        with open(self.log_path) as f:
            return f.read()

    def alive(self):
        if self.proc.poll() is not None:
            raise AssertionError(
                f"node process {self.home} exited with {self.proc.returncode}"
                f": {self.log()[-1500:]}")

    def stop(self, timeout_s=60.0) -> int:
        """SIGTERM, then the exit code (killed past ``timeout_s``)."""
        if self.proc.poll() is None:
            self.proc.terminate()
            try:
                self.proc.wait(timeout_s)
            except subprocess.TimeoutExpired:
                self.proc.kill()
                self.proc.wait()
                raise AssertionError(f"node process {self.home} did not stop "
                                     f"in {timeout_s} s on SIGTERM")
        return self.proc.returncode

    def launches(self) -> tuple:
        """(B1, B2) launches from the process's "Node stopped" line."""
        import re
        m = re.findall(r"Node stopped b1_launches=(\d+) b2_launches=(\d+)",
                       self.log())
        if not m:
            raise AssertionError(f"node process {self.home} logged no "
                                 f"'Node stopped' line: {self.log()[-800:]}")
        return tuple(map(int, m[-1]))


async def _rpc_heights(clients) -> list:
    return [int((await c.status())["sync_info"]["latest_block_height"])
            for c in clients]


async def _rpc_chain(cli, top, out=None) -> dict:
    """{h: (block id, app hash, header time, txs)} from /block, each held
    to /commit's signed header at the same height; heights ``out``
    already holds are not fetched again."""
    out = {} if out is None else out
    for h in range(len(out) + 1, top + 1):
        blk = await cli.call("block", height=h)
        com = await cli.call("commit", height=h)
        bid = blk["block_id"]["hash"]
        app = blk["block"]["header"]["app_hash"]
        sh = com["signed_header"]
        if (sh["commit"]["block_id"]["hash"], sh["header"]["app_hash"]) != \
                (bid, app):
            raise AssertionError(f"19a: /block and /commit at {h} disagree "
                                 f"on {cli.host}:{cli.port}")
        out[h] = (bid, app, blk["block"]["header"]["time"],
                  blk["block"]["data"].get("txs") or [])
    return out


def _node_testnet(card, root, loop):
    """19a node-4x30: BASELINE.json config 1 through the documented entry
    point: ``cmd testnet --v 4``, four ``cmd start`` processes on the card,
    ``cmd load`` over their RPC, 30 heights, SIGTERM.  Returns (the homes,
    B1's launches summed over the processes)."""
    from cometbft_tpu_torch.rpc.client import HTTPClient
    from cometbft_tpu_torch.tools import loadtime
    n, top = NODE_VALIDATORS, NODE_CLI_HEIGHTS
    _phase(f"19a node-{n}x{top}: cmd testnet --v {n}, {n} cmd start "
           f"processes, cmd load {NODE_LOAD_RATE} tx/s of {NODE_LOAD_SIZE} B "
           f"for {NODE_LOAD_SECONDS} s, {top} heights, SIGTERM")
    out = os.path.join(root, "testnet")
    p2p, rpc = _free_port_base(n), _free_port_base(n)
    subprocess.run(_node_cli(
        "testnet", "--v", n, "--o", out, "--chain-id", "node-chip",
        "--starting-p2p-port", p2p, "--starting-rpc-port", rpc),
        check=True, capture_output=True, text=True,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    homes = [os.path.join(out, f"node{i}") for i in range(n)]
    clients = [HTTPClient(f"http://127.0.0.1:{rpc + i}", timeout=30.0)
               for i in range(n)]
    apps_before = _compute_apps()
    procs = [_NodeProc(h) for h in homes]
    t_spawn = procs[0].t0
    load = None
    try:
        async def heights():
            try:
                return await _rpc_heights(clients)
            except OSError:
                return [0] * n

        async def until(pred, what, timeout_s):
            deadline = time.perf_counter() + timeout_s
            while True:
                for p in procs:
                    p.alive()
                hs = await heights()
                if pred(hs):
                    return hs
                if time.perf_counter() > deadline:
                    raise AssertionError(f"19a: {what} not reached in "
                                         f"{timeout_s} s (heights {hs})")
                await asyncio.sleep(0.1)

        loop.run_until_complete(until(lambda hs: min(hs) >= 1,
                                      "height 1 on every node", 180.0))
        first_block_s = time.perf_counter() - t_spawn
        t_load = time.time()
        load = subprocess.Popen(
            _node_cli("load", "--endpoints", ",".join(
                f"http://127.0.0.1:{rpc + i}" for i in range(n)),
                "--rate", NODE_LOAD_RATE, "--duration", NODE_LOAD_SECONDS,
                "--size", NODE_LOAD_SIZE),
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=os.path.dirname(os.path.abspath(__file__)))
        loop.run_until_complete(until(lambda hs: min(hs) >= 3,
                                      "height 3 on every node", 60.0))
        apps = _compute_apps()
        missing = [p.proc.pid for p in procs if p.proc.pid not in apps]
        if missing and len(apps) < len(apps_before) + n:
            raise AssertionError(
                f"19a: nvidia-smi lists no compute app for node pids "
                f"{missing}: {apps}, against {apps_before} before the spawn")
        holds = ("nvidia-smi listed every node pid" if not missing else
                 f"nvidia-smi listed {len(apps)} compute apps against "
                 f"{len(apps_before)} before the spawn (pids {apps}: "
                 f"reported outside this container's pid namespace)")
        lout, lerr = load.communicate(timeout=120)
        if load.returncode != 0:
            raise AssertionError(f"19a: cmd load exited {load.returncode}: "
                                 f"{lerr[-800:]}")
        res = json.loads(lout.strip().splitlines()[-1])
        if res["accepted"] == 0:
            raise AssertionError(f"19a: cmd load had no tx accepted: {res}")

        def committed(chain):
            got = collections.Counter()
            for h, (_, _, t, txs) in chain.items():
                for tx64 in txs:
                    p = loadtime.payload_from_tx(base64.b64decode(tx64))
                    if p is not None and p.get("id") == res["experiment_id"]:
                        got[tx64] += 1
            return got

        async def settle():
            deadline, chain = time.perf_counter() + 120.0, {}
            while True:
                hs = await until(lambda hs: min(hs) >= top,
                                 f"height {top} on every node", 120.0)
                await _rpc_chain(clients[0], min(hs), chain)
                got = committed(chain)
                if len(got) >= res["accepted"]:
                    return chain, got
                if time.perf_counter() > deadline:
                    raise AssertionError(f"19a: {len(got)} of "
                                         f"{res['accepted']} accepted txs "
                                         f"committed")
                await asyncio.sleep(0.5)
        chain, got = loop.run_until_complete(settle())
        top_now = max(chain)
        async def others():
            return await asyncio.gather(
                *(_rpc_chain(c, top_now) for c in clients[1:]))
        chains = [chain] + loop.run_until_complete(others())
        for h in range(1, top_now + 1):
            if len({c[h][:2] for c in chains}) != 1:
                raise AssertionError(f"19a: the nodes' block ids or app "
                                     f"hashes at {h} differ")
        if any(v != 1 for v in got.values()) or \
                len(got) != res["accepted"]:
            raise AssertionError(f"19a: {len(got)} distinct load txs "
                                 f"committed against {res['accepted']} "
                                 f"accepted, some more than once")
    finally:
        if load is not None and load.poll() is None:
            load.kill()
            load.wait()
        codes = [p.stop() for p in procs]
    for p, code in zip(procs, codes):
        if code:
            raise AssertionError(f"19a: cmd start exit codes {codes}: "
                                 f"{p.log()[-1500:]}")
    launches = [p.launches() for p in procs]
    if any(b1 == 0 for b1, _ in launches):
        raise AssertionError(f"19a: a node process launched B1 no time: "
                             f"{launches}")
    from cometbft_tpu_torch.tools.loadtime import _parse_block_time
    times = [_parse_block_time(chain[h][2]) for h in range(1, top_now + 1)]
    ms = [(b - a) * 1e3 for a, b in zip(times[1:], times[2:])]
    tx_heights = [h for h in chain if any(
        tx64 in got for tx64 in chain[h][3])]
    tx_span = times[max(tx_heights) - 1] - t_load
    # the chain's rate over the blocks that hold the load: from the block
    # before the first of them to the last
    chain_span = times[max(tx_heights) - 1] - \
        times[max(min(tx_heights) - 2, 0)]
    _log(f"node_{n}x{top} (cmd start processes on the card) ms a height "
         f"from the headers' times, heights 2-{top_now} {_p50_p90(ms)}; "
         f"start to every node's first block {first_block_s:.2f} s; cmd "
         f"load sent {res['sent']}, accepted {res['accepted']}, all "
         f"{len(got)} committed once in heights {min(tx_heights)}-"
         f"{max(tx_heights)} ({len(got) / chain_span:.1f} tx/s over those "
         f"blocks, {len(got) / tx_span:.1f} tx/s from the cmd load process's "
         f"spawn, its imports included); /block and /commit agree on the "
         f"block id and app "
         f"hash at every height on all {n} nodes; {holds}; B1 launches "
         f"by process {[b1 for b1, _ in launches]} (CUDA launches only); "
         f"every process exited 0 on SIGTERM; card: {card}")
    return homes, sum(b1 for b1, _ in launches)


async def _nodes_until(nodes, pred, what, timeout_s=120.0):
    deadline = time.perf_counter() + timeout_s
    while not pred():
        for nd in nodes:
            nd.raise_if_failed()
        if time.perf_counter() > deadline:
            raise AssertionError(f"{what}: not reached in {timeout_s} s "
                                 f"(heights {[nd.height for nd in nodes]})")
        await asyncio.sleep(0.005)


def _node_config(home, **sections):
    """The config ``cmd start`` reads for ``home`` (confix's overrides),
    with ``sections`` ({section: {key: value}}) laid over it."""
    from cometbft_tpu_torch import confix
    cfg = confix.effective_config(home)
    return confix.apply_overrides(cfg, sections)


def _node_inproc(card, ek, ek8, oe, homes, keep, device, loop, nodes):
    """19b node-inproc-4x50: four Nodes in this process on 19a's homes,
    50 heights, then one under cuda8; ``nodes`` gets them, running.
    Returns (B1's launches, B2's)."""
    from cometbft_tpu_torch.node import Node
    n, depth = len(homes), NODE_INPROC_HEIGHTS
    _phase(f"19b node-inproc-{n}x{depth}: {n} Nodes in one process on "
           f"19a's homes (device=None), {depth} heights, then one height "
           f"under cuda8")
    _clear_memos()
    nodes.extend(Node(_node_config(h), device=device) for h in homes)
    ek.launches = ek8.launches = 0
    with _commit_checks(ek) as checks:
        async def run():
            t0 = time.perf_counter()
            for nd in nodes:
                await nd.start()
            start_s = time.perf_counter() - t0
            await _nodes_until(nodes, lambda: not any(
                nd.consensus_reactor.wait_sync for nd in nodes),
                "every node in consensus")
            base = max(nd.height for nd in nodes)
            stamps = []
            for h in range(base + 1, base + depth + 1):
                await _nodes_until(nodes, lambda: nodes[0].height >= h,
                                   f"19b height {h}")
                stamps.append(time.perf_counter())
            await _nodes_until(nodes, lambda: all(
                nd.height >= base + depth for nd in nodes),
                "19b every node at the last height")
            return base, stamps, start_s
        base, stamps, start_s = loop.run_until_complete(run())
    launches = ek.launches
    heights = range(base + 1, base + depth + 1)
    mine = _node_checks(checks, [nd.block_exec for nd in nodes], heights)
    for i, counts in enumerate(mine):
        for h, got in zip(heights, counts):
            if got != 1:
                raise AssertionError(
                    f"19b: node {i}'s LastCommit check at {h} launched B1 "
                    f"{got} times (its validate_block calls there: "
                    f"{checks.get(h, {}).get(id(nodes[i].block_exec))})")
    # one height under cuda8
    os.environ[oe.KERNEL_ENV] = "cuda8"
    try:
        ek.launches = ek8.launches = 0
        top = max(nd.height for nd in nodes)
        loop.run_until_complete(_nodes_until(nodes, lambda: all(
            nd.height >= top + 1 for nd in nodes), "19b the cuda8 height"))
        b1_in_8, launches8 = ek.launches, ek8.launches
    finally:
        os.environ.pop(oe.KERNEL_ENV, None)
    if b1_in_8 or not launches8:
        raise AssertionError(f"19b: under cuda8 B2 launched {launches8} and "
                             f"B1 {b1_in_8} times, expected > 0 and 0")
    ms = [(b - a) * 1e3 for a, b in zip(stamps, stamps[1:])]
    sock = keep.get("sock") or {}
    ref = (f"13a's {_p50_p90(sock['ms'])}" if sock.get("ms") else
           "13a not run") + "; " + (
        f"18a's {_p50_p90(sock['sockapp_ms'])}" if sock.get("sockapp_ms")
        else "18a not run")
    ref_checks = [_tally(c) for c in sock["checks"]] if sock.get("checks") \
        else "13a not run"
    _log(f"node_inproc_{n}x{depth} ms a height (node 0, heights "
         f"{base + 2}-{base + depth}) {_p50_p90(ms)} against {ref} in this "
         f"call; the four start() calls (prebuild, handshake, block sync "
         f"begun) took {start_s:.2f} s at height {base}; B1 launches "
         f"{launches}; LastCommit check launches a height by node "
         f"{[_tally(c) for c in mine]}, 13a's by node {ref_checks}; the "
         f"cuda8 height: B2 {launches8}, B1 0; card: {card}")
    return launches, launches8


async def _node_join_run(joiner, trace):
    """Start ``joiner`` (state sync over RPC, block sync, the switch),
    recording each stage's end and B1's launches at it in ``trace``."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.statesync.syncer import Syncer
    real_sp, real_switch = joiner._make_state_provider, \
        joiner._switch_to_consensus

    def mark(stage):
        trace.setdefault("stages", []).append(
            (stage, time.perf_counter(), ek.launches))

    async def make_state_provider(state):
        sp = await real_sp(state)
        mark("new_rpc_state_provider (trust root)")
        return sp

    async def switch(new_state, height):
        mark("block sync to the switch")
        trace["switch_state"] = new_state
        await real_switch(new_state, height)
        mark("LastCommit rebuilt, consensus started")
    joiner._make_state_provider = make_state_provider
    joiner._switch_to_consensus = switch
    mark("start")
    with _async_timed(Syncer, "sync_any") as sync:
        await joiner.start()
    mark("state sync (discovery, snapshot, light blocks)")
    trace["sync_any_s"] = sync


def _node_join_outcome(joiner, net, trace):
    """The joiner's first consensus height h0 against ``net``'s stores:
    (h0, the proposer each names there, the rounds at which h0..h0+2
    committed)."""
    st = trace["switch_state"]
    h0 = st.last_block_height + 1
    mine = st.validators.get_proposer().address
    theirs = net.state_store.load_validators(h0).get_proposer().address
    rounds = []
    for h in range(h0, h0 + 3):
        blk = net.block_store.load_block(h + 1)
        rounds.append(blk.last_commit.round if blk is not None else None)
    return h0, mine, theirs, rounds


def _node_rpc_join(card, ek, nodes, root, device, loop):
    """19c node-rpc-join: a fifth Node, statesync.enable over the RPC of
    two of 19b's nodes with the trust root from /commit.  Returns B1's
    launches."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.node import Node, init_files
    from cometbft_tpu_torch.rpc.client import HTTPClient
    _phase("19c node-rpc-join: a fifth Node state-syncs over the RPC of two "
           "of 19b's nodes (trust root from /commit), block-syncs and "
           "switches to consensus")
    home = os.path.join(root, "joiner")
    urls = [f"http://{nd._rpc_server.listen_addr}" for nd in nodes[:2]]
    cli = HTTPClient(urls[0])
    trust_h = NODE_JOIN_TRUST
    com = loop.run_until_complete(cli.call("commit", height=trust_h))
    trust_hash = com["signed_header"]["commit"]["block_id"]["hash"]
    peers = ",".join(f"{nd.node_key.id}@{nd.switch.listen_addr}"
                     for nd in nodes)
    cfg = Config()
    cfg.base.home = home
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    shutil.copy(nodes[0].config.base.path(nodes[0].config.base.genesis_file),
                os.path.join(home, "config", "genesis.json"))
    init_files(cfg)
    cfg = _node_config(home, p2p={
        "laddr": f"tcp://127.0.0.1:{_free_port()}",
        "persistent_peers": peers}, rpc={"laddr": ""}, statesync={
        "enable": True, "rpc_servers": urls, "trust_height": trust_h,
        "trust_hash": trust_hash,
        "discovery_time_ns": NODE_JOIN_DISCOVERY_NS})
    joiner = Node(cfg, device=device)
    trace = {}
    ek.launches = 0
    try:
        loop.run_until_complete(_node_join_run(joiner, trace))
        loop.run_until_complete(_nodes_until(
            [joiner] + nodes, lambda: "switch_state" in trace and
            joiner.height >= trace["switch_state"].last_block_height + 3,
            "19c: the joiner three heights into consensus"))
        launches = ek.launches
        h0, mine, theirs, rounds = _node_join_outcome(joiner, nodes[0],
                                                     trace)
        base = joiner.block_store.base
        for h in range(base, joiner.height + 1):
            a = joiner.block_store.load_block_meta(h)
            b = nodes[0].block_store.load_block_meta(h)
            if a.block_id != b.block_id or \
                    a.header.app_hash != b.header.app_hash:
                raise AssertionError(f"19c: the joiner's block or app hash at "
                                     f"{h} differs from the net's")
    finally:
        loop.run_until_complete(joiner.stop())
    if mine != theirs:
        raise AssertionError(f"19c: at its first consensus height {h0} the "
                             f"joiner names proposer {mine.hex()[:12]}, the "
                             f"net {theirs.hex()[:12]}")
    stages, last = [], None
    for name, t, l in trace["stages"]:
        if last is not None:
            stages.append(f"{name} {(t - last[0]) * 1e3:.1f} ms, "
                          f"{l - last[1]} B1")
        last = (t, l)
    _log(f"node_rpc_join stages (B1 launches of this process, 19b's four "
         f"nodes included): {'; '.join(stages)} (sync_any "
         f"{trace['sync_any_s'][0] * 1e3:.1f} ms with "
         f"{NODE_JOIN_DISCOVERY_NS / 1e9:.1f} s of discovery); the "
         f"snapshot at {base - 1}, blocks {base}-{joiner.height} held to the "
         f"net's (ids and app hashes); "
         f"first consensus height {h0}: the joiner and the net name proposer "
         f"{mine.hex()[:12]}; rounds of heights {h0}-{h0 + 2}: {rounds}; B1 "
         f"launches {launches}; card: {card}")
    return launches


def _node_manifest(card, ek, root, device, loop):
    """19d manifest-e2e: generate(MANIFEST_SEED, max_nodes=4) through
    run_manifest on the card.  Returns B1's launches."""
    from cometbft_tpu_torch.tools import manifest as mf
    man = mf.generate(MANIFEST_SEED, max_nodes=4)
    perturbed = [f"{k}:{p}" for k, nm in man.nodes.items() for p in nm.perturb]
    late = [k for k, nm in man.nodes.items() if nm.start_at]
    _phase(f"19d manifest-e2e: generate({MANIFEST_SEED}, max_nodes=4): "
           f"{len(man.nodes)} nodes ({man.key_type}, {man.abci_protocol}), "
           f"perturbation {perturbed}, late joiners {late}, {man.evidence} "
           f"duplicate-vote evidences, to height {MANIFEST_TARGET}")
    _clear_memos()
    ek.launches = 0
    t0 = time.perf_counter()
    rep = loop.run_until_complete(mf.run_manifest(
        man, os.path.join(root, "manifest"), target_height=MANIFEST_TARGET,
        timeout_s=MANIFEST_TIMEOUT_S, device=device))
    wall_s = time.perf_counter() - t0
    launches = ek.launches
    if rep.mismatches or not rep.evidence_injected or \
            rep.evidence_committed < len(rep.evidence_injected) or \
            not perturbed or not late or \
            min(rep.heights.values()) < MANIFEST_TARGET or not launches:
        raise AssertionError(f"19d: {rep}; B1 launches {launches}")
    _log(f"manifest_e2e reached height {MANIFEST_TARGET} everywhere in "
         f"{rep.reached_target_s:.2f} s ({wall_s:.2f} s with the load's "
         f"drain); heights {rep.heights}; load {rep.load_accepted} of "
         f"{rep.load_sent} accepted; perturbed {rep.perturbed}; "
         f"{len(rep.evidence_injected)} evidences injected, "
         f"{rep.evidence_committed} committed; block ids and app hashes "
         f"identical across nodes; B1 launches {launches}; card: {card}")
    return launches


def _node_reject(card, root, device, loop):
    """19e node-reject: a killed socket app stops its cmd start process
    (non-zero, the error on stderr); validate_basic refuses a bad config;
    a home without a genesis is refused; grpc.laddr without grpcio
    raises."""
    from cometbft_tpu_torch.config import Config, ConfigError
    from cometbft_tpu_torch.node import Node, NodeError, init_files
    from cometbft_tpu_torch.rpc.client import HTTPClient
    _phase("19e node-reject: a killed socket app, a bad config, a home "
           "without a genesis, grpc.laddr without grpcio")
    rows = []
    # (i) the app process killed under a running cmd start
    home = os.path.join(root, "deadapp")
    subprocess.run(_node_cli("--home", home, "init", "--chain-id",
                             "deadapp-chip"), check=True, capture_output=True,
                   cwd=os.path.dirname(os.path.abspath(__file__)))
    sock_dir = tempfile.mkdtemp(prefix="cs19-", dir="/tmp")
    app = _AppProc(sock_dir, "app").start()
    rpc = _free_port()
    with open(os.path.join(home, "config", "config.json"), "w") as f:
        json.dump({"base": {"abci": "socket", "proxy_app": app.address},
                   "rpc": {"laddr": f"tcp://127.0.0.1:{rpc}"},
                   "p2p": {"laddr": f"tcp://127.0.0.1:{_free_port()}"}}, f)
    proc = _NodeProc(home)
    try:
        cli = HTTPClient(f"http://127.0.0.1:{rpc}")

        async def height():
            deadline = time.perf_counter() + 120.0
            while time.perf_counter() < deadline:
                proc.alive()
                try:
                    st = await cli.status()
                    if int(st["sync_info"]["latest_block_height"]) >= 2:
                        return
                except OSError:
                    pass
                await asyncio.sleep(0.1)
            raise AssertionError("19e: the socket-app node reached no "
                                 "height 2")
        loop.run_until_complete(height())
        app.proc.kill()
        t_kill = time.perf_counter()
        try:
            code = proc.proc.wait(60)
        except subprocess.TimeoutExpired:
            raise AssertionError("19e: cmd start ran on for 60 s after its "
                                 "app was killed") from None
        stop_s = time.perf_counter() - t_kill
        log = proc.log()
        if code == 0 or "node stopped: NodeError: ABCI client connection " \
                "terminated" not in log:
            raise AssertionError(f"19e: cmd start exited {code} after its "
                                 f"app was killed: {log[-1500:]}")
        rows.append(f"killed app: cmd start exited {code} in {stop_s:.2f} s "
                    f"({log.strip().splitlines()[-1][:160]})")
    finally:
        proc.stop()
        app.stop()
        shutil.rmtree(sock_dir, ignore_errors=True)

    async def refused(make, exc, text, what):
        try:
            await make()
        except exc as e:
            if text not in str(e):
                raise AssertionError(f"19e {what}: {e!r} lacks {text!r}")
            rows.append(f"{what}: {type(e).__name__}: {str(e)[:120]}")
            return
        raise AssertionError(f"19e {what}: not refused")

    # (ii) validate_basic
    async def bad_config():
        cfg = Config()
        cfg.mempool.size = 0
        Node(cfg, device=device)
    loop.run_until_complete(refused(bad_config, ConfigError,
                                    "mempool.size must be positive",
                                    "mempool.size 0"))

    # (iii) a home without a genesis
    async def no_genesis():
        cfg = Config()
        cfg.base.home = os.path.join(root, "empty")
        Node(cfg, device=device)
    loop.run_until_complete(refused(no_genesis, FileNotFoundError,
                                    "genesis.json", "no genesis"))

    # (iv) grpc.laddr where grpcio cannot load
    async def no_grpcio():
        cfg = Config()
        cfg.base.home = os.path.join(root, "grpc")
        init_files(cfg, chain_id="grpc-chip")
        cfg.rpc.laddr = ""
        cfg.p2p.laddr = "tcp://127.0.0.1:0"
        cfg.grpc.laddr = f"tcp://127.0.0.1:{_free_port()}"
        saved = {k: sys.modules.pop(k) for k in list(sys.modules)
                 if k == "grpc" or k.startswith("grpc.") or k in (
                     "cometbft_tpu_torch.rpc.grpc.server",
                     "cometbft_tpu_torch.rpc.grpc.client")}
        sys.modules["grpc"] = None
        try:
            await Node(cfg, device=device).start()
        finally:
            sys.modules.pop("grpc", None)
            sys.modules.update(saved)
    loop.run_until_complete(refused(no_grpcio, NodeError,
                                    "grpc.laddr is set but the gRPC server "
                                    "cannot load", "grpc.laddr"))
    _log(f"node_reject: {'; '.join(rows)}; card: {card}")


def _node_phases(seed, card, keep, device=None):
    """Phases 19a-19e: the node (node/, cmd/, config, confix,
    tools/manifest) run as a user runs it.  ``keep`` may hold 13a's and
    18a's figures (``keep["sock"]``) to print beside 19b's.  Returns B1's
    launches by part and B2's."""
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cs19-")
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    nodes = []
    try:
        homes, cli_b1 = _node_testnet(card, root, loop)
        inproc_b1, inproc_b2 = _node_inproc(card, ek, ek8, oe, homes, keep,
                                            device, loop, nodes)
        join_b1 = _node_rpc_join(card, ek, nodes, root, device, loop)
        while nodes:
            loop.run_until_complete(nodes.pop().stop())
        manifest_b1 = _node_manifest(card, ek, root, device, loop)
        _node_reject(card, root, device, loop)
    finally:
        for nd in nodes:   # what a failed part left running
            try:
                loop.run_until_complete(nd.stop())
            except Exception:  # noqa: BLE001 — the part's error is raised
                pass
        logging.disable(logging.NOTSET)
        loop.close()
        shutil.rmtree(root, ignore_errors=True)
    _log(f"phase 19 took {time.perf_counter() - t_phase:.1f} s")
    n = NODE_VALIDATORS
    return ({f"node_{n}x{NODE_CLI_HEIGHTS}": cli_b1,
             f"node_inproc_{n}x{NODE_INPROC_HEIGHTS}": inproc_b1,
             "node_rpc_join": join_b1, "manifest_e2e": manifest_b1},
            {f"node_inproc_{n}_cuda8": inproc_b2})


def _qa_min_sigs(validators: int, ghosts: int) -> int:
    """The fewest live signatures (power 100 each) that carry more than
    2/3 of a QA net's power (``ghosts`` of power 1): 9 of 12 + 90."""
    total = 100 * validators + ghosts
    return next(k for k in range(validators + 1) if 300 * k > 2 * total)


def _qa_window_rows(rep) -> str:
    return "; ".join(
        f"{w.rate} tx/s offered: {w.tx_per_s:.1f} tx/s committed, latency "
        f"p50 {w.latency_p50_s:.3f} p90 {w.latency_p90_s:.3f} s, dup ratio "
        f"{w.dup_ratio}, RSS avg {w.rss_avg_mb:.1f} max {w.rss_max_mb:.1f} "
        f"MB, CPU {w.cpu_total_pct:.1f}%, fds {w.fds_max}, mempool max "
        f"{w.mempool_max}" for w in rep.windows)


def _qa_fleet(card, root, device, loop):
    """20a qa-fleet-12+3: the QA tool's process fleet at the reference QA
    width: 12 validators and 3 full nodes as `cmd start` processes on the
    card across three latency zones, 90 ghost validators (102 slots a
    commit), two load windows, a kill -9 and restart, a state-sync
    joiner.  Returns B1's launches summed over the processes."""
    from cometbft_tpu_torch.tools import qa
    _phase(f"20a qa-fleet: run_qa_procs, {QA_VALIDATORS} validators + "
           f"{QA_FULL} full nodes + {QA_GHOSTS} ghosts, rates {QA_RATES}, "
           f"{QA_WINDOW_S} s windows, kill -9 and restart, a state-sync "
           f"joiner, each node a cmd start process on the card")
    live = []

    def on_live(pids):
        live.append((dict(pids), _compute_apps()))

    t0 = time.perf_counter()
    rep = loop.run_until_complete(qa.run_qa_procs(
        os.path.join(root, "fleet"), n_validators=QA_VALIDATORS,
        n_full=QA_FULL, ghosts=QA_GHOSTS, rates=QA_RATES,
        window_s=QA_WINDOW_S, perturb=True, joiner=True, profile=False,
        device=device, on_live=on_live))
    took = time.perf_counter() - t0
    if rep.mismatches:
        raise AssertionError(f"20a: mismatches {rep.mismatches}")
    if not rep.statesync_joiner_height:
        raise AssertionError("20a: the joiner did not reach the target")
    if not rep.perturbed_recovered:
        raise AssertionError("20a: the kill -9 victim did not recover")
    want = _qa_min_sigs(QA_VALIDATORS, QA_GHOSTS)
    if not rep.commit_sigs_heights or rep.commit_sigs_min < want:
        raise AssertionError(
            f"20a: sampled commits carry {rep.commit_sigs_min} signatures "
            f"at least ({rep.commit_sigs_heights} heights), want >= {want}")
    pids, apps = live[0] if live else ({}, [])
    # the node processes and this script's own context
    if len(pids) != QA_VALIDATORS + QA_FULL or len(apps) < len(pids) + 1:
        raise AssertionError(f"20a: {len(apps)} compute apps on the card "
                             f"for {len(pids)} live node processes and "
                             f"this script")
    names = {f"validator{i:02d}" for i in range(QA_VALIDATORS)} | \
        {f"full{i:02d}" for i in range(QA_FULL)} | {"joiner"}
    counts = rep.node_launches
    if set(counts) != names or any(c["b1"] <= 0 for c in counts.values()):
        raise AssertionError(f"20a: B1 launches by process {counts}")
    b1 = sum(c["b1"] for c in counts.values())
    _log(f"qa_fleet: {rep.nodes} processes ({rep.validators_total} "
         f"validators in the set, {rep.validators_live} live), first block "
         f"{rep.first_block_s:.2f} s after the spawn, final height "
         f"{rep.final_height}, joiner at {rep.statesync_joiner_height}, "
         f"{rep.perturbation} recovered; commit signatures avg "
         f"{rep.commit_sigs_avg} min {rep.commit_sigs_min} over "
         f"{rep.commit_sigs_heights} sampled heights (>= {want}); block "
         f"interval avg {rep.block_interval_avg_s:.3f} s (std "
         f"{rep.block_interval_std_s:.3f}); dup ratio overall "
         f"{rep.dup_ratio_overall}; prevote 2/3 p95 "
         f"{rep.prevote_t23_p95_s} s, commit skew max "
         f"{rep.commit_skew_max_s} s; generator self-check "
         f"{rep.offered_check.get('offered_ratio')}; degraded "
         f"{rep.degraded}; {took:.1f} s; card: {card}")
    _log(f"qa_fleet windows: {_qa_window_rows(rep)}")
    _log(f"qa_fleet compute apps: {len(apps)} listed by nvidia-smi with "
         f"{len(pids)} node processes live; B1 launches by process "
         f"{ {n: c['b1'] for n, c in sorted(counts.items())} } (sum {b1}), "
         f"B2 {sum(c['b2'] for c in counts.values())}")
    return b1


def _qa_lightserve(card, ek, root, device, loop):
    """20b qa-lightserve: run_lightserve's 1,000 simulated light clients
    against four in-process Nodes on the card.  Returns B1's launches."""
    from cometbft_tpu_torch.tools import qa
    _phase(f"20b qa-lightserve: {QA_LS_CLIENTS} light clients, "
           f"{QA_LS_REQUESTS} requests each, over light_block / multiproof / "
           f"commit on four Nodes under a tx load")
    ek.launches = 0
    t0 = time.perf_counter()
    rep = loop.run_until_complete(qa.run_lightserve(
        os.path.join(root, "ls"), n_clients=QA_LS_CLIENTS,
        requests_per_client=QA_LS_REQUESTS, device=device))
    took = time.perf_counter() - t0
    b1 = ek.launches
    if rep.request_errors or rep.proof_verify_errors or \
            rep.cache_hit_rate <= 0 or b1 <= 0:
        raise AssertionError(
            f"20b: {rep.request_errors} request errors, "
            f"{rep.proof_verify_errors} proof errors, hit rate "
            f"{rep.cache_hit_rate}, {b1} B1 launches: {rep.notes[:3]}")
    _log(f"qa_lightserve: {rep.requests_total} requests of {rep.clients} "
         f"clients in {rep.hammer_duration_s:.2f} s ({rep.requests_per_s} "
         f"/s), p50 {rep.req_p50_ms} p90 {rep.req_p90_ms} max "
         f"{rep.req_max_ms} ms; {rep.proofs_verified} proofs verified; "
         f"cache hit rate {rep.cache_hit_rate} ({rep.cache_hits} hits, "
         f"{rep.cache_misses} misses, {rep.cache_entries} entries, "
         f"{rep.cache_bytes} bytes); block interval before "
         f"{rep.block_interval_before_s} s, during {rep.block_interval_during_s}"
         f" s (slo ok {rep.slo_ok}); heights served {rep.heights_served}, "
         f"final {rep.final_height}; B1 {b1}; degraded {rep.degraded}; "
         f"{took:.1f} s; card: {card}")
    return b1


def _qa_fuzz(card, seed, root):
    """20c qa-fuzz: each fuzz target for QA_FUZZ_S seconds from a copy of
    the port's corpus, then both corpora replayed."""
    from cometbft_tpu_torch.tools import fuzz
    _phase(f"20c qa-fuzz: jsonrpc, proto, secretconn for {QA_FUZZ_S} s each, "
           f"the JAX package's corpus and the port's replayed")
    corpus = os.path.join(root, "corpus")
    shutil.copytree(fuzz.DEFAULT_CORPUS, corpus)
    rows = []
    for name in sorted(fuzz.TARGETS):
        stats = fuzz.fuzz_target(fuzz.TARGETS[name](), QA_FUZZ_S,
                                 corpus_dir=corpus, seed=seed + 1)
        if stats.crashes or stats.locations <= 10:
            raise AssertionError(f"20c {name}: {stats.to_dict()}")
        replayed = {}
        for what, d in (("jax", fuzz.REFERENCE_CORPUS),
                        ("port", fuzz.DEFAULT_CORPUS)):
            target = fuzz.TARGETS[name]()
            try:
                replayed[what] = fuzz.replay_corpus(target, d)
            finally:
                target.close()
        rows.append(f"{name}: {stats.runs} runs, {stats.locations} lines, "
                    f"{stats.new_inputs} new inputs, 0 crashes, replayed "
                    f"{replayed['jax']} JAX and {replayed['port']} port inputs")
    _log(f"qa_fuzz: {'; '.join(rows)}; card: {card}")


def _qa_mesh(card, seed, ek, root, device):
    """20d qa-mesh: a mixed 10,240-lane batch through verify_sharded over
    make_mesh(), held to verify_batch and the golden model; one tally step
    in a one-rank NCCL group; the sharding report.  Returns B1's launches
    of the sharded dispatch."""
    import numpy as np
    import torch
    import torch.distributed as dist
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.parallel import mesh as pmesh
    from cometbft_tpu_torch.parallel import report as preport
    _phase(f"20d qa-mesh: {QA_MESH_LANES} mixed lanes through verify_sharded "
           f"over make_mesh(), a tally step, the sharding report")
    keys = [ed25519.gen_priv_key_from_secret(_seed(seed + 20, i))
            for i in range(256)]
    items = []
    for i in range(QA_MESH_LANES):
        k = keys[i % len(keys)]
        msg = b"mesh-%d" % i
        pub, sig = k.pub_key().bytes(), k.sign(msg)
        if i % 7 == 3:
            sig = sig[:32] + bytes(32)                       # S = 0
        elif i % 11 == 5:
            sig = sig[:32] + ref.L.to_bytes(32, "little")    # S >= L
        elif i % 13 == 7:
            msg += b"!"                                      # tampered
        elif i % 17 == 9:
            pub = pub[:31]                                   # malformed
        items.append((pub, msg, sig))
    a, r, s, k, pre_bad = oe.prep_arrays(items, QA_MESH_LANES)
    devices = pmesh.make_mesh(None, device)
    ek.launches = 0
    t0 = time.perf_counter()
    mask = pmesh.verify_sharded(a, r, s, k, ndev=len(devices), device=device)
    sharded_ms = (time.perf_counter() - t0) * 1e3
    b1 = ek.launches
    mask[pre_bad] = False
    if device is None and b1 != len(devices):
        raise AssertionError(f"20d: {b1} B1 launches for {len(devices)} "
                             f"shards")
    _all, want = oe.verify_batch(items, device=device)
    if mask.tolist() != want:
        raise AssertionError("20d: verify_sharded's mask != verify_batch's")
    rng = np.random.default_rng(seed)
    sample = rng.choice(QA_MESH_LANES, min(256, QA_MESH_LANES),
                        replace=False)
    for i in sample:
        pub, msg, sig = items[i]
        golden = len(pub) == 32 and ref.verify(pub, msg, sig)
        if bool(mask[i]) != golden:
            raise AssertionError(f"20d: lane {i} {bool(mask[i])} != golden "
                                 f"{golden}")
    # several shards on the one card: a numbered card listed QA_MESH_SPLIT
    # times, a lane count that is not a whole number of B1 blocks a shard,
    # so the per-shard wires, the events, the join and the sliced-off
    # padding all run on the card
    split_dev = "cuda:0" if device is None else device
    n_split = QA_MESH_SPLIT_LANES
    ek.launches = 0
    t0 = time.perf_counter()
    split = pmesh.verify_sharded(a[:n_split], r[:n_split], s[:n_split],
                                 k[:n_split], ndev=QA_MESH_SPLIT,
                                 device=split_dev)
    split_ms = (time.perf_counter() - t0) * 1e3
    split_b1 = ek.launches
    split[pre_bad[:n_split]] = False
    if split.shape != (n_split,) or split.tolist() != want[:n_split]:
        raise AssertionError(f"20d: the {QA_MESH_SPLIT}-shard mask on "
                             f"{split_dev} != verify_batch's")
    if device is None and split_b1 != QA_MESH_SPLIT:
        raise AssertionError(f"20d: {split_b1} B1 launches for "
                             f"{QA_MESH_SPLIT} shards on {split_dev}")
    backend = "nccl" if torch.device(device or "cuda").type == "cuda" \
        else "gloo"
    dist.init_process_group(backend,
                            init_method=f"tcp://localhost:{_free_port()}",
                            world_size=1, rank=0)
    try:
        before = pmesh.collectives["all_reduce"]
        ok, count = pmesh.sharded_verify_tally(device=device)(
            a, r, s, k, pre_bad=pre_bad)
        reduces = pmesh.collectives["all_reduce"] - before
    finally:
        dist.destroy_process_group()
    if count != int(mask.sum()) or ok.tolist() != mask.tolist() or \
            reduces != 1:
        raise AssertionError(f"20d: tally count {count} against the mask's "
                             f"{int(mask.sum())}, {reduces} all_reduces")
    out = os.path.join(root, "sharding.json")
    if preport.main(["--out", out, "--run-lanes", str(QA_REPORT_LANES),
                     *(["--device", device] if device else [])]) != 0:
        raise AssertionError("20d: the sharding report failed its checks")
    with open(out) as f:
        rep = json.load(f)
    if rep["collectives"]["verify_path"] != 0 or \
            rep["collectives"]["tally_path"] != 1:
        raise AssertionError(f"20d: report collectives {rep['collectives']}")
    model = rep["timing_model"]
    _log(f"qa_mesh: {QA_MESH_LANES} lanes over {len(devices)} device(s) in "
         f"{sharded_ms:.2f} ms host time, {b1} B1 launch(es), "
         f"{int(mask.sum())} valid, mask == verify_batch's and the golden "
         f"model's on {len(sample)} lanes; {n_split} lanes in "
         f"{QA_MESH_SPLIT} shards (padded to "
         f"{pmesh.padded_lanes(n_split, QA_MESH_SPLIT)}) on {split_dev}: "
         f"{split_ms:.2f} ms host time, {split_b1} B1 launches, mask == "
         f"verify_batch's; tally count {count} with {reduces} "
         f"all_reduce ({backend}); report geometry {rep['geometry']}, "
         f"collectives {rep['collectives']}, reduced run "
         f"{rep['executed_reduced']}; timing model "
         f"{json.dumps(model)}; card: {card}")
    return b1, split_b1


def _qa_reject(card, root):
    """20e qa-reject: the QA tool's quick process fleet (4 validators, a
    full node, 20 ghosts, one 5 s window) with the full node started under
    an unknown COMETBFT_TPU_TORCH_KERNEL: that child exits 1, the run
    records it in mismatches and the tool exits 1."""
    _phase("20e qa-reject: a fleet child under an unknown kernel name")
    out = os.path.join(root, "reject.json")
    t0 = time.perf_counter()
    proc = subprocess.run(
        [*QA_CLI, "--quick", "--procs", "--window", "5", "--rates", "25",
         "--no-joiner", "--no-profile", "--child-env",
         "full00:COMETBFT_TPU_TORCH_KERNEL=qa-reject", "--out", out],
        capture_output=True, text=True, timeout=600,
        cwd=os.path.dirname(os.path.abspath(__file__)))
    took = time.perf_counter() - t0
    if proc.returncode != 1:
        raise AssertionError(f"20e: the QA tool exited {proc.returncode}: "
                             f"{proc.stderr[-1500:]}")
    with open(out) as f:
        rep = json.load(f)
    bad = [m for m in rep["mismatches"] if m.startswith("full00:")]
    if len(rep["mismatches"]) != 1 or not bad or \
            "COMETBFT_TPU_TORCH_KERNEL='qa-reject'" not in bad[0]:
        raise AssertionError(f"20e: mismatches {rep['mismatches']}")
    _log(f"qa_reject: the tool exited 1 in {took:.1f} s; {bad[0][:200]}; "
         f"card: {card}")


def _qa_phases(seed, card, device=None):
    """Phases 20a-20e: the testnet tools (tools/qa.py, tools/fuzz.py,
    tools/fleet_report.py) and the mesh split and tally (parallel/).
    Returns B1's launches by part."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cs20-")
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        fleet_b1 = _qa_fleet(card, root, device, loop)
        ls_b1 = _qa_lightserve(card, ek, root, device, loop)
        _qa_fuzz(card, seed, root)
        mesh_b1, split_b1 = _qa_mesh(card, seed, ek, root, device)
        _qa_reject(card, root)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
        shutil.rmtree(root, ignore_errors=True)
    _log(f"phase 20 took {time.perf_counter() - t_phase:.1f} s")
    return {f"qa_fleet_{QA_VALIDATORS}+{QA_FULL}": fleet_b1,
            "qa_lightserve_4": ls_b1, f"qa_mesh_{QA_MESH_LANES}": mesh_b1,
            f"qa_mesh_{QA_MESH_SPLIT_LANES}x{QA_MESH_SPLIT}": split_b1}


def _bench_configs(card, ek, device):
    """21a: tools/benchmarks.main with each of BENCH_ARGS in this process
    on the card, B1's launches counted around each call.  Returns
    {config: (line, launches)}."""
    import io
    from cometbft_tpu_torch.tools import benchmarks
    _phase(f"21a the BASELINE configs' runner: tools.benchmarks.main(args) "
           f"on the card for args in {BENCH_ARGS}")
    lines, launches = [], {}
    t0 = time.perf_counter()
    for args in BENCH_ARGS:
        out = io.StringIO()
        l0 = ek.launches
        with contextlib.redirect_stdout(out):
            rc = benchmarks.main(list(args))
        got = [json.loads(x) for x in out.getvalue().splitlines()]
        if rc != 0 or len(got) != 1:
            raise AssertionError(f"21a {args}: rc {rc}, lines "
                                 f"{out.getvalue()!r}")
        lines.append(got[0])
        launches[got[0]["config"]] = ek.launches - l0
    took = time.perf_counter() - t0
    if [r["config"] for r in lines] != [2, 3, 4, 5]:
        raise AssertionError(f"21a: configs {[r['config'] for r in lines]}")
    name = card.split(",")[0].strip()
    got = {}
    for rec in lines:
        n = rec["config"]
        want = BENCH_JAX_KEYS[n] | {"device"}
        if set(rec) != want:
            raise AssertionError(f"21a config {n}: keys {sorted(rec)}, "
                                 f"want {sorted(want)}")
        if rec["device"] != name:
            raise AssertionError(f"21a config {n}: device {rec['device']!r}"
                                 f" is not nvidia-smi's {name!r}")
        if launches.get(n, 0) <= 0:
            raise AssertionError(f"21a config {n}: no B1 launch")
        got[n] = (rec, launches[n])
        _log(f"bench_config_{n}: {json.dumps(rec)}; B1 launches "
             f"{launches[n]}; card: {card}")
    c2 = got[2][0]
    if c2["backend"] != ("cuda" if device is None else "cpu") or \
            list(c2["results_ms"]) != BENCH_SIZES:
        raise AssertionError(f"21a config 2: {c2}")
    _log(f"bench_configs: four configs in {took:.1f} s (config 2 verified "
         f"every signature at {', '.join(c2['results_ms'])}; config 5 at "
         f"{got[5][0]['validators']} keys)")
    return got


def _bench_process(card):
    """21b: ``python -m cometbft_tpu_torch.tools.benchmarks --config 2`` as
    a process at the default sizes."""
    _phase("21b the runner as a process: python -m "
           "cometbft_tpu_torch.tools.benchmarks --config 2")
    root = os.path.dirname(os.path.abspath(__file__))
    t0 = time.perf_counter()
    proc = subprocess.run(BENCH_CLI + ["--config", "2"], capture_output=True,
                          text=True, cwd=root, timeout=300)
    took = time.perf_counter() - t0
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or len(lines) != 1:
        raise AssertionError(f"21b: rc {proc.returncode}, stdout "
                             f"{proc.stdout!r}, stderr "
                             f"{proc.stderr[-2000:]!r}")
    rec = json.loads(lines[0])
    if rec["config"] != 2 or list(rec["results_ms"]) != ["64", "256"]:
        raise AssertionError(f"21b: {rec}")
    _log(f"bench_process: rc 0 in {took:.1f} s: {lines[0]}; card: {card}")


def _flight_node(card, ek, root, device, loop):
    """21c and 21d on one Node on the card.  Returns B1's launches in
    21c."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.crypto import batch as crypto_batch
    from cometbft_tpu_torch.crypto import ed25519
    from cometbft_tpu_torch.libs import supervisor as libsup
    from cometbft_tpu_torch.node import Node, init_files
    _phase(f"21c the flight recorder: a Node on the card whose supervised "
           f"task verifies {FLIGHT_SIGS} signatures on B1 and crashes past "
           f"a budget of {FLIGHT_RESTARTS} restarts; /debug/pprof/trace"
           f"?dump=1")
    cfg = Config()
    cfg.base.home = os.path.join(root, "flight")
    cfg.base.log_level = "error"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.instrumentation.pprof_listen_addr = "127.0.0.1:0"
    init_files(cfg, chain_id="flight-chip")
    data = cfg.base.path(cfg.base.db_dir)
    privs = [ed25519.gen_priv_key_from_secret(b"flight-%d" % i)
             for i in range(FLIGHT_SIGS)]
    items = [(p.pub_key(), b"flight-%d" % i, p.sign(b"flight-%d" % i))
             for i, p in enumerate(privs)]
    node = Node(cfg, device=device)
    runs = []

    async def verify_then_crash():
        bv = crypto_batch.create_batch_verifier(items[0][0], node.device)
        for it in items:
            bv.add(*it)
        ok, _ = bv.verify()
        runs.append(ok)
        raise RuntimeError("21c: the supervised task fails on purpose")

    async def run():
        await node.start()
        try:
            await _nodes_until([node], lambda: node.height >= 2, "height 2")
            l0 = ek.launches
            st = node.supervisor.spawn(
                verify_then_crash, name="flight_chip", kind="flight_chip",
                policy=libsup.RestartPolicy(max_restarts=FLIGHT_RESTARTS,
                                            backoff_base_s=0.01))
            await st.wait()
            b1 = ek.launches - l0
            port = int(node._pprof_server.listen_addr.rsplit(":", 1)[1])
            raw = await _http_get(port, "/debug/pprof/trace?dump=1")
            dumped = json.loads(raw.partition(b"\r\n\r\n")[2])
            churn = await _churn_metrics(node)
        finally:
            await node.stop()
        return st, b1, dumped, churn

    t0 = time.perf_counter()
    st, b1, dumped, churn = loop.run_until_complete(run())
    took = time.perf_counter() - t0
    if not st.gave_up or runs != [True] * (FLIGHT_RESTARTS + 1):
        raise AssertionError(f"21c: gave_up {st.gave_up}, verdicts {runs}")
    if b1 < FLIGHT_RESTARTS + 1:
        raise AssertionError(f"21c: {b1} B1 launches for "
                             f"{FLIGHT_RESTARTS + 1} runs")
    flights = sorted(f for f in os.listdir(data)
                     if f.startswith("flight-") and
                     f.endswith("-supervisor_giveup_node_flight_chip.json"))
    if len(flights) != 1:
        raise AssertionError(f"21c: flight records {os.listdir(data)}")
    path = os.path.join(data, flights[0])
    with open(path) as f:
        rec = json.load(f)
    spans = [e for e in rec["events"] if e["name"] == "kernel_execute"]
    want_keys = ["reason", "wall_time", "monotonic_ns", "pid", "node",
                 "anchors", "extra", "events"]
    if list(rec) != want_keys or len(spans) < FLIGHT_RESTARTS + 1 or \
            rec["extra"].get("task") != "flight_chip" or \
            rec["events"][-1]["name"] != "giveup":
        raise AssertionError(f"21c: record keys {list(rec)}, "
                             f"{len(spans)} kernel_execute spans, extra "
                             f"{rec['extra']}")
    dump_path = dumped.get("dump_path", "")
    if not dump_path or not os.path.exists(dump_path) or \
            os.path.dirname(dump_path) != data:
        raise AssertionError(f"21c: /trace?dump=1 answered {dump_path!r}")
    _log(f"flight_record: {os.path.basename(path)} "
         f"({os.path.getsize(path)} B, {len(rec['events'])} events, "
         f"{len(spans)} kernel_execute spans of "
         f"{sorted({e['attrs'].get('batch') for e in spans})} lanes, "
         f"{len(rec['anchors'])} anchors); /trace?dump=1 wrote "
         f"{os.path.basename(dump_path)}; B1 launches {b1}; node up and "
         f"through 21c-21d in {took:.1f} s; card: {card}")
    series, over, pages = churn
    _log(f"metrics_ceiling: {CHURN_PEERS} peer ids -> {series} series a "
         f"peer-labelled family ({over} in overflow); /metrics "
         f"{pages[0]} B, ?exemplars=1 {pages[1]} B; card: {card}")
    return b1


async def _churn_metrics(node):
    """21d: CHURN_PEERS peer ids through ``node``'s peer-labelled
    families; each must hold 2,048 series and one ``overflow``, the RPC's
    /metrics page must carry each family's 2,049 series, and its
    ?exemplars=1 page the same in OpenMetrics with trace-height
    exemplars.  Returns (series a family, overflow count, page sizes)."""
    from cometbft_tpu_torch.libs import metrics as libmetrics
    _phase(f"21d the metric ceiling: {CHURN_PEERS} peer ids through the "
           f"node's p2p and consensus families")
    p2p, cons = node.p2p_metrics, node.consensus_metrics
    fams = (p2p.peer_pending_send_bytes, p2p.recv_rate_limiter_delay,
            p2p.send_rate_limiter_delay, cons.block_parts)
    before = cons.block_parts.series_count()   # the node's own peers
    for i in range(CHURN_PEERS):
        peer = hashlib.sha256(b"churn-%d" % i).hexdigest()[:40]
        p2p.peer_pending_send_bytes.with_labels(peer).set(i)
        p2p.recv_rate_limiter_delay.with_labels(peer).add(0.001)
        p2p.send_rate_limiter_delay.with_labels(peer).add(0.001)
        cons.block_parts.with_labels(peer).add()
    cap = libmetrics._CHILDREN_MAX
    counts = {f.name: f.series_count() for f in fams}
    over = cons.block_parts.with_labels("overflow").value
    if set(counts.values()) != {cap + 1} or \
            over != CHURN_PEERS - (cap - before):
        raise AssertionError(f"21d: series {counts}, overflow {over}")
    port = node._rpc_server.port
    plain = (await _http_get(port, "/metrics", close=True)).partition(
        b"\r\n\r\n")[2]
    om = (await _http_get(port, "/metrics?exemplars=1", close=True)
          ).partition(b"\r\n\r\n")[2]
    for f in fams:
        name = f.name.encode()
        n_plain = plain.count(b"\n" + name + b"{")
        # OpenMetrics: a counter's samples carry _total
        sample = name + b"_total{" if f.kind == "counter" and \
            not name.endswith(b"_total") else name + b"{"
        n_om = om.count(b"\n" + sample)
        if n_plain != cap + 1 or n_om != cap + 1:
            raise AssertionError(f"21d: {f.name} has {n_plain} series on "
                                 f"/metrics, {n_om} on ?exemplars=1")
    if not om.endswith(b"# EOF\n") or b' # {trace_height="' not in om or \
            b" # {" in plain:
        raise AssertionError("21d: the exemplar page lacks its EOF or an "
                             "exemplar, or the plain page carries one")
    return cap + 1, over, (len(plain), len(om))


def _bench_phases(seed, card, device=None):
    """Phases 21a-21d: tools/benchmarks.py's configs on the card, the
    flight recorder's dumps and the metric ceiling.  Returns B1's
    launches by part."""
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cs21-")
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        configs = _bench_configs(card, ek, device)
        _bench_process(card)
        flight_b1 = _flight_node(card, ek, root, device, loop)
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
        shutil.rmtree(root, ignore_errors=True)
    _log(f"phase 21 took {time.perf_counter() - t_phase:.1f} s")
    return {**{f"bench_config_{n}": b1 for n, (_, b1) in configs.items()},
            "flight_giveup": flight_b1}


# -- 22. the fault paths ------------------------------------------------------
TESTS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tests")
# commit-path boundaries the 22b sweep crashes at, in height 2 (fail point
# indices count from the process start, 7 a height)
FAIL_POINTS_A_HEIGHT = 7
CRASH_BOUNDARIES = (0, 2, 5, 6)
CRASH_TARGET = 5
CRASH_TIMEOUT_S = 120


def _fault_scenarios(Scenario):
    """22a's two scenarios, written as tests/test_nemesis.py writes them
    (tests/test_torch_nemesis.py holds the literals to the JAX ones)."""
    return (
        Scenario(
            name="faulty-links",
            seed=23,
            fuzz=dict(prob_reorder=0.05, prob_duplicate=0.05,
                      prob_drop_write=0.02, prob_delay=0.05,
                      max_delay_s=0.02),
            steps=(
                ("wait_blocks", 4),
            ),
            recovery_blocks=2),
        Scenario(
            name="pipelined-commit",
            seed=17,
            use_wal=True,
            fuzz=dict(prob_reorder=0.06, prob_duplicate=0.06,
                      prob_delay=0.04, max_delay_s=0.01),
            steps=(
                ("wait_blocks", 3),
                ("crash", 2),
                ("expect_progress", (0, 1, 3), 2, 60.0),
                ("restart", 2),
                ("wait_blocks", 2),
            ),
            recovery_blocks=3))


def _stored_commits(net):
    """(height, chain id, validators, block id, commit) of every commit
    each node of ``net`` stores."""
    for n in net.nodes:
        for h in range(1, n.block_store.height + 1):
            commit = n.block_store.load_block_commit(h) or \
                n.block_store.load_seen_commit(h)
            yield (h, n.doc.chain_id, n.state_store.load_validators(h),
                   n.block_store.load_block_meta(h).block_id, commit)


def _nemesis_scenario(card, ek, oe, s, device):
    """One 22a scenario.  Returns B1's launches in the run."""
    from cometbft_tpu_torch.types import validation
    from torch_nemesis import run_scenario
    lanes = [0]
    real = ek.verify_cols

    def counting(a, r, sw, k):
        lanes[0] += int(a.shape[1])
        return real(a, r, sw, k)

    loop = asyncio.new_event_loop()
    ek.verify_cols = counting
    ek.launches = 0
    t0 = time.perf_counter()
    try:
        net = loop.run_until_complete(run_scenario(s, device=device))
    finally:
        b1 = ek.launches
        ek.verify_cols = real
        loop.close()
    took = time.perf_counter() - t0
    frames = net.frames()
    heights = [n.height for n in net.nodes]
    _log(f"{s.name} (seed {s.seed}): heights {heights}, frames dropped "
         f"{frames['dropped']} duplicated {frames['duplicated']} reordered "
         f"{frames['reordered']} delayed {frames['delayed']}, recovery "
         f"{net.recovery_s:.3f} s to {s.recovery_blocks} blocks (bound "
         f"{s.recovery_timeout_s:.0f} s), no conflicting commit over "
         f"{max(heights)} heights, B1 launches {b1} lanes {lanes[0]}, "
         f"{took:.1f} s; card: {card}")
    if b1 == 0:
        raise AssertionError(f"22a {s.name}: B1 never launched")
    if min(heights) < s.recovery_blocks:
        raise AssertionError(f"22a {s.name}: heights {heights}")
    # every stored commit again, on the card
    ek.launches = 0
    t0 = time.perf_counter()
    checked = 0
    for h, chain_id, vals, block_id, commit in _stored_commits(net):
        validation.verify_commit(chain_id, vals, block_id, h, commit,
                                 device=device)
        checked += 1
    _log(f"{s.name}: {checked} stored commits of {len(net.nodes)} nodes "
         f"verified again through verify_commit in "
         f"{time.perf_counter() - t0:.2f} s, B1 launches {ek.launches}")
    if checked < sum(heights):
        raise AssertionError(f"22a {s.name}: {checked} commits verified "
                             f"of {sum(heights)}")
    # one height's batch, a corrupted lane added, against the plain B1
    h, chain_id, vals, _, commit = next(
        c for c in _stored_commits(net) if c[0] == 2)
    items = [(vals.validators[i].pub_key.bytes(),
              commit.vote_sign_bytes(chain_id, i), cs.signature)
             for i, cs in enumerate(commit.signatures) if cs.for_block()]
    pub, msg, sig = items[0]
    items.append((pub, msg, bytes([sig[0] ^ 1]) + sig[1:]))
    _, mask = oe.verify_batch(items, device=device)
    _, plain = oe.verify_batch(items, device="cpu")
    if mask != plain or mask != [True] * (len(items) - 1) + [False]:
        raise AssertionError(f"22a {s.name}: B1 mask {mask}, plain {plain}")
    _log(f"{s.name}: height 2's {len(items) - 1} signatures and a "
         f"corrupted lane: B1 mask == plain B1 mask {mask}")
    return b1


def _crash_run(home, target, fail_index, device):
    """One crash-driver process; returns (rc, seconds, its JSON line or
    None, its output)."""
    env = {**os.environ}
    env.pop("FAIL_TEST_INDEX", None)
    if fail_index >= 0:
        env["FAIL_TEST_INDEX"] = str(fail_index)
    if device is not None:
        env["COMETBFT_TPU_TORCH_CRASH_DEVICE"] = str(device)
    t0 = time.perf_counter()
    p = subprocess.run(
        [sys.executable, os.path.join(TESTS_DIR, "torch_crash_driver.py"),
         home, str(target)], env=env, capture_output=True, text=True,
        timeout=CRASH_TIMEOUT_S)
    took = time.perf_counter() - t0
    line = next((json.loads(x) for x in reversed(p.stdout.splitlines())
                 if x.startswith("{")), None)
    return p.returncode, took, line, p.stdout + p.stderr


def _torn_wal(home):
    """Overwrite the last 20 bytes of a node's WAL; returns its path."""
    wal = os.path.join(home, "data", "cs.wal", "wal")
    with open(wal, "r+b") as f:
        f.seek(0, 2)
        f.seek(max(0, f.tell() - 20))
        f.write(b"\xde\xad\xbe\xef" * 5)
    return wal


def _crash_sweep(card, root, device):
    """22b: the crash processes side by side, then their restarts side by
    side; the torn-WAL node's first run goes with the crashes."""
    idx = {b: FAIL_POINTS_A_HEIGHT + b for b in CRASH_BOUNDARIES}
    homes = {b: os.path.join(root, f"crash{b}", "node") for b in idx}
    torn = os.path.join(root, "torn", "node")
    _phase(f"22b the fail-point crash sweep: node processes on the card "
           f"crash (exit 99) at boundaries {CRASH_BOUNDARIES} of height 2 "
           f"(indices {sorted(idx.values())}) and restart to height "
           f"{CRASH_TARGET}; a restart on a torn WAL tail")
    with ThreadPoolExecutor(len(idx) + 1) as ex:
        crashes = {b: ex.submit(_crash_run, homes[b], 50, i, device)
                   for b, i in idx.items()}
        first = ex.submit(_crash_run, torn, CRASH_TARGET, -1, device)
        crashes = {b: f.result() for b, f in crashes.items()}
        first = first.result()
    for b, (rc, took, _, out) in crashes.items():
        _log(f"boundary {b} (index {idx[b]}): rc {rc} after {took:.1f} s")
        if rc != 99:
            raise AssertionError(f"22b: fail point {idx[b]} gave rc {rc}:"
                                 f"\n{out[-2000:]}")
    if first[0] != 0:
        raise AssertionError(f"22b: the torn-WAL node's first run gave rc "
                             f"{first[0]}:\n{first[3][-2000:]}")
    wal = _torn_wal(torn)
    with ThreadPoolExecutor(len(idx) + 1) as ex:
        restarts = {b: ex.submit(_crash_run, homes[b], CRASH_TARGET, -1,
                                 device) for b in idx}
        again = ex.submit(_crash_run, torn, CRASH_TARGET + 3, -1, device)
        restarts = {b: f.result() for b, f in restarts.items()}
        again = again.result()
    for name, (rc, took, line, out) in [
            *((f"restart after boundary {b}", r)
              for b, r in restarts.items()),
            ("torn WAL, first run", first), ("torn WAL, restart", again)]:
        if rc != 0 or line is None:
            raise AssertionError(f"22b: {name} gave rc {rc}:\n"
                                 f"{out[-2000:]}")
        _log(f"{name}: rc 0, Node.start {line['start_s']:.3f} s, height "
             f"{line['height']} {line['run_s']:.3f} s later, process "
             f"{took:.1f} s, B1 launches {line['b1_launches']} lanes "
             f"{line['b1_lanes']}")
    if not os.path.exists(wal + ".corrupted"):
        raise AssertionError("22b: the torn WAL left no .corrupted copy")
    _log(f"torn WAL: repaired with a .corrupted copy "
         f"({os.path.getsize(wal + '.corrupted')} B), committed on to "
         f"height {again[2]['height']}; card: {card}")


def _fault_phases(seed, card, device=None):
    """Phases 22a-22b: the nemesis's faulty-links and pipelined-commit
    scenarios in this process on B1, the stored commits verified again,
    and the crash sweep's node processes.  Returns B1's launches by
    scenario."""
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    if TESTS_DIR not in sys.path:
        sys.path.insert(0, TESTS_DIR)
    from torch_nemesis import Scenario
    t_phase = time.perf_counter()
    root = tempfile.mkdtemp(prefix="cs22-")
    launches = {}
    logging.disable(logging.INFO)
    try:
        for s in _fault_scenarios(Scenario):
            _phase(f"22a the nemesis on the card: {s.name} (seed {s.seed})"
                   f", four validators on B1")
            launches[f"nemesis_{s.name}"] = _nemesis_scenario(
                card, ek, oe, s, device)
        _crash_sweep(card, root, device)
    finally:
        logging.disable(logging.NOTSET)
        shutil.rmtree(root, ignore_errors=True)
    _log(f"phase 22 took {time.perf_counter() - t_phase:.1f} s")
    return launches


# -- 23. the record readers ---------------------------------------------------
# the JAX package's live exposition contract (tests/test_metrics_contract.py:
# three validators, four txs), run to a height that leaves five completed
OBS_VALIDATORS = 3
OBS_TXS = 4
OBS_HEIGHT = 6
OBS_TIMEOUT_S = 60.0
# the histogram families the live contract requires observed, and the labels
OBS_HISTOGRAMS = (
    ("cometbft_consensus_step_duration_seconds", {}),
    ("cometbft_consensus_quorum_prevote_delay_seconds", {}),
    ("cometbft_consensus_block_interval_seconds", {}),
    ("cometbft_consensus_rounds_per_height", {}),
    ("cometbft_proxy_method_timing_seconds", {"conn": "consensus"}),
    ("cometbft_mempool_checktx_duration_seconds", {}),
    ("cometbft_p2p_message_send_size_bytes", {}),
)


def _obs_config(root, name):
    """One validator home as the live exposition contract makes it: RPC
    and p2p on free ports, a 30 ms commit timeout, a FilePV and a node
    key."""
    from cometbft_tpu_torch.config import Config
    from cometbft_tpu_torch.p2p.key import NodeKey
    from cometbft_tpu_torch.privval import FilePV
    home = os.path.join(root, name)
    cfg = Config()
    cfg.base.home = home
    cfg.p2p.laddr = "tcp://127.0.0.1:0"
    cfg.rpc.laddr = "tcp://127.0.0.1:0"
    cfg.p2p.allow_duplicate_ip = True
    cfg.consensus.timeout_commit_ns = 30_000_000
    os.makedirs(os.path.join(home, "config"), exist_ok=True)
    os.makedirs(os.path.join(home, "data"), exist_ok=True)
    pv = FilePV.generate(cfg.base.path(cfg.base.priv_validator_key_file),
                         cfg.base.path(cfg.base.priv_validator_state_file))
    NodeKey.load_or_gen(cfg.base.path(cfg.base.node_key_file))
    return cfg, pv


async def _obs_net(root, device):
    """OBS_VALIDATORS Nodes on one genesis under ``root``, started and
    dialed full mesh (the nodes started so far are stopped if that
    fails)."""
    from cometbft_tpu_torch.node import Node
    from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
    from cometbft_tpu_torch.types.timestamp import Timestamp
    cfgs = [_obs_config(root, f"n{i}") for i in range(OBS_VALIDATORS)]
    gen = GenesisDoc(chain_id="contract-chain", genesis_time=Timestamp.now(),
                     validators=[GenesisValidator(
                         address=b"", pub_key=pv.get_pub_key(), power=10)
                         for _, pv in cfgs])
    for cfg, _ in cfgs:
        gen.save_as(cfg.base.path(cfg.base.genesis_file))
    nodes = [Node(cfg, device=device) for cfg, _ in cfgs]
    started = []
    try:
        for nd in nodes:
            await nd.start()
            started.append(nd)
        for i, a in enumerate(nodes):
            for b in nodes[i + 1:]:
                await a.switch.dial_peer(b.switch.listen_addr)
    except BaseException:
        for nd in started:
            await nd.stop()
        raise
    return nodes


async def _obs_body(port, path) -> str:
    return (await _http_get(port, path, close=True)).partition(
        b"\r\n\r\n")[2].decode()


async def _obs_run(root, device):
    """The net to OBS_HEIGHT with OBS_TXS txs sent to node 0; node 0's
    ``/trace?height=H`` of each height every node has committed, its
    ``/metrics`` and ``/metrics?exemplars=1``, then the nodes stopped.
    Returns a dict: ``traces`` by height, the ``metrics`` and ``om``
    pages, ``in_progress`` (the highest height begun at the scrape),
    ``run_s`` (seconds to OBS_HEIGHT) and ``since`` (unix seconds at the
    start, what an exemplar of this run is stamped after)."""
    from cometbft_tpu_torch.rpc.client import HTTPClient
    # exemplar stamps are wall-clock metadata, compared as such
    since = time.time()
    t0 = time.perf_counter()
    nodes = await _obs_net(root, device)
    try:
        cli = HTTPClient(f"http://{nodes[0]._rpc_server.listen_addr}",
                         timeout=30.0)
        for i in range(OBS_TXS):
            await cli.broadcast_tx_sync(b"contract%d=v" % i)
        await _nodes_until(nodes, lambda: all(
            nd.height >= OBS_HEIGHT for nd in nodes),
            f"23 every node at height {OBS_HEIGHT}", OBS_TIMEOUT_S)
        run_s = time.perf_counter() - t0
        port = nodes[0]._rpc_server.port
        top = min(nd.height for nd in nodes)
        traces = {}
        for h in range(1, top + 1):
            body = json.loads(await _obs_body(port, f"/trace?height={h}"))
            traces[h] = body["result"]
        metrics = await _obs_body(port, "/metrics")
        om = await _obs_body(port, "/metrics?exemplars=1")
        in_progress = max(nd.consensus_state.rs.height for nd in nodes)
    finally:
        for nd in nodes:
            await nd.stop()
    return {"traces": traces, "metrics": metrics, "om": om,
            "in_progress": in_progress, "run_s": run_s, "since": since}


def _kernel_spans(events):
    return [e for e in events
            if e["category"] == "crypto" and e["name"] == "kernel_execute"]


def _obs_traces(card, traces, record, launches):
    """23a: each committed height's ``/trace`` body through the port's
    trace_report, one line a height; every kernel_execute span's kernel
    is ``cuda`` and the run's record holds one span a logged launch."""
    from cometbft_tpu_torch.tools import trace_report
    for h, body in traces.items():
        row = trace_report.analyze(body, height=h).get(h)
        if row is None:
            raise AssertionError(f"23a: /trace?height={h} gave no row")
        spans = _kernel_spans(body["events"])
        _log(f"height {h}: wall {row['wall_ms']:.3f} ms, gossip "
             f"{row['gossip_ms']:.3f}, verify {row['verify_ms']:.3f}, "
             f"execute {row['execute_ms']:.3f}, commit "
             f"{row['commit_ms']:.3f}, kernel_execute spans {len(spans)}")
    text = trace_report.render_report(next(iter(traces.values())))
    if "gossip_ms" not in text:
        raise AssertionError(f"23a: the report lacks gossip_ms:\n{text}")
    spans = _kernel_spans(record["events"])
    kernels = sorted({str((e.get("attrs") or {}).get("kernel"))
                      for e in spans})
    if kernels != ["cuda"]:
        raise AssertionError(f"23a: kernel_execute spans name kernels "
                             f"{kernels}")
    rows = trace_report.analyze(record)
    by_height = sum(sum(b["name"] == "kernel_execute" for b in r["batches"])
                    for r in rows.values())
    if len(spans) != len(launches) or by_height != len(spans):
        raise AssertionError(
            f"23a: {len(spans)} kernel_execute spans in the run's record "
            f"({by_height} in its height rows), {len(launches)} B1 launches")
    if not spans:
        raise AssertionError("23a: B1 never launched")
    _log(f"23a: {len(spans)} kernel_execute spans over {len(rows)} heights "
         f"== {len(launches)} B1 launches in the run (buckets "
         f"{sorted(collections.Counter(launches).items())}); card: {card}")


def _obs_metrics(card, run, backend):
    """23b: both pages through the exposition contract; the live
    contract's histograms observed, batch verification counted under the
    port's backend label, every exemplar of this run at a height that
    had begun."""
    from torch_exposition import (assert_exposition_contract,
                                  exemplar_heights, hist_count)
    metrics, om, in_progress = run["metrics"], run["om"], run["in_progress"]
    fams = assert_exposition_contract(metrics)
    om_fams = assert_exposition_contract(om, openmetrics=True)
    # OpenMetrics names a counter family without its _total suffix
    plain = {n[:-len("_total")] if f["type"] == "counter" and
             n.endswith("_total") else n for n, f in fams.items()}
    if plain != set(om_fams):
        raise AssertionError(f"23b: families only on one page: "
                             f"{sorted(plain ^ set(om_fams))}")
    counts = {name: hist_count(fams, name, **labels)
              for name, labels in OBS_HISTOGRAMS}
    verified = hist_count(fams, "cometbft_crypto_batch_verify_seconds",
                          backend=backend)
    if not all(counts.values()) or not verified:
        raise AssertionError(f"23b: counts {counts}, batch verify "
                             f"{verified} under backend={backend}")
    heights = exemplar_heights(om_fams, since=run["since"])
    if not heights or not 1 <= min(heights) <= max(heights) <= in_progress:
        raise AssertionError(f"23b: exemplar heights {sorted(set(heights))}"
                             f", heights in progress up to {in_progress}")
    _log(f"23b: /metrics {len(metrics)} B and /metrics?exemplars=1 "
         f"{len(om)} B pass the exposition contract, {len(fams)} families; "
         f"batch_verify_seconds _count {verified:.0f} under "
         f"backend={backend}; {len(heights)} exemplars of this run at heights "
         f"{min(heights)}-{max(heights)} (heights in progress up to "
         f"{in_progress}); card: {card}")


def _obs_catalog():
    """23c: the catalog in this process is tier-1's."""
    from cometbft_tpu_torch.tools import metrics_catalog
    from torch_catalog import TABLE
    got = metrics_catalog.to_markdown(
        metrics_catalog.collect_catalog()).splitlines()
    want = TABLE.splitlines()
    if got != want:
        raise AssertionError(
            f"23c: the catalog differs from tier-1's: only here "
            f"{[r for r in got if r not in want]}, only in tier-1's "
            f"{[r for r in want if r not in got]}")
    _log(f"23c: collect_catalog() gives tier-1's {len(got) - 2} families")


def _observability_phases(seed, card, device=None):
    """Phase 23: three Nodes in this process on ``device`` (None: the
    card) run the live exposition contract's net; node 0's records go
    through the port's readers.  Returns B1's launches."""
    from cometbft_tpu_torch.device import resolve
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.rpc import core as rpc_core
    if TESTS_DIR not in sys.path:
        sys.path.insert(0, TESTS_DIR)
    t_phase = time.perf_counter()
    n = OBS_VALIDATORS
    _phase(f"23 the record readers: {n} Nodes in this process (device="
           f"{device}), {OBS_TXS} txs, every node to height {OBS_HEIGHT}; "
           f"node 0's /trace, /metrics and /metrics?exemplars=1")
    _clear_memos()
    root = tempfile.mkdtemp(prefix="cs23-")
    loop = asyncio.new_event_loop()
    logging.disable(logging.INFO)
    try:
        with _launch_log(ek) as launches:
            run = loop.run_until_complete(_obs_run(root, device))
        # the three nodes share this process's recorder and launch count:
        # the route serves the whole run's record, all three nodes' spans
        record = loop.run_until_complete(rpc_core.routes(None)["trace"]())
    finally:
        logging.disable(logging.NOTSET)
        loop.close()
        shutil.rmtree(root, ignore_errors=True)
    _log(f"23: {n} nodes at height {OBS_HEIGHT} {run['run_s']:.2f} s after "
         f"the first start; heights in progress up to {run['in_progress']}")
    _obs_traces(card, run["traces"], record, launches)
    _obs_metrics(card, run, resolve(device).type)
    _obs_catalog()
    _log(f"phase 23 took {time.perf_counter() - t_phase:.1f} s")
    return {f"observability_{n}x{OBS_HEIGHT}": len(launches)}


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
        # the host libraries' g++ builds run beside nvcc's
        with ThreadPoolExecutor(4) as builds:
            hosts = [builds.submit(load) for load in (
                _build.load_host, _build.load_bls, _build.load_ed25519_host,
                _build.load_aead)]
            _build.load()
            nvcc_wall = time.perf_counter() - t0
            host = hosts[0].result()
            for f in hosts[1:]:
                f.result()
        _log(f"build_seconds {nvcc_wall:.3f} "
             f"(nvcc {_build.build_info['seconds']:.3f} s wall for "
             f"{', '.join(_build.SOURCES)}, compiled in parallel and "
             f"linked into one library, "
             f"cached={_build.build_info['cached']}); every library built "
             f"{time.perf_counter() - t0:.3f} s after the start")
        _log(_build.build_info["ptxas"].strip())
        report = _build.build_info["ptxas"]
        _log(f"host_build_seconds beside nvcc (g++ "
             f"{_build.host_build_info['seconds']:.3f} s for "
             f"{_build.HOST_SOURCE}, {' '.join(_build.HOST_FLAGS)}, "
             f"cached={_build.host_build_info['cached']}); os.cpu_count "
             f"{os.cpu_count()}; multi-buffer SHA-512 "
             f"{bool(host.ed25519_prep_multibuffer())}; prep threads at "
             f"3,334 / 10,000 items: {host.ed25519_prep_threads(3334)} / "
             f"{host.ed25519_prep_threads(10000)}")
        _log(f"bls_build_seconds beside nvcc (g++ "
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
    sync_launches, sync_launches8 = _sync_phases(args.seed, card, keep)
    ss_launches, ss_launches8 = _statesync_phases(args.seed, card, keep)
    rpc_launches, rpc_launches8 = _rpc_phases(args.seed, card, keep)
    ls_launches, ls_launches8 = _lightserve_phases(args.seed, card, keep)
    sa_launches, sa_launches8 = _sockapp_phases(args.seed, card, keep)
    node_launches, node_launches8 = _node_phases(args.seed, card, keep)
    qa_launches = _qa_phases(args.seed, card)
    bench_launches = _bench_phases(args.seed, card)
    fault_launches = _fault_phases(args.seed, card)
    obs_launches = _observability_phases(args.seed, card)

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
                             **cs_launches, **p2p_launches,
                             **sync_launches, **ss_launches,
                             **rpc_launches, **ls_launches,
                             **sa_launches, **node_launches,
                             **qa_launches, **bench_launches,
                             **fault_launches, **obs_launches},
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
                             **cs_launches8, **sync_launches8,
                             **ss_launches8, **rpc_launches8,
                             **ls_launches8, **sa_launches8,
                             **node_launches8},
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
