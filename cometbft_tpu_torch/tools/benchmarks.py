"""Runnable BASELINE benchmark configs.

Reference: cometbft_tpu/tools/benchmarks.py.  BASELINE.md lists five
reproduction configs; #1 (the live 4-validator kvstore testnet) is
``tools/manifest.py`` + ``cometbft_tpu_torch.cmd load``, and this module
runs the verification workloads:

  #2  the batch verifier at 64 / 1k / 10k ed25519 signatures
  #3  light-client skipping verification over a large validator set
  #4  consensus replay: a VoteSet tally and a Commit verify a height
  #5  stress: a large mixed-key commit and a bls12381 aggregate

Run:  python -m cometbft_tpu_torch.tools.benchmarks [--full] [--config N]
      [--device cpu]
Each config prints one JSON line with the reference's keys, plus
``device`` (the card's name, or ``cpu``).  ``--full`` uses the BASELINE
sizes.  Every config verifies through the port's entry points on
``device`` (None: the card), so each ed25519 batch is a launch of the
CUDA verifier that ``COMETBFT_TPU_TORCH_KERNEL`` names; config 2's
``backend`` is that kernel's name, or ``cpu`` for the plain version.  A
kernel that fails raises.

Keys are fresh unless a config is given ``seed``: then key i is
``gen_priv_key_from_secret(b"bench-<seed>-<i>")`` of its type, counted
across the config's draws in the reference's order.
"""
from __future__ import annotations

import argparse
import json
import time
from typing import Optional

import torch

from ..device import resolve


def _now() -> float:
    return time.perf_counter()


class _Keys:
    """Where a config's private keys come from: fresh ones, or, with a
    seed, ``gen_priv_key_from_secret(b"bench-<seed>-<i>")`` with i
    counted over every draw of the config."""

    def __init__(self, seed: Optional[int]):
        self.seed = seed
        self.drawn = 0

    def __call__(self, mod):
        if self.seed is None:
            return mod.gen_priv_key()
        secret = b"bench-%d-%d" % (self.seed, self.drawn)
        self.drawn += 1
        return mod.gen_priv_key_from_secret(secret)


def _backend(dev: torch.device) -> str:
    """Config 2's ``backend``: the kernel module, or ``cpu``."""
    from ..ops import ed25519 as ops_ed25519
    return "cpu" if dev.type == "cpu" else ops_ed25519._kernel_choice()


def _device_name(dev: torch.device) -> str:
    """Every line's ``device``: the card's name, or ``cpu``."""
    return "cpu" if dev.type == "cpu" else torch.cuda.get_device_name(dev)


def _make_valset(privs):
    """ValidatorSet sorted the consensus way, with the private keys
    re-paired to the sorted order (configs #3, #4 and #5)."""
    from ..types.validator import Validator
    from ..types.validator_set import ValidatorSet

    vals = [Validator.new(p.pub_key(), 10) for p in privs]
    pairs = sorted(zip(vals, privs),
                   key=lambda vp: (-vp[0].voting_power, vp[0].address))
    vals = [p[0] for p in pairs]
    privs = [p[1] for p in pairs]
    return ValidatorSet(vals), privs


def _signed_commit(chain_id, vset, privs, height, bid,
                   base_s=1700000000):
    """Commit with one real precommit signature per validator."""
    from ..types import canonical
    from ..types.commit import Commit, CommitSig
    from ..types.timestamp import Timestamp
    from ..types.vote import BLOCK_ID_FLAG_COMMIT, Vote

    sigs = []
    for i, (val, priv) in enumerate(zip(vset.validators, privs)):
        ts = Timestamp(base_s + height, i)
        v = Vote(type=canonical.PRECOMMIT_TYPE, height=height, round=0,
                 block_id=bid, timestamp=ts,
                 validator_address=val.address, validator_index=i)
        sigs.append(CommitSig(block_id_flag=BLOCK_ID_FLAG_COMMIT,
                              validator_address=val.address,
                              timestamp=ts,
                              signature=priv.sign(v.sign_bytes(chain_id))))
    return Commit(height=height, round=0, block_id=bid, signatures=sigs)


def config2_batch_verify(sizes=(64, 1024, 10_000), device=None,
                         seed: Optional[int] = None) -> dict:
    """Reference seam: crypto/ed25519 BatchVerifier ->
    types/validation.go verifyCommitBatch.  One untimed two-signature
    batch first, so the library's build or load and the device's start
    stay out of the first size's time."""
    from ..crypto import batch, ed25519

    dev = resolve(device)
    keys = _Keys(seed)
    results = {}
    warm = False
    for n in sizes:
        privs = [keys(ed25519) for _ in range(n)]
        items = []
        for i, p in enumerate(privs):
            msg = b"vote-%d" % i
            items.append((p.pub_key(), msg, p.sign(msg)))
        if not warm:
            bv = batch.create_batch_verifier(items[0][0], dev)
            for pub, msg, sig in items[:2]:
                bv.add(pub, msg, sig)
            bv.verify()
            warm = True
        bv = batch.create_batch_verifier(items[0][0], dev)
        for pub, msg, sig in items:
            bv.add(pub, msg, sig)
        t0 = _now()
        ok, mask = bv.verify()
        dt = (_now() - t0) * 1000
        if not (ok and all(mask)):
            raise AssertionError(
                f"config 2: {list(mask).count(False)} of {n} signatures "
                f"rejected")
        results[str(n)] = dt
    return {"config": 2, "metric": "batch_verify_ms_by_size",
            "backend": _backend(dev), "device": _device_name(dev),
            "results_ms": results}


def config3_light_client(n_vals=1000, hops=4, device=None,
                         seed: Optional[int] = None) -> dict:
    """Reference: light/verifier.go VerifyNonAdjacent with a large
    validator set (BASELINE config #3: a 1k-validator SignedHeader
    chain)."""
    from ..crypto import ed25519
    from ..light.verifier import DEFAULT_TRUST_LEVEL, verify
    from ..types.block import Header, SignedHeader
    from ..types.block_id import BlockID
    from ..types.part_set import PartSetHeader
    from ..types.timestamp import Timestamp

    dev = resolve(device)
    keys = _Keys(seed)
    chain_id = "light-bench"
    vset, privs = _make_valset([keys(ed25519) for _ in range(n_vals)])

    def signed_header(height: int) -> SignedHeader:
        hdr = Header(chain_id=chain_id, height=height,
                     time=Timestamp(1700000000 + height, 0),
                     validators_hash=vset.hash(),
                     next_validators_hash=vset.hash(),
                     proposer_address=vset.validators[0].address)
        bid = BlockID(hash=hdr.hash(),
                      part_set_header=PartSetHeader(1, b"\x11" * 32))
        return SignedHeader(
            header=hdr,
            commit=_signed_commit(chain_id, vset, privs, height, bid))

    trusted = signed_header(1)
    targets = [signed_header(1 + 10 * (i + 1)) for i in range(hops)]
    now = Timestamp(1700000600, 0)
    t0 = _now()
    for sh in targets:
        verify(trusted, vset, sh, vset, 365 * 24 * 3600 * 10 ** 9, now,
               10 ** 9, DEFAULT_TRUST_LEVEL, device=dev)
    dt = (_now() - t0) * 1000
    return {"config": 3, "metric": "light_skipping_verify_ms_per_hop",
            "device": _device_name(dev), "validators": n_vals,
            "hops": hops,
            "value_ms": dt / hops}


def config4_replay_tally(n_vals=150, heights=10, device=None,
                         seed: Optional[int] = None) -> dict:
    """Reference: the per-height VoteSet tally (vote_set.go AddVote with
    its per-vote verify, on the host) and the Commit verify (BASELINE
    config #4's hot work, without the disk WAL)."""
    from ..crypto import ed25519
    from ..types import canonical
    from ..types.block_id import BlockID
    from ..types.part_set import PartSetHeader
    from ..types.timestamp import Timestamp
    from ..types.validation import verify_commit
    from ..types.vote import Vote
    from ..types.vote_set import VoteSet

    dev = resolve(device)
    keys = _Keys(seed)
    chain_id = "replay-bench"
    vset, privs = _make_valset([keys(ed25519) for _ in range(n_vals)])

    tally_ms = []
    commit_ms = []
    for h in range(1, heights + 1):
        bid = BlockID(hash=bytes([h]) * 32,
                      part_set_header=PartSetHeader(1, b"\x07" * 32))
        votes = []
        for i, (val, priv) in enumerate(zip(vset.validators, privs)):
            ts = Timestamp(1700000000 + h, i)
            v = Vote(type=canonical.PRECOMMIT_TYPE, height=h, round=0,
                     block_id=bid, timestamp=ts,
                     validator_address=val.address, validator_index=i)
            v.signature = priv.sign(v.sign_bytes(chain_id))
            votes.append(v)
        vs = VoteSet(chain_id, h, 0, canonical.PRECOMMIT_TYPE, vset)
        t0 = _now()
        for v in votes:
            vs.add_vote(v)
        tally_ms.append((_now() - t0) * 1000)
        commit = vs.make_extended_commit().to_commit()
        t0 = _now()
        verify_commit(chain_id, vset, bid, h, commit, device=dev)
        commit_ms.append((_now() - t0) * 1000)
    return {"config": 4, "metric": "replay_per_height_ms",
            "device": _device_name(dev), "validators": n_vals,
            "heights": heights,
            "tally_ms_p50": sorted(tally_ms)[len(tally_ms) // 2],
            "commit_verify_ms_p50": sorted(commit_ms)[len(commit_ms) // 2]}


def config5_mixed_stress(n_vals=1000, n_bls=64, device=None,
                         seed: Optional[int] = None) -> dict:
    """Reference: BASELINE config #5, a mixed-key commit verify (the
    ed25519 group on the kernel, the BLS group in the host BLS library,
    secp256k1 keys one by one) and a bls12381 aggregate verify."""
    from ..crypto import bls12381, ed25519, secp256k1
    from ..types.block_id import BlockID
    from ..types.part_set import PartSetHeader
    from ..types.validation import verify_commit

    dev = resolve(device)
    keys = _Keys(seed)
    chain_id = "stress-bench"
    privs = []
    for i in range(n_vals):
        if i % 3 == 0:
            privs.append(keys(secp256k1))
        elif i % 7 == 0:
            privs.append(bls12381.gen_priv_key_from_secret(b"bench-%d" % i))
        else:
            privs.append(keys(ed25519))
    vset, privs = _make_valset(privs)
    if vset.all_keys_have_same_type():
        raise AssertionError("config 5: the validator set is not mixed")
    bid = BlockID(hash=b"\x55" * 32,
                  part_set_header=PartSetHeader(1, b"\x66" * 32))
    commit = _signed_commit(chain_id, vset, privs, 9, bid)
    t0 = _now()
    verify_commit(chain_id, vset, bid, 9, commit, device=dev)
    mixed_ms = (_now() - t0) * 1000

    # bls aggregate: n_bls distinct messages, one aggregate signature
    bls_privs = [bls12381.gen_priv_key_from_secret(b"agg-%d" % i)
                 for i in range(n_bls)]
    msgs = [b"block-%d" % i for i in range(n_bls)]
    agg = bls12381.aggregate_signatures(
        [p.sign(m) for p, m in zip(bls_privs, msgs)])
    pks = [p.pub_key() for p in bls_privs]
    t0 = _now()
    ok = bls12381.aggregate_verify(pks, msgs, agg)
    bls_ms = (_now() - t0) * 1000
    if not ok:
        raise AssertionError("config 5: the BLS aggregate did not verify")
    return {"config": 5, "metric": "mixed_stress",
            "device": _device_name(dev),
            "validators": n_vals, "bls_aggregate_size": n_bls,
            "mixed_commit_verify_ms": mixed_ms,
            "bls_aggregate_verify_ms": bls_ms}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="BASELINE benchmark configs #2-#5")
    ap.add_argument("--config", type=int, default=0,
                    choices=[0, 2, 3, 4, 5],
                    help="run a single config (2-5); 0 = all. Config #1 "
                         "(live testnet) is tools/manifest.py + "
                         "`cometbft_tpu_torch.cmd load`.")
    ap.add_argument("--full", action="store_true",
                    help="BASELINE sizes (1k light valset, 10k batch)")
    ap.add_argument("--device", default="",
                    help="torch device to verify on (default: the card; "
                         "'cpu' runs the plain version)")
    args = ap.parse_args(argv)
    device = resolve(args.device or None)
    runs = {
        2: lambda: config2_batch_verify(
            (64, 1024, 10_000) if args.full else (64, 256), device),
        3: lambda: config3_light_client(
            1000 if args.full else 100, device=device),
        4: lambda: config4_replay_tally(
            150, 10 if args.full else 3, device=device),
        5: lambda: config5_mixed_stress(
            10_000 if args.full else 200, 256 if args.full else 16,
            device=device),
    }
    for n, fn in runs.items():
        if args.config in (0, n):
            print(json.dumps(fn()), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
