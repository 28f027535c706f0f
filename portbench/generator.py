"""The benchmark's generator of commits: a pool of signed commits made
from a configuration, a traffic mix and a seed, for the drivers that
call the program with commits.

A configuration (``configs/<name>.json``) gives the deployment: the
chain id, the number of validators, their key type and power.  A traffic
mix (``traffic/<name>.json``) gives the pool: how many heights, and for
each height that carries one wrong signature the part of the set its
slot is drawn from (``bad_heights``: ``[from_share, to_share]`` of the
validators).  The seed draws the keys, the block ids, every vote's own
timestamp, which heights are bad, each bad slot inside its part and the
call order; the sizes are the same for every seed.

The benchmark signs with its own signer (OpenSSL through
``cryptography``), never the program's, over the sign bytes that
``reference.sign_bytes`` encodes.  A wrong signature is a valid
signature by the slot's validator over the vote with its timestamp one
nanosecond later, so it fails the check without being malformed.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

import numpy as np
from cryptography.hazmat.primitives.asymmetric.ed25519 import \
    Ed25519PrivateKey

from .reference import commit as ref_commit
from .reference import sign_bytes

# block time of the first pool height; each later height is 6 s on
T0_SECONDS = 1_700_000_000
BLOCK_INTERVAL_S = 6


@dataclass
class Height:
    """One commit: its height, round and block id, and for each slot of
    the set (in the set's order) the vote's timestamp and signature
    (None = absent)."""
    height: int
    round: int
    block_hash: bytes
    psh_total: int
    psh_hash: bytes
    stamps: list
    sigs: list


@dataclass
class Inputs:
    """What a cell's run hands to the program and to the reference."""
    chain_id: str
    validators: list        # [(pub, power), ...] in the set's order
    addresses: list         # each validator's address, same order
    heights: list           # [Height, ...]: the pool
    order: list             # pool index of call i is order[i % len(order)]
    signed: int             # signatures made
    reference: str          # the configuration's reference module


def key_seed(seed: int, i: int) -> bytes:
    return hashlib.sha256(b"portbench/key/%d/%d" % (seed, i)).digest()


def _sign_chunk(job):
    """Worker: (key seeds, [messages of each height]) -> (public keys,
    [signatures of each height])."""
    seeds, msgs_by_height = job
    keys = [Ed25519PrivateKey.from_private_bytes(s) for s in seeds]
    pubs = [k.public_key().public_bytes_raw() for k in keys]
    return pubs, [[k.sign(m) for k, m in zip(keys, msgs)]
                  for msgs in msgs_by_height]


def start_inputs(config: dict, traffic: dict, seed: int, pool=None):
    """The pool of commits of ``config`` under ``traffic`` for ``seed``,
    in two steps: this one encodes every vote and hands the signing to
    ``pool`` (a multiprocessing pool, or None to sign here)
    without waiting for it; the function it returns waits, orders the
    set, plants the wrong signatures and returns the ``Inputs``."""
    if config.get("key_type", "ed25519") != "ed25519":
        raise ValueError(f"key type {config['key_type']!r}: only ed25519")
    n = int(config["validators"])
    chain_id = config["chain_id"]
    n_heights = int(traffic["pool_heights"])
    rng = np.random.default_rng([seed, 1])
    base = int(rng.integers(1, 10_000_000))
    psh_total = int(rng.integers(1, 100))
    round_ = int(traffic.get("round", 0))

    heights, msgs_by_height = [], []
    for k in range(n_heights):
        h = base + k
        block_hash = hashlib.sha256(b"portbench/block/%d/%d"
                                    % (seed, h)).digest()
        psh_hash = hashlib.sha256(b"portbench/parts/%d/%d"
                                  % (seed, h)).digest()
        sec = T0_SECONDS + k * BLOCK_INTERVAL_S
        stamps = [(sec, int(x)) for x in rng.integers(0, 10 ** 9, n)]
        make = sign_bytes.vote_template(
            chain_id, sign_bytes.PRECOMMIT, h, round_,
            sign_bytes.block_id(block_hash, psh_total, psh_hash))
        msgs_by_height.append([make(s, ns) for s, ns in stamps])
        heights.append(Height(h, round_, block_hash, psh_total, psh_hash,
                              stamps, None))

    seeds = [key_seed(seed, i) for i in range(n)]
    if pool is not None:
        step = -(-n // (4 * getattr(pool, "_processes", 4)))
        jobs = [(seeds[lo:lo + step], [m[lo:lo + step]
                                       for m in msgs_by_height])
                for lo in range(0, n, step)]
        pending = pool.map_async(_sign_chunk, jobs)
        get_parts = pending.get
    else:
        parts = [_sign_chunk((seeds, msgs_by_height))]
        get_parts = lambda: parts  # noqa: E731
    return lambda: _finish(config, heights, seeds, get_parts(), traffic, rng)


def _finish(config, heights, seeds, parts, traffic, rng) -> Inputs:
    chain_id, n = config["chain_id"], int(config["validators"])
    power = int(config["voting_power"])
    n_heights = len(heights)
    pubs = [p for part in parts for p in part[0]]
    sigs = [[s for part in parts for s in part[1][k]]
            for k in range(n_heights)]

    # the set's order: power descending, then address ascending
    addrs = [ref_commit.address(p) for p in pubs]
    order = sorted(range(n), key=lambda g: (-power, addrs[g]))
    for k, h in enumerate(heights):
        h.stamps = [h.stamps[g] for g in order]
        h.sigs = [sigs[k][g] for g in order]

    bad = traffic.get("bad_heights", [])
    picked = rng.choice(n_heights, len(bad), replace=False).tolist()
    for k, (lo, hi) in zip(picked, bad):
        first, last = int(float(lo) * n), int(float(hi) * n)
        slot = min(n - 1, first + int(rng.integers(0, max(1, last - first))))
        h = heights[k]
        sec, ns = h.stamps[slot]
        make = sign_bytes.vote_template(
            chain_id, sign_bytes.PRECOMMIT, h.height, h.round,
            sign_bytes.block_id(h.block_hash, h.psh_total, h.psh_hash))
        key = Ed25519PrivateKey.from_private_bytes(seeds[order[slot]])
        h.sigs[slot] = key.sign(make(sec, (ns + 1) % 10 ** 9))

    return Inputs(
        chain_id=chain_id,
        validators=[(pubs[g], power) for g in order],
        addresses=[addrs[g] for g in order],
        heights=heights,
        order=rng.permutation(n_heights).tolist(),
        signed=n * n_heights + len(bad),
        reference=config["reference"])
