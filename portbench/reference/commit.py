"""The plain reference of CometBFT's VerifyCommit (types/validation.go),
for a commit whose validators all hold ed25519 keys.

It works from the benchmark's inputs alone: the validators' public keys
and powers in the set's order, and each slot's flag, timestamp and
signature.  It encodes the sign bytes again (``sign_bytes``), checks
every present signature, not stopping at 2/3, and passes no signature
cache.  A signature is valid if OpenSSL's strict RFC 8032 check accepts
it, which implies ZIP-215's check accepts it; one that OpenSSL refuses
goes to the plain ZIP-215 check (``zip215``), so the verdict is
ZIP-215's on every input.

The verdict is what VerifyCommit returns, in the order it checks:
``("power", tallied, needed)`` when the present signatures carry no
more than 2/3 of the power, else ``("bad_sig", i)`` for the lowest slot
whose signature is invalid, else ``("ok",)``.

Imports nothing of the program under test.
"""
from __future__ import annotations

import hashlib

from cryptography.exceptions import InvalidSignature
from cryptography.hazmat.primitives.asymmetric.ed25519 import \
    Ed25519PublicKey

from . import sign_bytes, zip215


def address(pub: bytes) -> bytes:
    """A validator's address: the first 20 bytes of SHA-256 of its key."""
    return hashlib.sha256(pub).digest()[:20]


def signature_ok(pub: bytes, msg: bytes, sig: bytes) -> bool:
    try:
        Ed25519PublicKey.from_public_bytes(pub).verify(sig, msg)
        return True
    except (InvalidSignature, ValueError):
        return zip215.verify(pub, msg, sig)


def check_signatures(jobs) -> list[bool]:
    """[(pub, msg, sig), ...] -> one verdict each (a pool's task)."""
    return [signature_ok(*job) for job in jobs]


def slot_messages(chain_id: str, height) -> list:
    """The sign bytes of each slot of ``height`` (a generator.Height),
    None for an absent slot."""
    bid = sign_bytes.block_id(height.block_hash, height.psh_total,
                              height.psh_hash)
    make = sign_bytes.vote_template(chain_id, sign_bytes.PRECOMMIT,
                                    height.height, height.round, bid)
    return [None if sig is None else make(sec, nanos)
            for (sec, nanos), sig in zip(height.stamps, height.sigs)]


def verdict(powers, sigs, oks) -> tuple:
    """VerifyCommit's verdict from the powers in the set's order, the
    slots' signatures (None = absent) and the present ones' checks."""
    total = sum(powers)
    needed = total * 2 // 3
    tallied = sum(p for p, s in zip(powers, sigs) if s is not None)
    if tallied <= needed:
        return ("power", tallied, needed)
    it = iter(oks)
    for i, sig in enumerate(sigs):
        if sig is not None and not next(it):
            return ("bad_sig", i)
    return ("ok",)


def verdicts(chain_id: str, validators, heights, pool=None,
             chunk: int = 2048) -> list[tuple]:
    """The verdict of every commit in ``heights``; ``validators`` is
    [(pub, power), ...] in the set's order.  The signature checks run in
    ``pool`` (a multiprocessing pool) when one is given."""
    pubs = [pub for pub, _ in validators]
    powers = [power for _, power in validators]
    jobs, spans = [], []
    for h in heights:
        msgs = slot_messages(chain_id, h)
        lo = len(jobs)
        jobs.extend((pub, msg, sig) for pub, msg, sig in
                    zip(pubs, msgs, h.sigs) if sig is not None)
        spans.append((lo, len(jobs)))
    chunks = [jobs[i:i + chunk] for i in range(0, len(jobs), chunk)]
    mapped = pool.map(check_signatures, chunks) if pool is not None \
        else [check_signatures(c) for c in chunks]
    oks = [ok for part in mapped for ok in part]
    return [verdict(powers, h.sigs, oks[lo:hi])
            for h, (lo, hi) in zip(heights, spans)]
