"""Proof envelopes: existence and non-inclusion under one multiproof.

The port's copy of cometbft_tpu/statetree/proof.py.  The tree commits
sorted, unique keys, so absence is an adjacency claim: key K is absent
from version V iff two leaves ADJACENT in V's sorted leaf array straddle
it (key[i] < K < key[i+1]), or K falls off one end, or the tree is
empty.  One compact ``Multiproof`` (crypto/merkle.py) covers the present
keys and every absent key's neighbours, against the tree root, which is
the kvstore's app hash: the envelope of version V verifies against the
``app_hash`` of the header at V + 1.

Envelope (JSON-ready; int64s as strings per RPC convention):

  {
    "version": "7",          # tree version the proof is against
    "header_height": "8",    # the header whose app_hash == root
    "root": "AB12..",        # hex-upper tree root
    "total": "5",            # leaves in the tree at that version
    "indices": [0, 2, 3],    # proven leaf positions (sorted unique)
    "keys": [..], "values": [..],   # hex, aligned with indices
    "absent": [{"key": hex, "left": int|null, "right": int|null}],
    "missing": [hex..],      # the absent keys again
    "multiproof": {"total", "indices", "aunts"},
  }

A neighbour swap fails the adjacency and order checks, a range-gap
forgery fails right == left + 1 against the proven indices, and a proof
of a stale version fails the root comparison against the newer header's
app hash.
"""
from __future__ import annotations

import bisect
from typing import Iterable, Optional, Sequence

from ..crypto import merkle


def build_proof_envelope(request_keys: Sequence[bytes],
                         keys: Sequence[bytes],
                         values: Sequence[bytes],
                         leaf_hashes: Sequence[bytes],
                         index_of: dict,
                         version: int) -> dict:
    """Build the envelope for ``request_keys`` against the sorted
    committed view (keys/values/leaf_hashes aligned)."""
    prove: set[int] = set()
    absent: list[dict] = []
    missing: list[str] = []
    for k in request_keys:
        i = index_of.get(k)
        if i is not None:
            prove.add(i)
            continue
        missing.append(k.hex())
        j = bisect.bisect_left(keys, k)
        left = j - 1 if j > 0 else None
        right = j if j < len(keys) else None
        if left is not None:
            prove.add(left)
        if right is not None:
            prove.add(right)
        absent.append({"key": k.hex(), "left": left, "right": right})
    root, mp = merkle.multiproof_from_leaf_hashes(
        list(leaf_hashes), sorted(prove))
    return {
        "version": str(version),
        "header_height": str(version + 1),
        "root": root.hex().upper(),
        "total": str(len(keys)),
        "indices": list(mp.indices),
        "keys": [keys[i].hex() for i in mp.indices],
        "values": [values[i].hex() for i in mp.indices],
        "absent": absent,
        "missing": missing,
        "multiproof": mp.to_dict(),
    }


def verify_proof_envelope(proof: dict,
                          present: Iterable[tuple[bytes, bytes]] = (),
                          absent: Iterable[bytes] = (),
                          expected_root: Optional[bytes] = None) -> None:
    """Client-side check of a proof envelope: every (key, value) in
    ``present`` exists at the proven version, every key in ``absent``
    does not.  ``expected_root`` is the trusted commitment — with
    header chaining it is the verified header's app_hash; without it
    the envelope's own root is used.  Raises ValueError on any
    mismatch."""
    root = bytes.fromhex(proof["root"])
    if expected_root is not None and root != expected_root:
        raise ValueError(
            "proof root does not match the verified commitment "
            "(stale version or forged envelope)")
    total = int(proof["total"])
    indices = list(proof["indices"])
    keys = [bytes.fromhex(k) for k in proof["keys"]]
    values = [bytes.fromhex(v) for v in proof["values"]]
    if not (len(indices) == len(keys) == len(values)):
        raise ValueError("proof keys/values/indices misaligned")
    mp = merkle.Multiproof.from_dict(proof["multiproof"])
    if mp.total != total or mp.indices != indices:
        raise ValueError("proof indices do not match multiproof")
    # the one hash check: binds every (key, value) to its leaf
    # position under the root
    mp.verify(root, [merkle.value_op_leaf(k, v)
                     for k, v in zip(keys, values)])
    # the tree commits sorted-unique keys; a proof whose proven keys
    # are not strictly increasing cannot come from a well-formed tree
    # and its adjacency claims would be meaningless
    for a, b in zip(keys, keys[1:]):
        if a >= b:
            raise ValueError("proven keys not strictly increasing")
    index_pos = {idx: n for n, idx in enumerate(indices)}
    proven_keys = set(keys)

    by_value = {}
    for k, v in zip(keys, values):
        by_value[k] = v
    for k, v in present:
        got = by_value.get(k)
        if got is None:
            raise ValueError(f"key {k.hex()} not covered by proof")
        if got != v:
            raise ValueError(f"value mismatch for key {k.hex()}")

    arms = {a["key"]: a for a in proof.get("absent", [])}
    for k in absent:
        if k in proven_keys:
            raise ValueError(
                f"key {k.hex()} claimed absent but proven present")
        arm = arms.get(k.hex())
        if arm is None:
            raise ValueError(f"no non-inclusion arm for {k.hex()}")
        left, right = arm["left"], arm["right"]
        if left is None and right is None:
            if total != 0:
                raise ValueError(
                    "empty-tree absence claim on non-empty tree")
            continue
        if left is None:
            # K precedes every key: the proven leaf 0 must exceed it
            if right != 0:
                raise ValueError("left-edge absence needs leaf 0")
            rk = _arm_key(right, index_pos, keys)
            if not k < rk:
                raise ValueError("left-edge absence order violated")
            continue
        if right is None:
            if left != total - 1:
                raise ValueError(
                    "right-edge absence needs the last leaf")
            lk = _arm_key(left, index_pos, keys)
            if not lk < k:
                raise ValueError("right-edge absence order violated")
            continue
        if right != left + 1:
            raise ValueError(
                "absence neighbors not adjacent (range-gap forgery)")
        lk = _arm_key(left, index_pos, keys)
        rk = _arm_key(right, index_pos, keys)
        if not (lk < k < rk):
            raise ValueError(
                "absent key not inside the neighbor gap "
                "(neighbor-swap forgery)")


def _arm_key(idx: int, index_pos: dict, keys: list) -> bytes:
    n = index_pos.get(idx)
    if n is None:
        raise ValueError(
            f"absence arm references unproven leaf {idx}")
    return keys[n]
