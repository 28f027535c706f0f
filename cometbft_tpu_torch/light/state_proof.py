"""Verified-header state proofs: the light client's end of the chain
``header.app_hash -> state tree root -> key/value``.

The port's copy of cometbft_tpu/light/state_proof.py.  The light client
(client.py, on B1) establishes trust in a header; this module spends
that trust on an ``abci_query_batch`` proof envelope.  The binding is
height-exact: the header at height H commits the app state after block
H-1, so an envelope proven at tree version V verifies against the header
at V+1 (``proof["header_height"]``) and nothing else.  A proof of a
stale version, however consistent, fails the app_hash comparison here.
"""
from __future__ import annotations

from typing import Iterable

from ..statetree import verify_proof_envelope


def verify_state_proof(verified_header, proof: dict,
                       present: Iterable[tuple[bytes, bytes]] = (),
                       absent: Iterable[bytes] = ()) -> None:
    """Check a proof envelope against a consensus-verified header:
    every (key, value) in ``present`` exists and every key in
    ``absent`` does not, in the state the header's app_hash commits.
    ``verified_header`` is a types.block.Header the caller already
    verified (light.verify / verify_adjacent / verify_non_adjacent)
    — this function takes the header, never a bare root, so the
    trust chain cannot be short-circuited.  Raises ValueError on any
    mismatch."""
    if "header_height" not in proof:
        raise ValueError(
            "proof envelope has no header binding (pre-statetree "
            "server?) — cannot chain to a verified header")
    if int(proof["header_height"]) != verified_header.height:
        raise ValueError(
            f"proof targets header height {proof['header_height']}, "
            f"verified header is {verified_header.height}")
    verify_proof_envelope(proof, present=present, absent=absent,
                          expected_root=verified_header.app_hash)
