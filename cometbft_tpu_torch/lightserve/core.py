"""Proof-serving RPC method bodies.

The port's copy of cometbft_tpu/lightserve/core.py: the handlers behind
the ``light_block``, ``multiproof`` and ``abci_query_batch`` routes of
rpc/core.py, with the same JSON (int64s as strings, hashes hex-upper, tx
bytes base64) and the same error codes and texts.

One departure: ``verify_kv_multiproof`` refuses an envelope without the
state tree's header binding when the caller passes a
``verified_header``.  The JAX function then checks the envelope against
its own root and ignores the header, so a proof would pass unchained.
"""
from __future__ import annotations

import base64
import json

from ..crypto import merkle

# ABCI query path of the batched, proven key lookup.  Apps with a
# provable state tree serve it (the kvstore does); an app without one
# answers it with a non-OK code, and the route then answers key by key
# without a proof.
MULTISTORE_PATH = "/multistore"


def _rpc_error(code: int, message: str):
    from ..rpc.server import RPCError
    return RPCError(code, message)


def parse_indices(indices) -> list[int]:
    """A comma-separated index list URI/JSON param ("0,5,17"); lists
    of ints pass through.  Empty string = empty key set."""
    if isinstance(indices, (list, tuple)):
        return [int(i) for i in indices]
    s = str(indices).strip()
    if not s:
        return []
    try:
        return [int(p) for p in s.split(",") if p.strip() != ""]
    except ValueError:
        raise _rpc_error(-32602, f"invalid indices {indices!r}")


# ---------------------------------------------------------------------------
# light_block: one response per skipping-sync hop


async def light_block(env, height) -> dict:
    """Signed header and validator set in one round trip, the unit of
    skipping verification (reference: the statesync LightBlock proto;
    without it the HTTP provider stitches /commit and /validators)."""
    from ..rpc import core as rpc_core
    from ..types import genesis as genesis_types
    h = rpc_core._normalize_height(env, height)
    meta = env.block_store.load_block_meta(h)
    commit = env.block_store.load_block_commit(h)
    if commit is None:
        commit = env.block_store.load_seen_commit(h)
    if meta is None or commit is None:
        raise _rpc_error(-32603, f"no light block at height {h}")
    vals = env.state_store.load_validators(h)
    if vals is None:
        raise _rpc_error(-32603, f"no validator set at height {h}")
    return {
        "height": str(h),
        "light_block": {
            "signed_header": {
                "header": rpc_core._header_json(meta.header),
                "commit": rpc_core._commit_json(commit),
            },
            "validator_set": {
                "validators": [
                    {"address": v.address.hex().upper(),
                     "pub_key": genesis_types.pub_key_to_json(v.pub_key),
                     "voting_power": str(v.voting_power),
                     "proposer_priority": str(v.proposer_priority)}
                    for v in vals.validators],
                "total": str(vals.size()),
            },
        },
    }


# ---------------------------------------------------------------------------
# multiproof: many txs of one block under one compact proof


async def tx_multiproof(env, height, indices) -> dict:
    """Compact multiproof that the txs at ``indices`` are the block's
    txs at those positions, against the header's data_hash.  A light
    client that verified the header checks the whole batch with
    Multiproof.verify over the tx digests (the tree's items, as
    types/tx.py txs_hash makes them)."""
    from ..rpc import core as rpc_core
    from ..types.tx import hash_each
    h = rpc_core._normalize_height(env, height)
    block = env.block_store.load_block(h)
    if block is None:
        raise _rpc_error(-32603, f"block at height {h} not found")
    txs = block.data.txs
    idx = parse_indices(indices)
    if idx and (min(idx) < 0 or max(idx) >= len(txs)):
        raise _rpc_error(
            -32602,
            f"tx index out of range [0, {len(txs)}) at height {h}")
    # data_hash is the merkle root over the per-tx sha256 digests: the
    # digests are the tree's items, leaf-hashed on the way in
    root, mp = merkle.multiproof_from_byte_slices(hash_each(txs), idx)
    return {
        "height": str(h),
        "total": str(len(txs)),
        "indices": mp.indices,
        "data_hash": root.hex().upper(),
        "txs": [base64.b64encode(txs[i]).decode() for i in mp.indices],
        "multiproof": mp.to_dict(),
    }


# ---------------------------------------------------------------------------
# abci_query_batch: many app keys per round trip


def _query_json(res) -> dict:
    return {
        "code": res.code, "log": res.log, "info": res.info,
        "index": str(res.index),
        "key": base64.b64encode(res.key).decode(),
        "value": base64.b64encode(res.value).decode(),
        "height": str(res.height), "codespace": res.codespace,
    }


def _parse_keys(data) -> list[bytes]:
    from ..rpc.core import _decode_hex_or_str
    if isinstance(data, (list, tuple)):
        return [_decode_hex_or_str(d) for d in data]
    s = str(data)
    return [_decode_hex_or_str(type(data)(p))
            for p in s.split(",") if p != ""]


async def abci_query_batch(env, path, data, height, prove) -> dict:
    """N abci_query calls in one response.  With prove=true the app is
    asked once, on MULTISTORE_PATH, for all keys and one compact
    multiproof over its state tree (existence for present keys,
    non-inclusion arms for absent ones), whose root is the app_hash of
    the header at proof.header_height.  Apps without a provable store
    answer key by key with proof=null."""
    from ..abci import types as abci
    from ..rpc.core import _parse_bool
    keys = _parse_keys(data)
    if not keys:
        raise _rpc_error(-32602, "no keys provided")
    try:
        h = int(height)
    except (TypeError, ValueError):
        raise _rpc_error(-32602, f"invalid height {height!r}")
    if _parse_bool(prove):
        req = json.dumps(
            {"keys": [k.hex() for k in keys]}).encode()
        res = await env.node.app_conns.query.query(abci.QueryRequest(
            data=req, path=MULTISTORE_PATH, height=h, prove=True))
        if res.code == 0 and res.value:
            return _batch_from_multistore(keys, res)
    responses = []
    for k in keys:
        res = await env.node.app_conns.query.query(abci.QueryRequest(
            data=k, path=str(path), height=h, prove=False))
        responses.append(_query_json(res))
    return {"responses": responses, "proof": None}


def _batch_from_multistore(keys: list[bytes], res) -> dict:
    """Shape the app's one-shot multistore answer: per-key responses
    (preserving request order) + the shared proof envelope."""
    st = json.loads(res.value)
    found = {bytes.fromhex(k): bytes.fromhex(v)
             for k, v in zip(st["keys"], st["values"])}
    responses = []
    for k in keys:
        v = found.get(k)
        responses.append({
            "code": 0,
            "log": "exists" if v is not None else "does not exist",
            "info": "", "index": "-1",
            "key": base64.b64encode(k).decode(),
            "value": base64.b64encode(v or b"").decode(),
            "height": str(res.height), "codespace": "",
        })
    proof = {
        "root": st["root"].upper(),
        "total": str(st["total"]),
        "indices": list(st["indices"]),
        "missing": list(st.get("missing", [])),
        "multiproof": st["multiproof"],
    }
    # the state tree envelope's extras: the version and header binding,
    # the leaves and the non-inclusion arms that verify_kv_multiproof
    # and light.state_proof.verify_state_proof check
    for field in ("version", "header_height", "keys", "values",
                  "absent"):
        if field in st:
            proof[field] = st[field]
    return {"responses": responses, "proof": proof}


def verify_kv_multiproof(proof: dict, keys_values: list,
                         absent_keys: list = (),
                         verified_header=None) -> None:
    """Client-side check of an abci_query_batch proof envelope:
    every (key, value) in ``keys_values`` exists and every key in
    ``absent_keys`` does not, at the proven version.  Pass the
    ``verified_header`` whose app_hash commits the root (its height
    must equal the proof's header_height) to chain the proof to
    consensus; without it only the envelope's own root is checked
    (membership, not commitment).  An envelope without the header
    binding is refused when a ``verified_header`` is given.  Raises
    ValueError on mismatch."""
    if "keys" in proof:
        from ..statetree import verify_proof_envelope
        expected_root = None
        if verified_header is not None:
            if int(proof["header_height"]) != verified_header.height:
                raise ValueError(
                    f"proof targets header height "
                    f"{proof['header_height']}, verified header is "
                    f"{verified_header.height}")
            expected_root = verified_header.app_hash
        verify_proof_envelope(proof, present=keys_values,
                              absent=absent_keys,
                              expected_root=expected_root)
        return
    # an envelope without the state tree's leaves: the caller gives
    # the leaves in proof index order; absent keys are unprovable here
    if verified_header is not None:
        raise ValueError(
            "proof envelope has no header binding (pre-statetree "
            "server?) — cannot chain to a verified header")
    if absent_keys:
        raise ValueError(
            "proof envelope has no non-inclusion arms")
    mp = merkle.Multiproof.from_dict(proof["multiproof"])
    leaves = [merkle.value_op_leaf(k, v) for k, v in keys_values]
    mp.verify(bytes.fromhex(proof["root"]), leaves)
