"""RPC method implementations.

Reference: rpc/core/ — env.go (the Environment), routes.go (the method
table), {status,blocks,mempool,abci,consensus,net}.go.  JSON shapes
follow the reference's response schemas (hex block hashes, base64 tx
bytes, stringified int64s).

A copy of cometbft_tpu/rpc/core.py: every route answers as the JAX route
does, as JSON, over a node with the same rows.  The routes read the JAX
``Node``'s attribute names (``block_store``, ``state_store``,
``mempool``, ``consensus_state``, ``switch``, ``event_bus``,
``genesis_doc``, ``config``, ``app_conns``, ``tx_indexer``,
``block_indexer``, ``pruner``, ``evidence_pool``, ``status()`` and,
where present, ``consensus_reactor`` / ``blocksync_reactor`` and
``lightserve_cache``), so any holder of them serves.  The lightserve
routes ``light_block``, ``multiproof`` and ``abci_query_batch``
(lightserve/core.py) and ``block`` and ``commit`` go through
``_cached``: a holder with a ``lightserve_cache`` serves their answers
below the tip from memory.  ``tx_search`` and ``block_search`` page
over every match, as the reference does, where the JAX routes stop at
the indexer's first 100.  A height the block store has pruned is never
served from the cache: it is answered from the stores, with their
error, as the reference (which has no cache) answers it; the JAX
``_cached`` serves it from the cache.
"""
from __future__ import annotations

import base64

from ..abci import types as abci
from ..mempool.mempool import InvalidTxError, MempoolError, TxInCacheError
from ..types import genesis
from ..types.tx import tx_hash


class Environment:
    """Reference: rpc/core/env.go — references into the node."""

    def __init__(self, node):
        self.node = node

    @property
    def block_store(self):
        return self.node.block_store

    @property
    def state_store(self):
        return self.node.state_store

    @property
    def mempool(self):
        return self.node.mempool

    @property
    def consensus(self):
        return self.node.consensus_state


def routes(env: Environment) -> dict:
    """Reference: rpc/core/routes.go:15."""
    return {
        "health": lambda: _health(env),
        "status": lambda: _status(env),
        "net_info": lambda: _net_info(env),
        "genesis": lambda: _genesis(env),
        "genesis_chunked": lambda chunk="0":
            _genesis_chunked(env, chunk),
        "abci_info": lambda: _abci_info(env),
        "abci_query": lambda path="", data="", height="0",
        prove=False: _abci_query(env, path, data, height, prove),
        "broadcast_tx_sync": lambda tx="":
            _broadcast_tx_sync(env, tx),
        "broadcast_tx_async": lambda tx="":
            _broadcast_tx_async(env, tx),
        "broadcast_tx_commit": lambda tx="":
            _broadcast_tx_commit(env, tx),
        "unconfirmed_txs": lambda limit="30":
            _unconfirmed_txs(env, limit),
        "num_unconfirmed_txs": lambda: _num_unconfirmed_txs(env),
        "block": lambda height="0": _block(env, height),
        "block_by_hash": lambda hash="": _block_by_hash(env, hash),
        # lightserve: the proof-serving read surface (lightserve/)
        "light_block": lambda height="0": _light_block(env, height),
        "multiproof": lambda height="0", indices="":
            _multiproof(env, height, indices),
        "abci_query_batch": lambda path="", data="", height="0",
        prove=False: _abci_query_batch(env, path, data, height, prove),
        "header": lambda height="0": _header(env, height),
        "header_by_hash": lambda hash="":
            _header_by_hash(env, hash),
        "check_tx": lambda tx="": _check_tx(env, tx),
        "unconfirmed_tx": lambda hash="":
            _unconfirmed_tx(env, hash),
        "block_results": lambda height="0": _block_results(env, height),
        "commit": lambda height="0": _commit(env, height),
        "blockchain": lambda minHeight="0", maxHeight="0":
            _blockchain(env, minHeight, maxHeight),
        "validators": lambda height="0", page="1", per_page="30":
            _validators(env, height, page, per_page),
        "consensus_state": lambda: _consensus_state(env),
        "dump_consensus_state": lambda:
            _dump_consensus_state(env),
        # flight recorder (libs/tracing.py): the per-height span
        # timeline every perf PR is judged with
        "trace": lambda height="0", category="", limit="0":
            _trace(env, height, category, limit),
        "consensus_params": lambda height="0":
            _consensus_params(env, height),
        "tx": lambda hash="", prove=False: _tx(env, hash),
        "tx_search": lambda query="", page="1", per_page="30",
        order_by="asc": _tx_search(env, query, page, per_page),
        "block_search": lambda query="", page="1", per_page="30",
        order_by="asc": _block_search(env, query, page, per_page),
        "broadcast_evidence": lambda evidence="":
            _broadcast_evidence(env, evidence),
        # data-companion pruning service (reference: rpc/grpc/server/
        # services/pruningservice — served here over JSON-RPC, the
        # engine's single RPC surface)
        "pruning_set_block_retain_height": lambda height="0":
            _pruning_set_retain(env, height),
        "pruning_get_block_retain_height": lambda:
            _pruning_get_retain(env),
        # control API — served only with rpc.unsafe (reference:
        # routes.go AddUnsafeRoutes); every handler re-checks the
        # config so the gate can't be bypassed by table drift
        "dial_seeds": lambda seeds="":
            _unsafe_dial_seeds(env, seeds),
        "dial_peers": lambda peers="", persistent=False,
        unconditional=False, private=False:
            _unsafe_dial_peers(env, peers, persistent, private),
        "unsafe_flush_mempool": lambda:
            _unsafe_flush_mempool(env),
    }


async def _health(env):
    """Readiness/lag plane (docs/observability.md): what a load
    balancer in front of the replica tier — or the QA soak gates —
    polls instead of scraping Prometheus.  Height lag is measured
    against the best height any peer has advertised (consensus
    round states while in consensus, the blocksync pool while
    syncing); the p95s are computed in-process from the live
    histograms."""
    node = env.node
    height = env.block_store.height
    best_peer = 0
    cr = getattr(node, "consensus_reactor", None)
    if cr is not None:
        for ps in list(cr._peer_states.values()):
            # prs.height is the height the peer is WORKING on; its
            # committed head is one behind
            best_peer = max(best_peer, ps.prs.height - 1)
    catching_up = bool(getattr(cr, "wait_sync", False))
    br = getattr(node, "blocksync_reactor", None)
    if br is not None and br.pool is not None:
        best_peer = max(best_peer, br.pool.max_peer_height())
    lag = max(0, best_peer - height)
    sw = getattr(node, "switch", None)
    n_peers = sw.num_peers() if sw is not None else 0
    mp = getattr(node, "mempool", None)
    barrier_p95 = 0.0
    cs = getattr(node, "consensus_state", None)
    if cs is not None:
        barrier_p95 = cs.metrics \
            .pipeline_barrier_wait_seconds.quantile(0.95)
    loop_lag_p95 = 0.0
    hm = getattr(node, "health_metrics", None)
    if hm is not None:
        loop_lag_p95 = hm.event_loop_lag_seconds.quantile(0.95)
    if catching_up:
        status = "syncing"
    elif lag > 2:
        status = "lagging"
    else:
        status = "ok"
    return {
        "status": status,
        "height": str(height),
        "best_peer_height": str(best_peer),
        "height_lag": str(lag),
        "catching_up": catching_up,
        "n_peers": str(n_peers),
        "mempool_txs": str(mp.size() if mp is not None else 0),
        "mempool_bytes": str(
            mp.size_bytes() if mp is not None else 0),
        "pipeline_barrier_wait_p95_s": round(barrier_p95, 6),
        "event_loop_lag_p95_s": round(loop_lag_p95, 6),
    }


async def _status(env):
    return env.node.status()


async def _net_info(env):
    sw = env.node.switch
    return {
        "listening": bool(sw.listen_addr),
        "listeners": [sw.listen_addr],
        "n_peers": str(sw.num_peers()),
        "peers": [
            {"node_info": {"id": p.id,
                           "moniker": p.node_info.moniker,
                           "network": p.node_info.network},
             "is_outbound": p.outbound,
             "remote_ip": p.remote_addr.rsplit(":", 1)[0]}
            for p in sw.peers.values()
        ],
    }


async def _genesis(env):
    import json as _json
    return {"genesis": _json.loads(env.node.genesis_doc.to_json())}


_GENESIS_CHUNK_SIZE = 16 * 1024 * 1024   # reference: 16 MB chunks


async def _genesis_chunked(env, chunk):
    """Reference: rpc/core/net.go GenesisChunked — the genesis JSON
    split into 16 MB base64 chunks so large genesis docs fit in one
    JSON-RPC response each.  Chunks are computed once per node (the
    genesis doc is immutable) and cached on the environment."""
    from .server import RPCError
    chunks = getattr(env, "_genesis_chunks", None)
    if chunks is None:
        raw = env.node.genesis_doc.to_json().encode()
        chunks = [raw[i:i + _GENESIS_CHUNK_SIZE]
                  for i in range(0, len(raw),
                                 _GENESIS_CHUNK_SIZE)] or [b""]
        env._genesis_chunks = chunks
    try:
        cid = int(chunk)
    except (TypeError, ValueError):
        raise RPCError(-32602, f"invalid chunk id {chunk!r}")
    if cid < 0 or cid >= len(chunks):
        raise RPCError(
            -32603, f"chunk id {cid} out of range [0, {len(chunks)})")
    return {"chunk": str(cid), "total": str(len(chunks)),
            "data": base64.b64encode(chunks[cid]).decode()}


async def _abci_info(env):
    res = await env.node.app_conns.query.info(abci.InfoRequest())
    return {"response": {
        "data": res.data, "version": res.version,
        "app_version": str(res.app_version),
        "last_block_height": str(res.last_block_height),
        "last_block_app_hash": base64.b64encode(
            res.last_block_app_hash).decode(),
    }}


async def _abci_query(env, path, data, height, prove):
    raw = _decode_hex_or_str(data)
    res = await env.node.app_conns.query.query(abci.QueryRequest(
        data=raw, path=path, height=int(height),
        prove=_parse_bool(prove)))
    return {"response": {
        "code": res.code, "log": res.log, "info": res.info,
        "index": str(res.index),
        "key": base64.b64encode(res.key).decode(),
        "value": base64.b64encode(res.value).decode(),
        "height": str(res.height), "codespace": res.codespace,
    }}


def _check_tx_result(tx: bytes, res) -> dict:
    return {
        "code": res.code, "data": base64.b64encode(res.data).decode(),
        "log": res.log, "codespace": res.codespace,
        "hash": tx_hash(tx).hex().upper(),
    }


async def _broadcast_tx_sync(env, tx):
    raw = _decode_tx(tx)
    try:
        res = await env.mempool.check_tx(raw)
    except InvalidTxError as e:
        return {"code": e.code, "data": "", "log": str(e),
                "codespace": "", "hash": tx_hash(raw).hex().upper()}
    except TxInCacheError:
        from .server import RPCError
        raise RPCError(-32603, "tx already exists in cache")
    except MempoolError as e:
        from .server import RPCError
        raise RPCError(-32603, str(e))
    return _check_tx_result(raw, res)


async def _broadcast_tx_async(env, tx):
    import asyncio as _asyncio
    raw = _decode_tx(tx)

    async def _bg():
        try:
            await env.mempool.check_tx(raw)
        except MempoolError:
            pass
    _asyncio.get_running_loop().create_task(_bg())
    return {"code": 0, "data": "", "log": "", "codespace": "",
            "hash": tx_hash(raw).hex().upper()}


async def _broadcast_tx_commit(env, tx):
    """CheckTx, then wait for the tx to land in a block (reference:
    rpc/core/mempool.go BroadcastTxCommit via event subscription)."""
    import asyncio as _asyncio
    raw = _decode_tx(tx)
    key = tx_hash(raw)
    sub = env.node.event_bus.subscribe(
        f"rpc-tx-{key.hex()[:16]}",
        f"tm.event = 'Tx' AND tx.hash = '{key.hex().upper()}'")
    try:
        try:
            check = await env.mempool.check_tx(raw)
        except InvalidTxError as e:
            return {"check_tx": {"code": e.code, "log": str(e)},
                    "tx_result": {}, "hash": key.hex().upper(),
                    "height": "0"}
        timeout = env.node.config.rpc \
            .timeout_broadcast_tx_commit_ns / 1e9
        try:
            msg = await _asyncio.wait_for(sub.next(), timeout)
        except _asyncio.TimeoutError:
            from .server import RPCError
            raise RPCError(-32603,
                           "timed out waiting for tx to be included "
                           "in a block")
        payload = msg.data.payload
        res = payload["result"]
        return {
            "check_tx": _check_tx_result(raw, check),
            "tx_result": {
                "code": res.code,
                "data": base64.b64encode(res.data).decode(),
                "log": res.log,
                "gas_wanted": str(res.gas_wanted),
                "gas_used": str(res.gas_used),
            },
            "hash": key.hex().upper(),
            "height": str(payload["height"]),
        }
    finally:
        try:
            env.node.event_bus.unsubscribe_all(
                f"rpc-tx-{key.hex()[:16]}")
        except Exception:
            pass


async def _pruning_set_retain(env, height):
    pruner = getattr(env.node, "pruner", None)
    if pruner is None:
        from .server import RPCError
        raise RPCError(-32603, "pruner unavailable")
    pruner.companion_enabled = True
    try:
        pruner.set_companion_retain_height(int(height))
    except ValueError as e:
        from .server import RPCError
        raise RPCError(-32602, str(e))
    return {}


async def _pruning_get_retain(env):
    pruner = getattr(env.node, "pruner", None)
    if pruner is None:
        from .server import RPCError
        raise RPCError(-32603, "pruner unavailable")
    return {
        "app_retain_height": str(
            pruner.get_application_retain_height()),
        "pruning_service_retain_height": str(
            pruner.get_companion_retain_height()),
    }


async def _broadcast_evidence(env, evidence):
    """Ingest wire-encoded evidence into the pool (reference:
    rpc/core/evidence.go BroadcastEvidence; used by the light client's
    report_evidence path)."""
    from ..types.evidence import evidence_from_proto_wrapped
    from ..wire import pb as _pb, decode as _decode
    raw = base64.b64decode(evidence)
    ev = evidence_from_proto_wrapped(_decode(_pb.EVIDENCE, raw))
    pool = getattr(env.node, "evidence_pool", None)
    if pool is None:
        from .server import RPCError
        raise RPCError(-32603, "evidence pool unavailable")
    pool.add_evidence(ev)
    return {"hash": ev.hash().hex().upper()}


async def _unconfirmed_txs(env, limit):
    txs = env.mempool.reap_max_txs(int(limit))
    return {
        "n_txs": str(len(txs)),
        "total": str(env.mempool.size()),
        "total_bytes": str(env.mempool.size_bytes()),
        "txs": [base64.b64encode(t).decode() for t in txs],
    }


async def _num_unconfirmed_txs(env):
    return {"n_txs": str(env.mempool.size()),
            "total": str(env.mempool.size()),
            "total_bytes": str(env.mempool.size_bytes())}


def _normalize_height(env, height) -> int:
    h = int(height)
    if h <= 0:
        return env.block_store.height
    return h


async def _cached(env, method: str, height: int, extra, build):
    """Serve ``method`` at ``height`` from the lightserve response cache
    when the holder has one; otherwise build and, when the height is
    below the tip (immutable), insert.  ``extra`` is the hashable rest
    of the request key.  A height below the block store's base is built
    from the stores."""
    cache = getattr(env.node, "lightserve_cache", None)
    if cache is None or height < env.block_store.base:
        return await build()
    hit = cache.get(method, height, extra)
    if hit is not None:
        return hit
    res = await build()
    cache.put(method, height, extra, res,
              latest_height=env.block_store.height)
    return res


async def _block(env, height):
    h = _normalize_height(env, height)
    return await _cached(env, "block", h, (),
                         lambda: _build_block(env, h))


async def _build_block(env, h):
    block = env.block_store.load_block(h)
    meta = env.block_store.load_block_meta(h)
    if block is None or meta is None:
        from .server import RPCError
        raise RPCError(-32603, f"block at height {h} not found")
    return {"block_id": _block_id_json(meta.block_id),
            "block": _block_json(block)}


async def _light_block(env, height):
    from ..lightserve import core as lightserve
    h = _normalize_height(env, height)
    return await _cached(env, "light_block", h, (),
                         lambda: lightserve.light_block(env, h))


async def _multiproof(env, height, indices):
    from ..lightserve import core as lightserve
    h = _normalize_height(env, height)
    idx = tuple(sorted(set(lightserve.parse_indices(indices))))
    return await _cached(env, "multiproof", h, idx,
                         lambda: lightserve.tx_multiproof(env, h, idx))


async def _abci_query_batch(env, path, data, height, prove):
    from ..lightserve import core as lightserve

    def build():
        return lightserve.abci_query_batch(env, path, data, height,
                                           prove)
    try:
        h = int(height)
    except (TypeError, ValueError):
        h = 0
    if h <= 0 or not _parse_bool(prove):
        # height 0 is the latest state, which moves, and an unproven
        # batch reads whatever state the app serves: neither is
        # cached.  A proven batch at an explicit height is pinned to
        # that height's committed tree version.
        return await build()
    keys = tuple(k.hex() for k in lightserve._parse_keys(data))
    return await _cached(env, "abci_query_batch", h,
                         (str(path), keys), build)


async def _block_by_hash(env, hash):
    raw = _decode_hex_or_str(hash)
    block = env.block_store.load_block_by_hash(raw)
    meta = env.block_store.load_block_meta_by_hash(raw)
    if block is None or meta is None:
        from .server import RPCError
        raise RPCError(-32603, "block not found")
    return {"block_id": _block_id_json(meta.block_id),
            "block": _block_json(block)}


async def _header(env, height):
    """Reference: rpc/core/blocks.go Header."""
    h = _normalize_height(env, height)
    meta = env.block_store.load_block_meta(h)
    if meta is None:
        from .server import RPCError
        raise RPCError(-32603, f"header at height {h} not found")
    return {"header": _header_json(meta.header)}


async def _header_by_hash(env, hash):
    """Reference: rpc/core/blocks.go HeaderByHash."""
    raw = _decode_hex_or_str(hash)
    meta = env.block_store.load_block_meta_by_hash(raw)
    if meta is None:
        from .server import RPCError
        raise RPCError(-32603, "header not found")
    return {"header": _header_json(meta.header)}


async def _check_tx(env, tx):
    """Run CheckTx against the app without adding the tx to the
    mempool (reference: rpc/core/mempool.go CheckTx)."""
    raw = _decode_tx(tx)
    res = await env.node.app_conns.mempool.check_tx(
        abci.CheckTxRequest(tx=raw, type=abci.CHECK_TX_TYPE_CHECK))
    return {
        "code": res.code,
        "data": base64.b64encode(res.data).decode(),
        "log": res.log, "info": res.info,
        "gas_wanted": str(res.gas_wanted),
        "gas_used": str(res.gas_used),
        "events": _events_json(res.events),
        "codespace": res.codespace,
    }


async def _unconfirmed_tx(env, hash):
    """Reference: rpc/core/mempool.go UnconfirmedTx."""
    raw = _decode_hex_or_str(hash)
    tx = env.mempool.get_tx_by_hash(raw)
    if tx is None:
        from .server import RPCError
        raise RPCError(-32603, "tx not found in mempool")
    return {"tx": base64.b64encode(tx).decode()}


async def _block_results(env, height):
    h = _normalize_height(env, height)
    resp = env.state_store.load_finalize_block_response(h)
    if resp is None:
        from .server import RPCError
        raise RPCError(-32603, f"no results for height {h}")
    return {
        "height": str(h),
        "txs_results": [
            {"code": r.code,
             "data": base64.b64encode(r.data).decode(),
             "log": r.log, "gas_wanted": str(r.gas_wanted),
             "gas_used": str(r.gas_used),
             "events": _events_json(r.events)}
            for r in resp.tx_results],
        "finalize_block_events": _events_json(resp.events),
        "validator_updates": [
            {"pub_key_type": v.pub_key_type,
             "pub_key_bytes": base64.b64encode(
                 v.pub_key_bytes).decode(),
             "power": str(v.power)}
            for v in resp.validator_updates],
        "app_hash": resp.app_hash.hex().upper(),
    }


async def _commit(env, height):
    h = _normalize_height(env, height)
    # only heights below the tip are inserted (put refuses the rest),
    # and below the tip the commit is canonical
    return await _cached(env, "commit", h, (),
                         lambda: _build_commit(env, h))


async def _build_commit(env, h):
    meta = env.block_store.load_block_meta(h)
    commit = env.block_store.load_block_commit(h)
    canonical = True
    if commit is None:
        commit = env.block_store.load_seen_commit(h)
        canonical = False
    if meta is None or commit is None:
        from .server import RPCError
        raise RPCError(-32603, f"commit for height {h} not found")
    return {
        "signed_header": {
            "header": _header_json(meta.header),
            "commit": _commit_json(commit),
        },
        "canonical": canonical,
    }


async def _blockchain(env, min_height, max_height):
    base, height = env.block_store.base, env.block_store.height
    min_h = max(int(min_height) or base, base)
    max_h = min(int(max_height) or height, height)
    metas = []
    for h in range(max_h, min_h - 1, -1):
        m = env.block_store.load_block_meta(h)
        if m is not None:
            metas.append({
                "block_id": _block_id_json(m.block_id),
                "block_size": str(m.block_size),
                "header": _header_json(m.header),
                "num_txs": str(m.num_txs),
            })
    return {"last_height": str(height), "block_metas": metas}


async def _validators(env, height, page, per_page):
    h = _normalize_height(env, height)
    vals = env.state_store.load_validators(h)
    page_i, per = max(1, int(page)), min(100, int(per_page))
    start = (page_i - 1) * per
    sel = vals.validators[start:start + per]
    return {
        "block_height": str(h),
        "validators": [
            {"address": v.address.hex().upper(),
             "pub_key": genesis.pub_key_to_json(v.pub_key),
             "voting_power": str(v.voting_power),
             "proposer_priority": str(v.proposer_priority)}
            for v in sel],
        "count": str(len(sel)),
        "total": str(vals.size()),
    }


async def _consensus_state(env):
    rs = env.consensus.rs
    return {"round_state": {
        "height/round/step":
            f"{rs.height}/{rs.round}/{rs.step}",
        "start_time": rs.start_time.rfc3339(),
        "proposal_block_hash":
            rs.proposal_block.hash().hex().upper()
            if rs.proposal_block else "",
        "locked_block_hash":
            rs.locked_block.hash().hex().upper()
            if rs.locked_block else "",
        "valid_block_hash":
            rs.valid_block.hash().hex().upper()
            if rs.valid_block else "",
    }}


async def _trace(env, height, category, limit):
    """Flight-recorder timeline (libs/tracing.py): spans + instant
    events from the per-category ring buffers, strictly ordered by
    monotonic timestamp.  ?height=H keeps one height's events,
    ?category=consensus|crypto|p2p|mempool|abci keeps one ring,
    ?limit=N keeps the newest N."""
    from ..libs import tracing
    try:
        h = int(height or 0)
    except (TypeError, ValueError):
        h = 0
    try:
        lim = int(limit or 0)
    except (TypeError, ValueError):
        lim = 0
    events = tracing.snapshot(height=h if h > 0 else None,
                              category=str(category)
                              if category else None,
                              limit=lim)
    r = tracing.recorder()
    r.refresh_anchor()
    return {
        "enabled": tracing.enabled(),
        "count": len(events),
        "node": r.node_id,
        # (monotonic_ns, wall_ns) clock-anchor pairs: what lets
        # tools/fleet_report.py place this node's monotonic
        # timeline on a cluster-wide wall clock
        "anchors": [[str(m), str(w)] for m, w in r.anchors],
        # int64s ride as strings, the surface-wide convention
        "events": [{**e, "ts_ns": str(e["ts_ns"]),
                    "dur_ns": str(e["dur_ns"]),
                    "height": str(e["height"])} for e in events],
    }


def _vote_set_summary(vs) -> dict:
    if vs is None:
        return {}
    return {"bit_array": str(vs.bit_array()),
            "voting_power": str(vs.sum)}


async def _dump_consensus_state(env):
    """Full round state + what we believe each peer's round state is
    (reference: rpc/core/consensus.go DumpConsensusState)."""
    rs = env.consensus.rs
    round_state = {
        "height": str(rs.height), "round": rs.round,
        "step": rs.step_name(),
        "start_time": rs.start_time.rfc3339(),
        "commit_time": rs.commit_time.rfc3339(),
        "validators": {
            "validators": [
                {"address": v.address.hex().upper(),
                 "voting_power": str(v.voting_power),
                 "proposer_priority": str(v.proposer_priority)}
                for v in rs.validators.validators]
            if rs.validators else [],
            "proposer": {"address":
                         rs.validators.get_proposer()
                         .address.hex().upper()}
            if rs.validators and rs.validators.validators else {},
        },
        "proposal_block_hash":
            rs.proposal_block.hash().hex().upper()
            if rs.proposal_block else "",
        "locked_round": rs.locked_round,
        "locked_block_hash":
            rs.locked_block.hash().hex().upper()
            if rs.locked_block else "",
        "valid_round": rs.valid_round,
        "valid_block_hash":
            rs.valid_block.hash().hex().upper()
            if rs.valid_block else "",
        "commit_round": rs.commit_round,
        "votes": [
            {"round": r,
             "prevotes": _vote_set_summary(
                 rs.votes.prevotes(r)),
             "precommits": _vote_set_summary(
                 rs.votes.precommits(r))}
            for r in (sorted(rs.votes._round_vote_sets)
                      if rs.votes else [])],
        "last_commit": _vote_set_summary(rs.last_commit),
    }
    peers = []
    for p in env.node.switch.peers.values():
        ps = p.data.get("consensus_peer_state")
        if ps is None:
            continue
        prs = ps.prs
        peers.append({
            "node_address": p.remote_addr,
            "peer_state": {"round_state": {
                "height": str(prs.height), "round": prs.round,
                "step": prs.step,
                "proposal": prs.proposal,
                "proposal_pol_round": prs.proposal_pol_round,
                "prevotes": str(prs.prevotes or ""),
                "precommits": str(prs.precommits or ""),
                "last_commit_round": prs.last_commit_round,
                "catchup_commit_round": prs.catchup_commit_round,
            }},
        })
    return {"round_state": round_state, "peers": peers}


def _require_unsafe(env) -> None:
    if not env.node.config.rpc.unsafe:
        from .server import RPCError
        raise RPCError(
            -32601, "unsafe RPC commands disabled "
            "(enable with rpc.unsafe)")


async def _unsafe_dial_seeds(env, seeds):
    """Reference: rpc/core/net.go UnsafeDialSeeds."""
    _require_unsafe(env)
    addrs = [s for s in (seeds.split(",")
                         if isinstance(seeds, str) else seeds) if s]
    if not addrs:
        from .server import RPCError
        raise RPCError(-32602, "no seeds provided")
    env.node.switch.dial_peers_async(addrs, persistent=False)
    return {"log": "Dialing seeds in progress. "
                   "See /net_info for details"}


async def _unsafe_dial_peers(env, peers, persistent, private):
    """Reference: rpc/core/net.go UnsafeDialPeers.  (unconditional
    is accepted for wire compatibility but has no effect: the switch
    enforces no inbound peer cap to bypass.)"""
    _require_unsafe(env)
    addrs = [s for s in (peers.split(",")
                         if isinstance(peers, str) else peers) if s]
    if not addrs:
        from .server import RPCError
        raise RPCError(-32602, "no peers provided")
    if _parse_bool(private):
        if not all("@" in a for a in addrs):
            from .server import RPCError
            raise RPCError(
                -32602, "private peers must be id@host:port "
                "(privacy is keyed on the node id)")
        env.node.switch.private_ids.update(
            a.split("@", 1)[0] for a in addrs)
    env.node.switch.dial_peers_async(
        addrs, persistent=_parse_bool(persistent))
    return {"log": "Dialing peers in progress. "
                   "See /net_info for details"}


async def _unsafe_flush_mempool(env):
    """Reference: rpc/core/mempool.go UnsafeFlushMempool."""
    _require_unsafe(env)
    env.mempool.flush()
    return {}


async def _consensus_params(env, height):
    h = _normalize_height(env, height)
    params = env.state_store.load_consensus_params(h)
    return {"block_height": str(h), "consensus_params": {
        "block": {"max_bytes": str(params.block.max_bytes),
                  "max_gas": str(params.block.max_gas)},
        "evidence": {
            "max_age_num_blocks":
                str(params.evidence.max_age_num_blocks),
            "max_age_duration":
                str(params.evidence.max_age_duration_ns),
            "max_bytes": str(params.evidence.max_bytes)},
        "validator": {"pub_key_types":
                      list(params.validator.pub_key_types)},
    }}


def _tx_result_json(tr) -> dict:
    from ..types.tx import tx_hash
    return {
        "hash": tx_hash(tr.tx).hex().upper(),
        "height": str(tr.height),
        "index": tr.index,
        "tx_result": {
            "code": tr.result.code,
            "data": base64.b64encode(tr.result.data).decode(),
            "log": tr.result.log,
            "gas_wanted": str(tr.result.gas_wanted),
            "gas_used": str(tr.result.gas_used),
            "events": _events_json(tr.result.events),
        },
        "tx": base64.b64encode(tr.tx).decode(),
    }


async def _tx(env, hash):
    from .server import RPCError
    if env.node.tx_indexer is None:
        raise RPCError(-32603, "transaction indexing is disabled")
    raw = hash if isinstance(hash, bytes) else (
        bytes.fromhex(hash[2:]) if hash.startswith("0x")
        else bytes.fromhex(hash))
    tr = env.node.tx_indexer.get(raw)
    if tr is None:
        raise RPCError(-32603, f"tx {hash} not found")
    return _tx_result_json(tr)


async def _tx_search(env, query, page, per_page):
    from ..libs.pubsub import Query
    from .server import RPCError
    if env.node.tx_indexer is None:
        raise RPCError(-32603, "transaction indexing is disabled")
    # every match, then the page: the JAX route searches with the
    # indexer's default cap of 100, so its total_count stops there
    hashes = env.node.tx_indexer.search(Query(query), limit=None)
    page_i, per = max(1, int(page)), min(100, int(per_page))
    sel = hashes[(page_i - 1) * per:page_i * per]
    txs = [env.node.tx_indexer.get(h) for h in sel]
    return {"txs": [_tx_result_json(t) for t in txs if t],
            "total_count": str(len(hashes))}


async def _block_search(env, query, page, per_page):
    from ..libs.pubsub import Query
    from .server import RPCError
    if env.node.block_indexer is None:
        raise RPCError(-32603, "block indexing is disabled")
    heights = env.node.block_indexer.search(Query(query), limit=None)
    page_i, per = max(1, int(page)), min(100, int(per_page))
    sel = heights[(page_i - 1) * per:page_i * per]
    blocks = []
    for h in sel:
        meta = env.block_store.load_block_meta(h)
        block = env.block_store.load_block(h)
        if meta and block:
            blocks.append({"block_id": _block_id_json(meta.block_id),
                           "block": _block_json(block)})
    return {"blocks": blocks, "total_count": str(len(heights))}


# ---------------------------------------------------------------------------
# JSON shaping helpers


def _block_id_json(bid) -> dict:
    return {"hash": bid.hash.hex().upper(),
            "parts": {"total": bid.part_set_header.total,
                      "hash": bid.part_set_header.hash.hex().upper()}}


def _header_json(h) -> dict:
    return {
        "version": {"block": str(h.version.block),
                    "app": str(h.version.app)},
        "chain_id": h.chain_id,
        "height": str(h.height),
        "time": h.time.rfc3339(),
        "last_block_id": _block_id_json(h.last_block_id),
        "last_commit_hash": h.last_commit_hash.hex().upper(),
        "data_hash": h.data_hash.hex().upper(),
        "validators_hash": h.validators_hash.hex().upper(),
        "next_validators_hash": h.next_validators_hash.hex().upper(),
        "consensus_hash": h.consensus_hash.hex().upper(),
        "app_hash": h.app_hash.hex().upper(),
        "last_results_hash": h.last_results_hash.hex().upper(),
        "evidence_hash": h.evidence_hash.hex().upper(),
        "proposer_address": h.proposer_address.hex().upper(),
    }


def _commit_json(c) -> dict:
    from ..types.commit import AggregateCommit
    if isinstance(c, AggregateCommit):
        # aggregate-commit chains (docs/aggregate_commits.md): one
        # BLS signature + signer bitmap instead of per-val signatures
        return {
            "height": str(c.height), "round": c.round,
            "block_id": _block_id_json(c.block_id),
            "signer_count": c.size(),
            "signers": base64.b64encode(c.signers_bytes()).decode(),
            "aggregate_signature":
                base64.b64encode(c.signature).decode(),
        }
    return {
        "height": str(c.height), "round": c.round,
        "block_id": _block_id_json(c.block_id),
        "signatures": [
            {"block_id_flag": s.block_id_flag,
             "validator_address": s.validator_address.hex().upper(),
             "timestamp": s.timestamp.rfc3339(),
             "signature": base64.b64encode(s.signature).decode()
             if s.signature else None}
            for s in c.signatures],
    }


def _block_json(b) -> dict:
    return {
        "header": _header_json(b.header),
        "data": {"txs": [base64.b64encode(t).decode()
                         for t in b.data.txs]},
        "evidence": {"evidence": []},
        "last_commit": _commit_json(b.last_commit)
        if b.last_commit is not None else None,
    }


def _events_json(events) -> list:
    return [{"type": e.type, "attributes": [
        {"key": a.key, "value": a.value, "index": a.index}
        for a in e.attributes]} for e in events or []]


class UriString(str):
    """A quoted URI GET parameter.  The reference's URI handler treats
    a quoted value as the raw string content — `tx="name=satoshi"`
    submits the bytes `name=satoshi` — while JSON-RPC POST []byte
    params are base64 (rpc/jsonrpc/server/http_uri_handler.go,
    nonJSONStringToArg).  The server tags quoted URI params with this
    type so decoders keep the two wire conventions apart."""


def _decode_tx(tx) -> bytes:
    """Txs arrive base64 (JSON-RPC), 0x-hex (URI), or as a quoted
    raw URI string."""
    if isinstance(tx, bytes):
        return tx
    if isinstance(tx, UriString):
        return str(tx).encode()
    if tx.startswith("0x"):
        return bytes.fromhex(tx[2:])
    return base64.b64decode(tx)


def _decode_hex_or_str(v) -> bytes:
    if isinstance(v, bytes):
        return v
    if isinstance(v, UriString):
        return str(v).encode()
    if v.startswith("0x"):
        return bytes.fromhex(v[2:])
    return v.encode()


def _parse_bool(v) -> bool:
    if isinstance(v, bool):
        return v
    return str(v).lower() in ("true", "1")


def event_data_json(ev) -> dict:
    """EventData -> the ws subscription payload (reference: the typed
    TMEventData JSON in rpc/core/events).  Best-effort typed rendering of
    the common event kinds; round-state events carry their summary dict."""
    kind = getattr(ev, "kind", "")
    payload = getattr(ev, "payload", None)
    out: dict = {"type": f"tendermint/event/{kind or 'Unknown'}"}
    value: dict = {}
    try:
        if kind == "NewBlock" and isinstance(payload, dict):
            block = payload.get("block")
            if block is not None:
                value = {"block": _block_json(block),
                         "block_id": _block_id_json(
                             payload.get("block_id"))}
        elif kind == "NewBlockHeader" and isinstance(payload, dict):
            value = {"header": _header_json(payload["header"])}
        elif kind == "Tx" and isinstance(payload, dict):
            res = payload.get("result")
            value = {
                "height": str(payload.get("height", 0)),
                "index": payload.get("index", 0),
                "tx": base64.b64encode(payload.get("tx", b"")).decode(),
                "result": {
                    "code": res.code,
                    "data": base64.b64encode(res.data).decode(),
                    "log": res.log,
                    "gas_wanted": str(res.gas_wanted),
                    "gas_used": str(res.gas_used),
                    "events": _events_json(res.events),
                } if res is not None else None,
            }
        elif isinstance(payload, dict):
            value = {k: v for k, v in payload.items()
                     if isinstance(v, (str, int, float, bool, type(None)))}
    except Exception:  # noqa: BLE001 — events must never kill the pump
        value = {}
    out["value"] = value
    return out
