"""The port's JSON-RPC (cometbft_tpu_torch/rpc/), HttpProvider and RPC state
provider against the JAX package's.

Twin 12-validator chains (tests/torch_chain.py: the port's ``_ExecChain``
and the JAX ``RChain``, the same steps with the same seeded keys) are
held by a node holder in each package with the JAX Node's attribute
names.  Every route's answer is compared as JSON; the servers' parsing,
error codes and texts over HTTP; the WebSocket frames byte for byte; the
``*_from_json`` codecs object for object; the port's HttpProvider and
``new_rpc_state_provider`` against servers of both packages.  The port
verifies on ``device="cpu"`` with the accept-all stand-in kernel; the
light blocks it brings are held byte for byte to the stores' own.
"""
import asyncio
import base64
import json
import os
import time

import pytest

from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.config import Config as RConfig
from cometbft_tpu.config import ConsensusConfig as RConsensusConfig
from cometbft_tpu.consensus.state import ConsensusState as RConsensusState
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.evidence.pool import EvidencePool as REvidencePool
from cometbft_tpu.indexer import BlockIndexer as RBlockIndexer
from cometbft_tpu.indexer import TxIndexer as RTxIndexer
from cometbft_tpu.libs import tracing as r_tracing
from cometbft_tpu.light import client as r_light
from cometbft_tpu.light.provider import HttpProvider as RHttpProvider
from cometbft_tpu.light.store import TrustedStore as RTrustedStore
from cometbft_tpu.mempool.mempool import CListMempool as RMempool
from cometbft_tpu.node.node import Node as RNode
from cometbft_tpu.p2p.key import NodeKey as RNodeKey
from cometbft_tpu.rpc import client as r_client
from cometbft_tpu.rpc import core as r_core
from cometbft_tpu.rpc import server as r_server
from cometbft_tpu.rpc import ws as r_ws
from cometbft_tpu.state.pruner import Pruner as RPruner
from cometbft_tpu.statesync import syncer as r_syncer
from cometbft_tpu.types import canonical as r_canonical
from cometbft_tpu.types import commit as r_commit
from cometbft_tpu.types import evidence as r_evidence
from cometbft_tpu.types import vote as r_vote
from cometbft_tpu.types.events import EventBus as REventBus
from cometbft_tpu.types.priv_validator import MockPV as RMockPV
from cometbft_tpu.wire import encode as r_encode
from cometbft_tpu.wire import pb as r_pb
from cometbft_tpu_torch.abci import types as p_abci
from cometbft_tpu_torch.config import Config as PConfig
from cometbft_tpu_torch.config import ConsensusConfig as PConsensusConfig
from cometbft_tpu_torch.config import RPCConfig as PRPCConfig
from cometbft_tpu_torch.consensus.state import ConsensusState as PConsensusState
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.db import MemDB as PMemDB
from cometbft_tpu_torch.evidence.pool import EvidencePool as PEvidencePool
from cometbft_tpu_torch.node.node import Node as PNode
from cometbft_tpu_torch.indexer import BlockIndexer as PBlockIndexer
from cometbft_tpu_torch.indexer import TxIndexer as PTxIndexer
from cometbft_tpu_torch.libs import bits as p_bits
from cometbft_tpu_torch.libs import tracing as p_tracing
from cometbft_tpu_torch.light import client as p_light
from cometbft_tpu_torch.light.provider import HttpProvider as PHttpProvider
from cometbft_tpu_torch.light.store import TrustedStore as PTrustedStore
from cometbft_tpu_torch.mempool.mempool import CListMempool as PMempool
from cometbft_tpu_torch.p2p.key import NodeKey as PNodeKey
from cometbft_tpu_torch.rpc import client as p_client
from cometbft_tpu_torch.rpc import core as p_core
from cometbft_tpu_torch.rpc import server as p_server
from cometbft_tpu_torch.rpc import ws as p_ws
from cometbft_tpu_torch.state.pruner import Pruner as PPruner
from cometbft_tpu_torch.statesync import syncer as p_syncer
from cometbft_tpu_torch.tools import loadtime as p_loadtime
from cometbft_tpu_torch.types import canonical as p_canonical
from cometbft_tpu_torch.types import commit as p_commit
from cometbft_tpu_torch.types import evidence as p_evidence
from cometbft_tpu_torch.types import vote as p_vote
from cometbft_tpu_torch.types.events import EventBus as PEventBus
from cometbft_tpu_torch.types.priv_validator import MockPV as PMockPV
from cometbft_tpu_torch.wire import encode as p_encode
from cometbft_tpu_torch.wire import pb as p_pb

from torch_chain import RChain, accept_all, cs, port_chain, seeds
from torch_helpers import one_torch_thread  # noqa: F401

SPEC = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "docs", "rpc-spec.json")
LIGHTSERVE = ("light_block", "multiproof", "abci_query_batch")
N, TOP, CHAIN_ID = 12, 8, "rpc-chain"
TXS = 3
# one load payload in the chain, the same bytes in both packages
PAYLOAD = p_loadtime.payload_bytes("exp-rpc", size=300, rate=5,
                                   connections=1, now_ns=1)


class StubSwitch:
    """What the routes read of a switch, the same object in both holders:
    no peers, and the dials the unsafe routes ask for."""

    def __init__(self):
        self.listen_addr = "127.0.0.1:26656"
        self.peers = {}
        self.private_ids = set()
        self.dialed = []

    def num_peers(self):
        return 0

    def dial_peers_async(self, addrs, persistent=False):
        self.dialed.append((list(addrs), persistent))


class Holder:
    """A node holder with the JAX Node's attribute names."""
    moniker = "anonymous"
    consensus_reactor = blocksync_reactor = lightserve_cache = None

    def __init__(self, status, **parts):
        self.__dict__.update(parts)
        self._status = status

    def status(self):
        return self._status(self)


def _txs(h):
    txs = [cs._load_tx(11, h, j) for j in range(TXS)]
    return txs + [PAYLOAD] if h == 3 else txs


def _index(chain, abci, txi, bi):
    for h in range(1, chain.block_store.height + 1):
        resp = chain.state_store.load_finalize_block_response(h)
        block = chain.block_store.load_block(h)
        for i, tx in enumerate(block.data.txs):
            txi.index(abci.TxResult(height=h, index=i, tx=tx,
                                    result=resp.tx_results[i]))
        bi.index(h, resp.events)


async def _holders(p, r, key0):
    """The port's and the JAX package's holders over the twin chains."""
    async def mempool(cls, abci, chain, cfg):
        info = await chain.conns.query.info(abci.InfoRequest())
        return cls(cfg.mempool, chain.conns.mempool,
                   lanes=info.lane_priorities,
                   default_lane=info.default_lane,
                   height=chain.state.last_block_height)

    pcfg, rcfg = PConfig(), RConfig()
    sw = StubSwitch()
    ppv, rpv = PMockPV(p_ed.Ed25519PrivKey(key0)), \
        RMockPV(r_ed.Ed25519PrivKey(key0))
    pbus, rbus = PEventBus(), REventBus()
    pexec_state, rexec_state = p.state_store.load(), r.state_store.load()
    pn = Holder(
        PNode.status, block_store=p.block_store,
        state_store=p.state_store,
        mempool=await mempool(PMempool, p_abci, p, pcfg),
        consensus_state=PConsensusState(
            PConsensusConfig(), pexec_state, p.exec, p.block_store,
            priv_validator=ppv, event_bus=pbus, device="cpu"),
        switch=sw, event_bus=pbus, genesis_doc=p.doc, config=pcfg,
        app_conns=p.conns, tx_indexer=PTxIndexer(PMemDB()),
        block_indexer=PBlockIndexer(PMemDB()),
        pruner=PPruner(p.state_store, p.block_store, PMemDB()),
        evidence_pool=PEvidencePool(PMemDB(), p.state_store,
                                    p.block_store, device="cpu"),
        node_key=PNodeKey(p_ed.Ed25519PrivKey(b"\x42" * 32)),
        priv_validator=ppv)
    rn = Holder(
        RNode.status, block_store=r.block_store, state_store=r.state_store,
        mempool=await mempool(RMempool, r_abci, r, rcfg),
        consensus_state=RConsensusState(
            RConsensusConfig(), rexec_state, r.exec, r.block_store,
            priv_validator=rpv, event_bus=rbus),
        switch=sw, event_bus=rbus, genesis_doc=r.doc, config=rcfg,
        app_conns=r.conns, tx_indexer=RTxIndexer(RMemDB()),
        block_indexer=RBlockIndexer(RMemDB()),
        pruner=RPruner(r.state_store, r.block_store, RMemDB()),
        evidence_pool=REvidencePool(RMemDB(), r.state_store,
                                    r.block_store),
        node_key=RNodeKey(r_ed.Ed25519PrivKey(b"\x42" * 32)),
        priv_validator=rpv)
    _index(p, p_abci, pn.tx_indexer, pn.block_indexer)
    _index(r, r_abci, rn.tx_indexer, rn.block_indexer)
    rn.consensus_state.rs.start_time = \
        type(rn.consensus_state.rs.start_time)(cs.EXEC_T0, 5)
    pn.consensus_state.rs.start_time = \
        type(pn.consensus_state.rs.start_time)(cs.EXEC_T0, 5)
    return pn, rn


@pytest.fixture(scope="module")
def twins():
    key_seeds = seeds(N, 151)
    t0 = int(time.time()) - 300
    loop = asyncio.new_event_loop()
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        mp.setattr(cs, "EXEC_T0", t0)
        p = port_chain(CHAIN_ID, key_seeds, t0=t0)
        r = RChain(CHAIN_ID, key_seeds)
        for h in range(1, TOP + 1):
            p.step(_txs(h))
            r.step(_txs(h))
        pn, rn = loop.run_until_complete(_holders(p, r, key_seeds[0]))
    yield {"p": p, "r": r, "pn": pn, "rn": rn, "loop": loop,
           "seeds": key_seeds, "t0": t0}
    loop.close()


@pytest.fixture
def stand_in(monkeypatch):
    r_batch.set_backend("cpu")
    return accept_all(monkeypatch)


def _outcome(loop, routes, name, params):
    fn = routes[name]
    try:
        res = loop.run_until_complete(fn(**params))
    except (p_server.RPCError, r_server.RPCError) as e:
        return ["error", e.code, e.message, e.data]
    res = json.loads(json.dumps(res))
    if name == "trace":
        # the clock anchors and event times are this process's clocks
        assert all(int(m) > 0 and int(w) > 0 for m, w in res["anchors"])
        res["anchors"] = len(res["anchors"]) > 0
        for ev in res["events"]:
            ev["ts_ns"] = int(ev["ts_ns"]) > 0
            ev["dur_ns"] = int(ev["dur_ns"]) >= 0
    return ["result", res]


def _evidence(twins, pkg):
    """Duplicate-vote evidence against validator 0 at height 2, wire
    encoded in base64, the same bytes from each package."""
    canonical, vote, ev_mod, encode, pb, ed = (
        (p_canonical, p_vote, p_evidence, p_encode, p_pb, p_ed)
        if pkg == "port" else
        (r_canonical, r_vote, r_evidence, r_encode, r_pb, r_ed))
    chain = twins["p"] if pkg == "port" else twins["r"]
    key = ed.Ed25519PrivKey(twins["seeds"][0])
    vals = chain.state_store.load_validators(2)
    idx, val = vals.get_by_address(key.pub_key().address())
    meta = chain.block_store.load_block_meta(2)
    votes = []
    for lead in (b"\x01", b"\x02"):
        bid = type(meta.block_id)(
            hash=lead * 32, part_set_header=type(
                meta.block_id.part_set_header)(1, lead * 32))
        v = vote.Vote(type=canonical.PRECOMMIT_TYPE, height=2, round=0,
                      block_id=bid, timestamp=meta.header.time,
                      validator_address=val.address, validator_index=idx)
        v.signature = key.sign(v.sign_bytes(CHAIN_ID))
        votes.append(v)
    votes.sort(key=lambda v: v.block_id.key())
    ev = ev_mod.DuplicateVoteEvidence(
        vote_a=votes[0], vote_b=votes[1],
        total_voting_power=vals.total_voting_power(),
        validator_power=val.voting_power, timestamp=meta.header.time)
    return base64.b64encode(encode(pb.EVIDENCE,
                                   ev.to_proto_wrapped())).decode()


def _calls(twins):
    p = twins["p"]
    h3 = p.block_store.load_block_meta(3).block_id.hash.hex().upper()
    tx0 = p.block_store.load_block(2).data.txs[0]
    tx_hash = p_core.tx_hash(tx0).hex().upper()
    new_tx = base64.b64encode(b"rpc-key=rpc-value").decode()
    return [
        ("health", {}), ("status", {}), ("net_info", {}), ("genesis", {}),
        ("genesis_chunked", {}), ("genesis_chunked", {"chunk": "1"}),
        ("genesis_chunked", {"chunk": "x"}),
        ("abci_info", {}),
        ("abci_query", {"path": "/key", "data": "0x" + b"k1".hex()}),
        ("abci_query", {"data": "a"}),
        ("broadcast_tx_sync", {"tx": new_tx}),
        ("broadcast_tx_sync", {"tx": new_tx}),
        ("broadcast_tx_sync", {"tx": base64.b64encode(b"bad").decode()}),
        ("broadcast_tx_async", {"tx": base64.b64encode(b"as=1").decode()}),
        ("trace", {"category": "nemesis"}),
        ("unconfirmed_txs", {}), ("unconfirmed_txs", {"limit": "1"}),
        ("num_unconfirmed_txs", {}),
        ("unconfirmed_tx", {"hash": "0x" + p_core.tx_hash(
            b"rpc-key=rpc-value").hex()}),
        ("unconfirmed_tx", {"hash": "0x00"}),
        ("check_tx", {"tx": base64.b64encode(b"c=1").decode()}),
        *[("block", {"height": str(h)}) for h in (0, 1, 3, TOP)],
        ("block", {"height": "99"}),
        ("block_by_hash", {"hash": "0x" + h3}), ("block_by_hash",
                                                  {"hash": "0x00"}),
        ("header", {"height": "2"}), ("header", {"height": "99"}),
        ("header_by_hash", {"hash": "0x" + h3}),
        ("block_results", {"height": "3"}),
        ("block_results", {"height": "99"}),
        *[("commit", {"height": str(h)}) for h in (0, 1, 4, TOP)],
        ("commit", {"height": "99"}),
        ("blockchain", {}), ("blockchain", {"minHeight": "2",
                                            "maxHeight": "4"}),
        ("validators", {"height": "3"}),
        ("validators", {"height": "3", "page": "2", "per_page": "5"}),
        ("validators", {"height": "3", "page": "9", "per_page": "5"}),
        ("consensus_state", {}), ("dump_consensus_state", {}),
        ("consensus_params", {"height": "2"}),
        ("tx", {"hash": tx_hash}), ("tx", {"hash": "0x" + tx_hash}),
        ("tx", {"hash": "00" * 32}),
        ("tx_search", {"query": "tx.height = 2"}),
        ("tx_search", {"query": "tx.height > 1", "page": "2",
                       "per_page": "4"}),
        ("block_search", {"query": "block.height >= 3"}),
        ("pruning_get_block_retain_height", {}),
        ("pruning_set_block_retain_height", {"height": "99"}),
        ("pruning_set_block_retain_height", {"height": "2"}),
        ("pruning_set_block_retain_height", {"height": "1"}),
        ("pruning_get_block_retain_height", {}),
        ("dial_seeds", {"seeds": "a@127.0.0.1:1"}),
        ("dial_peers", {"peers": "a@127.0.0.1:1"}),
        ("unsafe_flush_mempool", {}),
        *[("light_block", {"height": str(h)}) for h in (0, 1, 3, TOP, 99)],
        ("multiproof", {"height": "3", "indices": "2,0,2"}),
        ("multiproof", {"height": "3", "indices": ""}),
        ("multiproof", {"height": "3", "indices": "9"}),
        ("multiproof", {"height": "3", "indices": "x"}),
        ("multiproof", {"height": "99", "indices": "0"}),
        *[("abci_query_batch", {"data": keys, "height": h, "prove": prove})
          for keys in ("0x61,0x" + b"zz".hex() + ",0x00", "0x61")
          for h in ("0", "3", str(TOP - 1))
          for prove in ("true", False)],
        ("abci_query_batch", {"data": "", "prove": "true"}),
        ("abci_query_batch", {"data": "0x61", "height": "x"}),
        ("abci_query_batch", {"data": "0x61", "height": "99",
                              "prove": "true"}),
    ]


def _unsafe_calls():
    return [
        ("dial_seeds", {"seeds": ""}),
        ("dial_seeds", {"seeds": "a@127.0.0.1:1,b@127.0.0.1:2"}),
        ("dial_peers", {"peers": "x@127.0.0.1:3", "persistent": "true",
                        "private": "true"}),
        ("dial_peers", {"peers": "127.0.0.1:3", "private": True}),
        ("unsafe_flush_mempool", {}), ("num_unconfirmed_txs", {}),
    ]


def test_route_table_is_the_spec_less_lightserve_and_answers_hold_it(twins):
    with open(SPEC) as f:
        spec = json.load(f)
    routes = p_core.routes(p_core.Environment(twins["pn"]))
    rroutes = r_core.routes(r_core.Environment(twins["rn"]))
    # the lightserve routes included (they answered -32601 until the
    # lightserve layer was ported)
    assert set(LIGHTSERVE) <= set(routes)
    assert sorted(routes) == sorted(spec["methods"])
    assert sorted(routes) == sorted(rroutes)
    loop, cfgs = twins["loop"], (twins["pn"].config, twins["rn"].config)
    seen = set()
    for cfg in cfgs:
        cfg.rpc.unsafe = True
    try:
        for name, params in _calls(twins) + _unsafe_calls():
            out = _outcome(loop, routes, name, params)
            # the JAX holder takes the same calls, so the twins stay equal
            _outcome(loop, rroutes, name, params)
            if out[0] != "result" or name in seen:
                continue
            seen.add(name)
            info = spec["methods"][name]
            for key in info["result_required"]:
                assert key in out[1], (name, key)
            for field, subkeys in info.get("nested_required",
                                           {}).items():
                for key in subkeys:
                    assert key in out[1][field], (name, field, key)
    finally:
        for cfg in cfgs:
            cfg.rpc.unsafe = False
    # the other two answer in test_broadcast_tx_commit_and_evidence_...
    assert seen == set(routes) - {"broadcast_tx_commit",
                                  "broadcast_evidence"}


def test_every_route_answers_as_the_jax_route(twins):
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]
    proutes = p_core.routes(p_core.Environment(pn))
    rroutes = r_core.routes(r_core.Environment(rn))
    for cfg in (pn.config, rn.config):
        cfg.rpc.unsafe = False
    for name, params in _calls(twins):
        mine = _outcome(loop, proutes, name, params)
        theirs = _outcome(loop, rroutes, name, params)
        assert mine == theirs, (name, params)
    for cfg in (pn.config, rn.config):
        cfg.rpc.unsafe = True
    try:
        for name, params in _unsafe_calls():
            mine = _outcome(loop, proutes, name, params)
            theirs = _outcome(loop, rroutes, name, params)
            assert mine == theirs, (name, params)
    finally:
        for cfg in (pn.config, rn.config):
            cfg.rpc.unsafe = False
    assert pn.pruner.companion_enabled and rn.pruner.companion_enabled
    assert pn.pruner.effective_retain_height() == \
        rn.pruner.effective_retain_height() == 0


def test_broadcast_tx_commit_and_evidence_answer_as_the_jax_ones(twins):
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]

    async def commit(node, routes, abci):
        tx = b"commit-key=v"
        task = asyncio.ensure_future(routes["broadcast_tx_commit"](
            tx=base64.b64encode(tx).decode()))
        for _ in range(20):
            await asyncio.sleep(0)
        node.event_bus.publish_tx(5, 1, tx, abci.ExecTxResult(
            code=0, data=b"d", log="ok", gas_wanted=2, gas_used=1), [])
        return json.loads(json.dumps(await task))
    mine = loop.run_until_complete(commit(
        pn, p_core.routes(p_core.Environment(pn)), p_abci))
    theirs = loop.run_until_complete(commit(
        rn, r_core.routes(r_core.Environment(rn)), r_abci))
    assert mine == theirs and mine["height"] == "5"
    ev_p, ev_r = _evidence(twins, "port"), _evidence(twins, "jax")
    assert ev_p == ev_r
    mine = _outcome(loop, p_core.routes(p_core.Environment(pn)),
                    "broadcast_evidence", {"evidence": ev_p})
    theirs = _outcome(loop, r_core.routes(r_core.Environment(rn)),
                      "broadcast_evidence", {"evidence": ev_r})
    assert mine == theirs and mine[0] == "result"
    assert len(pn.evidence_pool.pending_evidence(1 << 20)[0]) == 1


def test_trace_answers_as_the_jax_route(twins):
    loop = twins["loop"]
    outs = []
    for tracing, core, node in ((p_tracing, p_core, twins["pn"]),
                                (r_tracing, r_core, twins["rn"])):
        tracing.clear()
        tracing.set_height(0)
        tracing.instant(tracing.CONSENSUS, "commit", height=3, round=0)
        with tracing.span(tracing.CRYPTO, "batch_verify", batch=4):
            pass
        tracing.set_height(4)
        tracing.instant(tracing.P2P, "recv")
        tracing.set_height(0)
        routes = core.routes(core.Environment(node))
        outs.append([_outcome(loop, routes, "trace", params)[1]
                     for params in ({}, {"height": "3"}, {"category": "p2p"},
                                    {"limit": "1"}, {"height": "x"})])
        tracing.clear()
    assert outs[0] == outs[1]
    assert [e["height"] for e in outs[0][0]["events"]] == ["3", "0", "4"]


async def _http(port, raw):
    """One request's whole answer; b"" when the server closes the
    connection unanswered (a reset included)."""
    reader, writer = await asyncio.open_connection("127.0.0.1", port)
    try:
        writer.write(raw)
        await writer.drain()
        return await asyncio.wait_for(reader.read(-1), 10)
    except ConnectionResetError:
        return b""
    finally:
        writer.close()


def _post(body, extra=b""):
    body = body if isinstance(body, bytes) else json.dumps(body).encode()
    return (b"POST / HTTP/1.1\r\nHost: x\r\nContent-Type: application/json"
            b"\r\nContent-Length: " + str(len(body)).encode() + extra +
            b"\r\nConnection: close\r\n\r\n" + body)


def _get(target):
    return (b"GET " + target.encode() + b" HTTP/1.1\r\nHost: x\r\n"
            b"Connection: close\r\n\r\n")


HTTP_CASES = [
    _get("/health"), _get("/block?height=3"), _get("/commit?height=2"),
    _get("/"), _get("/nope"), _get("/validators?height=3&per_page=4"),
    _get('/abci_query?path="/key"&data="k1"'),
    _get("/abci_query?data=0x6b31"), _get("/header?height=zz"),
    _get('/broadcast_tx_sync?tx="uri=raw"'), _get("/metrics"),
    _get("/dial_seeds?seeds=a"), _get("//["),
    _post({"jsonrpc": "2.0", "id": 1, "method": "status"}),
    _post({"jsonrpc": "2.0", "id": "s", "method": "block",
           "params": {"height": "2"}}),
    _post(b"{not json"), _post(b"\xff\xfe"), _post([]),
    _post([1, {"jsonrpc": "2.0", "id": 2, "method": "health"}]),
    _post({"id": 3, "method": {}}), _post({"id": 4, "method": "health",
                                           "params": [1]}),
    _post({"id": 5, "method": "health", "params": "x"}),
    _post({"id": 6, "method": "block", "params": {"bogus": 1}}),
    _post({"id": 7, "method": "nope"}), _post(1),
    _post({"id": 8, "method": "light_block", "params": {"height": "2"}}),
    _post({"id": 9, "method": "unsafe_flush_mempool"}),
]


def _servers(loop, pn, rn, jax_routes=None, **cfg):
    pcfg = PRPCConfig(laddr="tcp://127.0.0.1:0", **cfg)
    rcfg = RConfig().rpc
    rcfg.laddr = "tcp://127.0.0.1:0"
    for k, v in cfg.items():
        setattr(rcfg, k, v)
    ps = p_server.RPCServer(pn, pcfg)
    rs = r_server.RPCServer(rn, rcfg, routes=jax_routes)
    loop.run_until_complete(ps.start())
    loop.run_until_complete(rs.start())
    return ps, rs


def test_http_parsing_error_codes_and_texts_equal_the_jax_server(twins):
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]
    ps, rs = _servers(loop, pn, rn)
    try:
        for raw in HTTP_CASES:
            mine = loop.run_until_complete(_http(ps.port, raw))
            theirs = loop.run_until_complete(_http(rs.port, raw))
            head, _, body = mine.partition(b"\r\n\r\n")
            rhead, _, rbody = theirs.partition(b"\r\n\r\n")
            assert head == rhead, raw
            if body.startswith((b"{", b"[")):
                a, b = json.loads(body), json.loads(rbody)
                for x in (a if isinstance(a, list) else [a]) + \
                        (b if isinstance(b, list) else [b]):
                    err = x.get("error") or {}
                    if err.get("code") == -32603 and \
                            err.get("message") == "Internal error":
                        err["data"] = err["data"][:12]   # the trace id
                assert a == b, raw
            else:
                assert body == rbody, raw
        # a body over max_body_bytes: the connection closes unanswered
        big = _post(b"x" * (ps.config.max_body_bytes + 1))
        assert loop.run_until_complete(_http(ps.port, big)) == \
            loop.run_until_complete(_http(rs.port, big)) == b""
    finally:
        loop.run_until_complete(ps.stop())
        loop.run_until_complete(rs.stop())


def test_header_and_connection_limits(twins):
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]
    ps, rs = _servers(loop, pn, rn, max_header_bytes=200,
                      max_open_connections=1)

    async def run():
        # a request line and headers past max_header_bytes: 431, closed
        raw = _get("/health").replace(b"Host: x", b"Host: " + b"x" * 300)
        got = await _http(ps.port, raw)
        assert got.startswith(b"HTTP/1.1 431 ") and b"Connection: close" \
            in got
        assert json.loads((await _http(ps.port, _get("/health")))
                          .partition(b"\r\n\r\n")[2])["result"]["status"]
        # a second connection while one is open: closed unanswered
        reader, writer = await asyncio.open_connection("127.0.0.1", ps.port)
        await asyncio.sleep(0.05)
        assert await _http(ps.port, _get("/health")) == b""
        writer.close()
        await asyncio.sleep(0.05)
        assert (await _http(ps.port, _get("/health"))).startswith(
            b"HTTP/1.1 200 OK")
    try:
        loop.run_until_complete(run())
    finally:
        loop.run_until_complete(ps.stop())
        loop.run_until_complete(rs.stop())


@pytest.mark.parametrize("limit", ["max_open_connections",
                                   "max_header_bytes"])
def test_zero_limits_mean_no_limit_and_one_mib(twins, limit):
    """C.4: a zero ``max_open_connections`` is no limit and a zero
    ``max_header_bytes`` is net/http's 1 MiB, as in the reference."""
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]
    ps, rs = _servers(loop, pn, rn, **{limit: 0})

    async def run():
        held = await asyncio.open_connection("127.0.0.1", ps.port)
        await asyncio.sleep(0.05)
        got = await _http(ps.port, _get("/health"))
        assert got.startswith(b"HTTP/1.1 200 OK"), got
        # a request line and headers of exactly 1 MiB are answered;
        # one byte more gets a 431 (read whole, so the answer is not
        # lost to a reset)
        def sized(total):
            raw = _get("/health")
            need = total - len(raw)
            pad = b""
            while need > 0:
                k = min(need, 4000)
                if need - k and need - k < 16:
                    k -= 16
                line = b"X-P: " + b"x" * (k - 7) + b"\r\n"
                pad += line
                need -= len(line)
            out = raw.replace(b"Host: x\r\n", b"Host: x\r\n" + pad)
            assert len(out) == total
            return out
        got = await _http(ps.port, sized(1 << 20))
        assert got.startswith(b"HTTP/1.1 200 OK"), got[:40]
        if limit == "max_header_bytes":
            assert (await _http(ps.port, sized((1 << 20) + 1))).startswith(
                b"HTTP/1.1 431 ")
        held[1].close()
    try:
        loop.run_until_complete(run())
    finally:
        loop.run_until_complete(ps.stop())
        loop.run_until_complete(rs.stop())


@pytest.mark.parametrize("size", [0, 5, 125, 126, 65535, 65536, 70000])
def test_websocket_frames_equal_the_jax_ones(monkeypatch, size):
    payload = bytes(range(256)) * (size // 256) + bytes(range(size % 256))
    for op in (p_ws.OP_TEXT, p_ws.OP_BIN, p_ws.OP_PING, p_ws.OP_CLOSE):
        assert p_ws.frame(op, payload) == r_ws.frame(op, payload)
        monkeypatch.setattr(os, "urandom", lambda n: b"\x11\x22\x33\x44")
        masked = p_ws.frame(op, payload, mask=True)
        assert masked == r_ws.frame(op, payload, mask=True)
        monkeypatch.undo()

        async def read(mod, data):
            reader = asyncio.StreamReader()
            reader.feed_data(data)
            reader.feed_eof()
            return await mod.read_message(reader)
        assert asyncio.run(read(p_ws, masked)) == \
            asyncio.run(read(r_ws, masked)) == (op, payload)


def test_websocket_fragments_pings_and_handshake_equal_the_jax_ones():
    hdrs = {"sec-websocket-key": "dGhlIHNhbXBsZSBub25jZQ=="}
    assert p_ws.handshake_response(hdrs) == r_ws.handshake_response(hdrs)
    assert p_ws.accept_key("dGhlIHNhbXBsZSBub25jZQ==") == \
        "s3pPLMBiTxaQ9kYGzzhZRbK+xOo="
    for mod in (p_ws, r_ws):
        with pytest.raises(mod.WSError, match="^missing Sec-WebSocket-Key$"):
            mod.handshake_response({})
    # a fragmented text message with a ping between its fragments
    data = (bytes([0x01, 3]) + b"abc" + bytes([0x89, 2]) + b"hi" +
            bytes([0x80, 2]) + b"de")

    async def read(mod):
        seen = []

        async def on_control(op, payload):
            seen.append((op, payload))
        reader = asyncio.StreamReader()
        reader.feed_data(data)
        reader.feed_eof()
        return await mod.read_message(reader, on_control), seen
    assert asyncio.run(read(p_ws)) == asyncio.run(read(r_ws)) == \
        ((p_ws.OP_TEXT, b"abcde"), [(p_ws.OP_PING, b"hi")])
    big = bytes([0x82, 127]) + (p_ws.MAX_FRAME + 1).to_bytes(8, "big")
    for mod in (p_ws, r_ws):
        async def over(mod=mod):
            reader = asyncio.StreamReader()
            reader.feed_data(big)
            reader.feed_eof()
            await mod.read_message(reader)
        with pytest.raises(mod.WSError, match="^frame too large$"):
            asyncio.run(over())


def test_websocket_sessions_push_what_the_jax_ones_push(twins):
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]
    ps, rs = _servers(loop, pn, rn)

    async def run(port, node, client_mod, abci):
        cli = client_mod.WSClient(f"ws://127.0.0.1:{port}")
        await cli.connect()
        sub = await cli.subscribe("tm.event = 'Tx'")
        blocks = await cli.subscribe("tm.event = 'NewBlockHeader'")
        health = await cli.call("health")
        node.event_bus.publish_tx(7, 0, b"ws=1", abci.ExecTxResult(
            code=0, data=b"z", log="l"), [])
        node.event_bus.publish_new_block_header(
            node.block_store.load_block_meta(2).header)
        got = [await sub.next(5), await blocks.next(5)]
        await cli.unsubscribe("tm.event = 'Tx'")
        bad = None
        try:
            await cli.call("subscribe", query="tm.event = ")
        except client_mod.RPCClientError as e:
            bad = str(e)
        await cli.close()
        return health["status"], got, bad
    try:
        mine = loop.run_until_complete(run(ps.port, pn, p_client, p_abci))
        theirs = loop.run_until_complete(run(rs.port, rn, r_client, r_abci))
    finally:
        loop.run_until_complete(ps.stop())
        loop.run_until_complete(rs.stop())
    assert mine == theirs
    assert mine[1][0]["data"]["value"]["height"] == "7"


def test_from_json_codecs_equal_the_jax_ones(twins):
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]
    proutes = p_core.routes(p_core.Environment(pn))
    for h in range(1, TOP + 1):
        res = loop.run_until_complete(proutes["commit"](height=str(h)))
        sh = res["signed_header"]
        hdr = p_client.header_from_json(sh["header"])
        rhdr = r_client.header_from_json(sh["header"])
        assert p_encode(p_pb.HEADER, hdr.to_proto()) == \
            r_encode(r_pb.HEADER, rhdr.to_proto()) == p_encode(
                p_pb.HEADER, pn.block_store.load_block_meta(h).header
                .to_proto())
        commit = p_client.commit_from_json(sh["commit"])
        rcommit = r_client.commit_from_json(sh["commit"])
        stored = pn.block_store.load_block_commit(h) or \
            pn.block_store.load_seen_commit(h)
        assert p_encode(p_pb.COMMIT, commit.to_proto()) == \
            r_encode(r_pb.COMMIT, rcommit.to_proto()) == \
            p_encode(p_pb.COMMIT, stored.to_proto())
        vals = loop.run_until_complete(proutes["validators"](
            height=str(h), per_page="100"))["validators"]
        pv = p_client.validator_set_from_json(vals)
        rv = r_client.validator_set_from_json(vals)
        # the port keeps the server's set as it stands (priorities, order,
        # the proposer the last rotation left lowest: on this chain without
        # validator changes, the stored one); the JAX parser recomputes
        # the priorities through the constructor (ROADMAP.md section C)
        assert p_encode(p_pb.VALIDATOR_SET, pv.to_proto()) == p_encode(
            p_pb.VALIDATOR_SET, pn.state_store.load_validators(h).to_proto())
        assert pv.hash() == rv.hash() == \
            pn.state_store.load_validators(h).hash()
        assert [(v.address, v.pub_key.bytes(), v.voting_power)
                for v in pv.validators] == \
            [(v.address, v.pub_key.bytes(), v.voting_power)
             for v in rv.validators]
    # absent and nil slots, and an aggregate commit
    commit = pn.block_store.load_block_commit(2)
    sigs = list(commit.signatures)
    sigs[1] = p_commit.CommitSig.absent()
    sigs[2] = p_commit.CommitSig(p_vote.BLOCK_ID_FLAG_NIL,
                                 sigs[2].validator_address,
                                 sigs[2].timestamp, sigs[2].signature)
    odd = p_commit.Commit(commit.height, commit.round, commit.block_id,
                          sigs)
    js = json.loads(json.dumps(p_core._commit_json(odd)))
    rjs = json.loads(json.dumps(r_core._commit_json(
        r_commit.Commit.from_proto(odd.to_proto()))))
    assert js == rjs
    assert p_encode(p_pb.COMMIT, p_client.commit_from_json(js).to_proto()) \
        == r_encode(r_pb.COMMIT, r_client.commit_from_json(js).to_proto()) \
        == p_encode(p_pb.COMMIT, odd.to_proto())
    signers = p_bits.BitArray(10)
    for i in (0, 3, 9):
        signers.set_index(i, True)
    agg = p_commit.AggregateCommit(height=4, round=1,
                                   block_id=commit.block_id,
                                   signers=signers, signature=b"\x07" * 96)
    js = json.loads(json.dumps(p_core._commit_json(agg)))
    back, rback = p_client.commit_from_json(js), r_client.commit_from_json(js)
    assert (back.height, back.round, back.signers_bytes(), back.signature) \
        == (rback.height, rback.round, rback.signers_bytes(),
            rback.signature) == (4, 1, agg.signers_bytes(), b"\x07" * 96)


def _trust(twins, h=1):
    meta = twins["p"].block_store.load_block_meta(h)
    return meta.block_id.hash


def test_http_provider_syncs_over_both_servers_as_the_jax_client(
        twins, stand_in):
    """The port's light client over HttpProviders (a port server primary,
    a JAX server with the lightserve routes witness; then the other way
    round) ends at the JAX client's trusted blocks, and every light block
    it brought equals the stores' own, byte for byte."""
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]
    ps, rs = _servers(loop, pn, rn)
    purl, rurl = f"http://127.0.0.1:{ps.port}", f"http://127.0.0.1:{rs.port}"
    period = 168 * 3600 * 10**9

    async def sync(light, provider, store, db, urls, mode, **kw):
        prov = [provider(u, CHAIN_ID) for u in urls]
        client = light.Client(
            CHAIN_ID, light.TrustOptions(period, 1, _trust(twins)), prov[0],
            prov[1:], store(db()), verification_mode=mode, **kw)
        await client.initialize()
        lb = await client.verify_light_block_at_height(TOP)
        return client, prov, lb

    try:
        for mode in (p_light.SEQUENTIAL, p_light.SKIPPING):
            for urls in ((purl, rurl), (rurl, purl)):
                mine, provs, lb = loop.run_until_complete(sync(
                    p_light, PHttpProvider, PTrustedStore, PMemDB, urls,
                    mode, device="cpu"))
                theirs, _, rlb = loop.run_until_complete(sync(
                    r_light, RHttpProvider, RTrustedStore, RMemDB, urls,
                    mode))
                # the same trusted blocks: signed headers byte for byte,
                # validator sets by hash (the JAX codec recomputes the
                # priorities, the port's keeps the server's)
                assert mine.store.heights() == theirs.store.heights()
                for a, b in [(lb, rlb)] + [
                        (mine.store.light_block(h),
                         theirs.store.light_block(h))
                        for h in mine.store.heights()]:
                    assert p_encode(p_pb.SIGNED_HEADER,
                                    a.signed_header.to_proto()) == \
                        r_encode(r_pb.SIGNED_HEADER,
                                 b.signed_header.to_proto())
                    assert a.validator_set.hash() == b.validator_set.hash()
                # both servers served light_block: no fallback to /commit
                # and /validators
                assert provs[0]._has_light_block
                for h in range(1, TOP + 1):
                    got = loop.run_until_complete(provs[0].light_block(h))
                    want_vals = pn.state_store.load_validators(h)
                    assert p_encode(p_pb.SIGNED_HEADER,
                                    got.signed_header.to_proto()) == \
                        p_encode(p_pb.SIGNED_HEADER, p_client.SignedHeader(
                            header=pn.block_store.load_block_meta(h).header,
                            commit=pn.block_store.load_block_commit(h) or
                            pn.block_store.load_seen_commit(h)).to_proto())
                    assert p_encode(p_pb.VALIDATOR_SET,
                                    got.validator_set.to_proto()) == \
                        p_encode(p_pb.VALIDATOR_SET, want_vals.to_proto())
    finally:
        loop.run_until_complete(ps.stop())
        loop.run_until_complete(rs.stop())
    assert stand_in["launches"] > 0


def _state_at(chain, h):
    """The State a statesync at h bootstraps, from the chain's own stores
    through a StateProvider over a NodeProvider."""
    from cometbft_tpu_torch.light.provider import NodeProvider
    from cometbft_tpu_torch.statesync import StateProvider
    period = 168 * 3600 * 10**9

    async def run():
        prov = NodeProvider(chain.block_store, chain.state_store, CHAIN_ID)
        lc = p_light.Client(CHAIN_ID, p_light.TrustOptions(
            period, 1, chain.block_store.load_block_meta(1).block_id.hash),
            prov, [], PTrustedStore(PMemDB()), device="cpu")
        await lc.initialize()
        return await StateProvider(lc, CHAIN_ID, chain.doc).state(h)
    return asyncio.run(run())


def test_new_rpc_state_provider_equals_the_jax_one(twins, stand_in):
    loop, pn, rn = twins["loop"], twins["pn"], twins["rn"]
    ps, rs = _servers(loop, pn, rn)
    urls = [f"http://127.0.0.1:{ps.port}", f"http://127.0.0.1:{rs.port}"]
    h = TOP - 2

    async def run():
        mine = await p_syncer.new_rpc_state_provider(
            CHAIN_ID, twins["p"].doc, urls, 1, _trust(twins), device="cpu")
        theirs = await r_syncer.new_rpc_state_provider(
            CHAIN_ID, twins["r"].doc, urls, 1, _trust(twins))
        return (await mine.state(h), await theirs.state(h),
                await mine.commit(h), await theirs.commit(h),
                await mine.app_hash(h), await theirs.app_hash(h))
    try:
        pst, rst, pc, rc, pa, ra = loop.run_until_complete(run())
        with pytest.raises(p_syncer.StatesyncError,
                           match="^statesync needs at least one RPC server$"):
            loop.run_until_complete(p_syncer.new_rpc_state_provider(
                CHAIN_ID, twins["p"].doc, [], 1, b"", device="cpu"))
    finally:
        loop.run_until_complete(ps.stop())
        loop.run_until_complete(rs.stop())
    # the port's state is the chain's own, byte for byte (its validator
    # sets' priorities came through the codec as stored); the JAX one
    # differs only in the priorities its codec recomputes
    want = twins["p"].state_store.load()
    assert pst.bytes() == _state_at(twins["p"], h).bytes()
    for name in ("chain_id", "last_block_height", "app_hash",
                 "last_results_hash", "last_height_validators_changed",
                 "last_height_consensus_params_changed"):
        assert getattr(pst, name) == getattr(rst, name), name
    assert p_encode(p_pb.BLOCK_ID, pst.last_block_id.to_proto()) == \
        r_encode(r_pb.BLOCK_ID, rst.last_block_id.to_proto())
    assert (pst.last_block_time.seconds, pst.last_block_time.nanos) == \
        (rst.last_block_time.seconds, rst.last_block_time.nanos)
    for name in ("last_validators", "validators", "next_validators"):
        assert getattr(pst, name).hash() == getattr(rst, name).hash()
    assert pst.consensus_params.hash() == rst.consensus_params.hash()
    assert want.last_block_height == TOP
    assert p_encode(p_pb.COMMIT, pc.to_proto()) == \
        r_encode(r_pb.COMMIT, rc.to_proto())
    assert pa == ra == twins["p"].block_store.load_block_meta(h + 1) \
        .header.app_hash


def test_loadtime_generate_and_report_against_a_port_node(twins):
    loop, pn = twins["loop"], twins["pn"]
    ps = p_server.RPCServer(pn, PRPCConfig(laddr="tcp://127.0.0.1:0"))
    loop.run_until_complete(ps.start())
    url = f"http://127.0.0.1:{ps.port}"
    before = pn.mempool.size()
    try:
        res = loop.run_until_complete(p_loadtime.generate(
            [url], rate=40, duration_s=0.5, size=300,
            experiment_id="exp-gen", method="async"))
        for _ in range(50):
            loop.run_until_complete(asyncio.sleep(0.01))
        rep = loop.run_until_complete(p_loadtime.report(url, "exp-rpc"))
        check = loop.run_until_complete(p_loadtime.selfcheck(
            rate=40, duration_s=0.5, connections=1))
    finally:
        loop.run_until_complete(ps.stop())
    assert res.sent == res.accepted > 10 and res.errors == 0
    assert pn.mempool.size() - before == res.accepted
    assert rep.experiment_id == "exp-rpc" and rep.latency.count == 1
    assert rep.heights == TOP and rep.block_interval.count == TOP - 1
    assert check["requested"] == 20 and check["offered_ratio"] >= 0.9


# -- chip_smoke.py's phase 16, rehearsed ------------------------------------------

def test_phase_16_rehearsed_at_12_validators(monkeypatch):
    """Phases 15 and 16 at 12 validators with B1 replaced by a memoised
    golden-model check that counts a launch a tile (so 16e's corrupted
    signature is refused) and calls a kernel named ``raising`` when 16e
    installs one: 16a's HTTP light syncs over 15a's 17-height source, 16b's
    RPC state provider, 16c's FilePVs and signer process over 5 heights,
    16d's load over HTTP, and 16e's outcomes with the JAX texts."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    monkeypatch.setattr(cs, "_device_busy",
                        lambda fn: (fn(), (1.0, None, None, 0))[1])
    for name, value in (("EXEC_VALIDATORS", 12), ("EXEC_UPDATES", (2, 3, 4)),
                        ("EXEC_TXS", 5), ("SS_HEIGHTS", 17),
                        ("SS_INTERVAL", 6), ("SS_RETAIN", 8),
                        ("SS_TRUST", 10), ("SS_DISCOVERY_NS", 5 * 10**8),
                        ("PV_HEIGHTS", 5), ("RPC_LOAD_RATE", 30),
                        ("RPC_LOAD_SECONDS", 1.0), ("RPC_TX_HEIGHTS", 5)):
        monkeypatch.setattr(cs, name, value)
    memo = {}

    def verify_batch(items, device=None, **kw):
        mod = ek8 if os.environ.get(oe.KERNEL_ENV) == "cuda8" else ek
        if mod.verify_cols.__name__ == "raising":
            mod.verify_cols()
        mod.launches += len(tile_plan(len(items), DEFAULT_TILE))
        mask = []
        for item in items:
            if item not in memo:
                memo[item] = ref.verify(*item)
            mask.append(memo[item])
        return all(mask), mask

    monkeypatch.setattr(oe, "verify_batch", verify_batch)
    keep = {}
    cs._statesync_phases(0, "CPU", keep, device="cpu")
    launches, launches8 = cs._rpc_phases(0, "CPU", keep, device="cpu")
    assert set(launches) == {"rpc_light_12x17", "rpc_statesync_12x17",
                             "privval_4x5", "rpc_tx_4x5", "rpc_reject"}
    # sequential: one a hop; skipping 10 -> 17: the root's set's third,
    # then the new set's two thirds
    assert launches["rpc_light_12x17"] == 7 + 2
    # H+1 from the root: 2; H from the root: 2; H+2: 1
    assert launches["rpc_statesync_12x17"] == 5
    assert launches["privval_4x5"] > 0 and launches["rpc_reject"] > 0
    assert launches8 == {"rpc_reject_cuda8": launches8["rpc_reject_cuda8"]}
    assert launches8["rpc_reject_cuda8"] > 0


def test_phase_17_rehearsed_at_12_validators(monkeypatch):
    """Phase 17 at 12 validators over phase 15's 17-height source, with B1
    replaced by the memoised golden-model check of phase 16's rehearsal
    (15c installs a kernel named ``raising``):
    17a's syncs over lightserve servers (one round trip a light block,
    B1's launches equal NodeProvider's, cache hits on the second pass)
    against NodeProviders and the fallback, 17b's proofs and refusals,
    17c's pin, 17d's proxy and forged tx, 17e's repairs."""
    from cometbft_tpu_torch.crypto import _ed25519_ref as ref
    from cometbft_tpu_torch.crypto.pipeline import DEFAULT_TILE, tile_plan
    from cometbft_tpu_torch.ops import ed25519 as oe
    from cometbft_tpu_torch.ops import ed25519_kernel as ek
    from cometbft_tpu_torch.ops import ed25519_kernel8 as ek8
    monkeypatch.setattr(cs, "_device_busy",
                        lambda fn: (fn(), (1.0, None, None, 0))[1])
    for name, value in (("EXEC_VALIDATORS", 12), ("EXEC_UPDATES", (2, 3, 4)),
                        ("EXEC_TXS", 5), ("SS_HEIGHTS", 17),
                        ("SS_INTERVAL", 6), ("SS_RETAIN", 8),
                        ("SS_TRUST", 10), ("SS_DISCOVERY_NS", 5 * 10**8),
                        ("LS_VERSION", 13), ("LS_PRESENT", 64),
                        ("LS_ABSENT", 4), ("LS_MP_PICK", 3), ("LS_PIN", 14),
                        ("LS_PROXY_HEIGHTS", (12, 14, 17))):
        monkeypatch.setattr(cs, name, value)
    memo = {}

    def verify_batch(items, device=None, **kw):
        mod = ek8 if os.environ.get(oe.KERNEL_ENV) == "cuda8" else ek
        if mod.verify_cols.__name__ == "raising":
            mod.verify_cols()
        mod.launches += len(tile_plan(len(items), DEFAULT_TILE))
        mask = []
        for item in items:
            if item not in memo:
                memo[item] = ref.verify(*item)
            mask.append(memo[item])
        return all(mask), mask

    monkeypatch.setattr(oe, "verify_batch", verify_batch)
    keep = {}
    cs._statesync_phases(0, "CPU", keep, device="cpu")
    launches, launches8 = cs._lightserve_phases(0, "CPU", keep,
                                                device="cpu")
    assert set(launches) == {"rpc_lightserve_12x17", "state_proofs_12x17",
                             "light_proxy_12x17", "repairs_4x3"}
    # the sequential and skipping syncs as over NodeProvider (7 + 2), and
    # the second client's sequential pass (7)
    assert launches["rpc_lightserve_12x17"] == 7 + 2 + 7
    assert launches["state_proofs_12x17"] > 0
    assert launches["light_proxy_12x17"] > 0 and launches["repairs_4x3"] > 0
    assert launches8 == {"state_proofs_12_cuda8":
                         launches8["state_proofs_12_cuda8"]}
    assert launches8["state_proofs_12_cuda8"] > 0
    src = keep["ss_src"]["chain"]
    assert src.block_store.height == 17 + cs.LS_PIN_HEIGHTS
    assert src.app.version_pin is None
