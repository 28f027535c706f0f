"""The mempool net of chip_smoke.py's 14c in both packages, on the CPU.

14c (config 1 over sockets, each node with a CListMempool at the
MempoolConfig defaults and a MempoolReactor, ConsensusConfig's default
timeouts, loadtime payloads round-robin through CheckTx) is bimodal on
the card: some runs commit empty blocks while thousands of txs wait.
The lead was that every loadtime tx writes the kvstore key ``a``, so
each commit touches the key every pending tx depends on and the
incremental recheck re-runs CheckTx on all of them.

``lead_net`` builds the same net in either package: n validators on
127.0.0.1 with a Switch, a ConsensusReactor, a MempoolReactor, a
CListMempool and a kvstore app, the port's on ``device="cpu"`` with the
accept-all stand-in kernel (the JAX package's on its CPU backend); it
submits loadtime payloads (``distinct=False``) or the same payloads each
under a key of its own, then waits for every pool to drain.  Run the
lead's measurement (12 validators, both packages, both tx kinds) with

    cd tests && PYTHONPATH=.. JAX_PLATFORMS=cpu python -c \\
        'import test_torch_mempool_lead as t; t.main()'

for 100 tx/s over 5 s, and with ``t.main(rate=400, seconds=10.0)`` for
the stall.  At 100 tx/s both packages drain 500 txs with either kind of
key; at 400 tx/s neither commits a block until the load ends, with
either kind of key (ROADMAP.md §C): the key ``a`` is not the cause.
The JAX package verifies each vote on the CPU (OpenSSL, a few hundred
microseconds a signature here) where the port's stand-in is free; the
port stalls all the same, so verification is not what holds consensus
back.  The test below runs the net at 4 validators in both packages
with both kinds of key.
"""
import asyncio
import collections
import time

import numpy as np
import pytest
import torch

from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.config import ConsensusConfig as RConsensusConfig
from cometbft_tpu.config import MempoolConfig as RMempoolConfig
from cometbft_tpu.consensus.reactor import ConsensusReactor as RCReactor
from cometbft_tpu.consensus.replay import Handshaker as RHandshaker
from cometbft_tpu.consensus.state import ConsensusState as RConsensusState
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.mempool import CListMempool as RCListMempool
from cometbft_tpu.mempool.mempool import MempoolError as RMempoolError
from cometbft_tpu.mempool.reactor import MempoolReactor as RMReactor
from cometbft_tpu.p2p.key import NodeKey as RNodeKey
from cometbft_tpu.p2p.switch import Switch as RSwitch
from cometbft_tpu.state import make_genesis_state as r_make_genesis_state
from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.tools import loadtime as r_loadtime
from cometbft_tpu.types import vote as r_vote_mod
from cometbft_tpu.types.genesis import GenesisDoc as RGenesisDoc
from cometbft_tpu.types.genesis import GenesisValidator as RGenesisValidator
from cometbft_tpu.types.priv_validator import MockPV as RMockPV
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.config import ConsensusConfig, MempoolConfig
from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
from cometbft_tpu_torch.consensus.replay import Handshaker
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.crypto import ed25519 as p_ed
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.mempool.mempool import MempoolError
from cometbft_tpu_torch.mempool.reactor import MempoolReactor
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.ops import ed25519_kernel as ek
from cometbft_tpu_torch.p2p import NodeKey, Switch
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.tools import loadtime
from cometbft_tpu_torch.types import vote as vote_mod
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.priv_validator import MockPV
from cometbft_tpu_torch.types.timestamp import Timestamp
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "mempool-lead"
TX_BYTES = 1024             # 14c's loadtime size

PORT = dict(KVStore=KVStoreApplication, AppConns=AppConns, MemDB=MemDB,
            Store=Store, BlockStore=BlockStore, genesis=make_genesis_state,
            CListMempool=CListMempool, MempoolConfig=MempoolConfig,
            BlockExecutor=BlockExecutor, ConsensusState=ConsensusState,
            ConsensusConfig=ConsensusConfig, Switch=Switch,
            NodeKey=NodeKey, CReactor=ConsensusReactor,
            MReactor=MempoolReactor, MempoolError=MempoolError,
            loadtime=loadtime, ed=p_ed, MockPV=MockPV, GenesisDoc=GenesisDoc,
            GenesisValidator=GenesisValidator, Timestamp=Timestamp,
            Handshaker=Handshaker, abci=abci, device={"device": "cpu"})
JAX = dict(KVStore=RKVStore, AppConns=RAppConns, MemDB=RMemDB, Store=RStore,
           BlockStore=RBlockStore, genesis=r_make_genesis_state,
           CListMempool=RCListMempool, MempoolConfig=RMempoolConfig,
           BlockExecutor=RBlockExecutor, ConsensusState=RConsensusState,
           ConsensusConfig=RConsensusConfig, Switch=RSwitch,
           NodeKey=RNodeKey, CReactor=RCReactor, MReactor=RMReactor,
           MempoolError=RMempoolError, loadtime=r_loadtime, ed=r_ed,
           MockPV=RMockPV, GenesisDoc=RGenesisDoc,
           GenesisValidator=RGenesisValidator, Timestamp=RTimestamp,
           Handshaker=RHandshaker, abci=r_abci, device={})
SIDES = {"port": PORT, "jax": JAX}


def _stand_in(a, r, s, k):
    """The accept-all stand-in kernel."""
    ek.launches += 1
    return torch.ones(a.shape[1], dtype=torch.bool)


async def _node(s, doc, pv, key_seed):
    node = type("Node", (), {})()
    app = s["KVStore"](db=s["MemDB"]())
    node.conns = s["AppConns"](app)
    node.state_store = s["Store"](s["MemDB"]())
    node.block_store = s["BlockStore"](s["MemDB"]())
    state = s["genesis"](doc)
    node.state_store.save(state)
    await s["Handshaker"](node.state_store, state, node.block_store, doc,
                          **s["device"]).handshake(node.conns)
    state = node.state_store.load()
    info = await node.conns.query.info(s["abci"].InfoRequest())
    mcfg = s["MempoolConfig"]()
    node.mempool = s["CListMempool"](mcfg, node.conns.mempool,
                                     lanes=info.lane_priorities,
                                     default_lane=info.default_lane)
    node.exec = s["BlockExecutor"](node.state_store, node.conns.consensus,
                                   mempool=node.mempool,
                                   block_store=node.block_store,
                                   **s["device"])
    node.cs = s["ConsensusState"](s["ConsensusConfig"](), state, node.exec,
                                  node.block_store, priv_validator=pv,
                                  **s["device"])
    node.switch = s["Switch"](s["NodeKey"](s["ed"].Ed25519PrivKey(key_seed)),
                              doc.chain_id, listen_addr="127.0.0.1:0")
    node.switch.add_reactor(s["CReactor"](node.cs))
    node.switch.add_reactor(s["MReactor"](node.mempool, mcfg))
    await node.switch.start()
    return node


def _txs(s, n_txs, distinct, rate, connections):
    """Loadtime payloads of TX_BYTES (every one under the key ``a``), or
    the same payloads each under a key of its own."""
    out = []
    for i in range(n_txs):
        tx = s["loadtime"].payload_bytes("lead", size=TX_BYTES, rate=rate,
                                         connections=connections)
        if distinct:
            key = b"k%06d" % i
            tx = key + tx[1:len(tx) - len(key) + 1]
        out.append(tx)
    return out


async def lead_net(side, n, distinct, rate, seconds, timeout_s=120.0,
                   seed=0):
    """Run the net; returns {"drained", "heights", "txs_a_block",
    "rounds", "empty_while_pending", "tx_per_s", "accepted", "refused"}."""
    s = SIDES[side]
    rng = np.random.default_rng(seed)
    keys = [rng.bytes(32) for _ in range(2 * n)]
    pvs = [s["MockPV"](s["ed"].Ed25519PrivKey(k)) for k in keys[:n]]
    doc = s["GenesisDoc"](
        chain_id=CHAIN_ID, genesis_time=s["Timestamp"](1_700_000_000, 0),
        validators=[s["GenesisValidator"](b"", pv.get_pub_key(), 10)
                    for pv in pvs])
    nodes = [await _node(s, doc, pv, keys[n + i])
             for i, pv in enumerate(pvs)]
    pending_at, seen_at = {}, {}
    try:
        for i, node in enumerate(nodes):
            for other in nodes[i + 1:]:
                await node.switch.dial_peer(other.switch.listen_addr)
        deadline = time.perf_counter() + 30
        while not all(nd.switch.num_peers() == n - 1 for nd in nodes):
            assert time.perf_counter() < deadline, "mesh"
            await asyncio.sleep(0.01)

        async def watch():
            seen = 0
            while True:
                h = nodes[0].block_store.height
                if h > seen:
                    pending_at[h] = sum(nd.mempool.size() for nd in nodes)
                    seen_at[h] = time.perf_counter()
                    seen = h
                await asyncio.sleep(0.005)
        watcher = asyncio.ensure_future(watch())
        for node in nodes:
            await node.cs.start()
        txs = _txs(s, int(rate * seconds), distinct, rate, n)
        accepted, refused = [], collections.Counter()
        t0 = time.perf_counter()
        for i, tx in enumerate(txs):
            delay = t0 + i / rate - time.perf_counter()
            if delay > 0:
                await asyncio.sleep(delay)
            try:
                await nodes[i % n].mempool.check_tx(tx)
                accepted.append(tx)
            except s["MempoolError"] as e:
                refused[type(e).__name__] += 1
        deadline = t0 + timeout_s
        while time.perf_counter() < deadline and not all(
                nd.mempool.size() == 0 for nd in nodes):
            await asyncio.sleep(0.05)
        drained = all(nd.mempool.size() == 0 for nd in nodes)
        elapsed = time.perf_counter() - t0
        watcher.cancel()
    finally:
        for node in nodes:
            try:
                await node.cs.stop()
            finally:
                await node.switch.stop()
    store = nodes[0].block_store
    top = store.height
    per_block = [len(store.load_block(h).data.txs) for h in range(1, top + 1)]
    rounds = [store.load_block(h + 1).last_commit.round if h < top else
              store.load_seen_commit(h).round for h in range(1, top + 1)]
    committed = sum(per_block)
    return {"drained": drained, "heights": top, "txs_a_block": per_block,
            "rounds": rounds, "accepted": len(accepted),
            "refused": dict(refused), "committed": committed,
            "empty_while_pending": sum(
                1 for h in range(2, top + 1)
                if per_block[h - 1] == 0 and pending_at.get(h - 1, 0) > 0),
            "tx_per_s": committed / elapsed, "seconds": elapsed,
            "committed_at_s": [round(seen_at[h] - t0, 2)
                               for h in sorted(seen_at)]}


def _run(side, *a, **kw):
    loop = asyncio.new_event_loop()
    r_batch.set_backend("cpu")
    real = ek.verify_cols
    ek.verify_cols = _stand_in
    for mod in (vote_mod, r_vote_mod):
        mod._VERIFIED.clear()
        mod._REJECTED.clear()
    try:
        return loop.run_until_complete(lead_net(side, *a, **kw))
    finally:
        ek.verify_cols = real
        r_batch.set_backend("auto")
        pipeline.reset_workers()
        oe.reset_bucket_tuning()
        loop.close()


def main(n=12, rate=100, seconds=5.0, timeout_s=120.0):
    """The lead's measurement: 12 validators in each package, loadtime
    txs (every one under the key ``a``) and distinct keys."""
    for side in ("port", "jax"):
        for distinct in (False, True):
            out = _run(side, n, distinct, rate, seconds, timeout_s)
            print(f"{side} n={n} {'distinct keys' if distinct else 'key a'}"
                  f" {rate} tx/s x {seconds} s: drained {out['drained']} in "
                  f"{out['seconds']:.1f} s, {out['committed']} of "
                  f"{out['accepted']} accepted committed "
                  f"({out['tx_per_s']:.1f} tx/s), {out['heights']} heights, "
                  f"txs a block {out['txs_a_block']} committed at "
                  f"{out['committed_at_s']} s, rounds above 0 "
                  f"{sum(r > 0 for r in out['rounds'])} (max "
                  f"{max(out['rounds'])}), empty blocks while txs waited "
                  f"{out['empty_while_pending']}, refused {out['refused']}",
                  flush=True)


@pytest.mark.parametrize("side", ["port", "jax"])
@pytest.mark.parametrize("distinct", [False, True], ids=["key_a", "keyed"])
def test_mempool_net_drains_at_4_validators(side, distinct):
    out = _run(side, 4, distinct, 40, 1.0, timeout_s=60.0)
    assert out["drained"] and out["committed"] == out["accepted"] == 40
