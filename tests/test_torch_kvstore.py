"""The port's kvstore app (cometbft_tpu_torch/abci/kvstore.py) over its
state tree (statetree/tree.py) and the local ABCI clients
(abci/client.py) against the JAX package's:

  * the same txs at each height — kv pairs, 'k:v' forms, invalid txs,
    val= txs that add, re-power and remove (delete) validators, the load
    generator's 256-byte txs — through PrepareProposal, ProcessProposal,
    FinalizeBlock and Commit: the same app hash at every height, the same
    tx results, events and validator updates, the same Info;
  * queries: by key at the latest and at historical heights, a missing
    key, a height not yet committed, /val; CheckTx with its lanes;
  * a restart on the same db resumes at the same height and app hash;
  * ``StateTree`` roots at 0, 1 and 1,000 leaves, with deletes and
    historical reads, equal to the JAX package's tree;
  * /multistore proofs wait for ROADMAP A.7b': the port says so.

Inputs come from seeded numpy generators; equality is exact.
"""
import asyncio
import base64

import numpy as np
import pytest

from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.abci.kvstore import make_val_set_change_tx as r_val_tx
from cometbft_tpu.crypto import ed25519 as r_ed
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.statetree import StateTree as RStateTree
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import AppConns, UnsyncLocalClient
from cometbft_tpu_torch.abci.kvstore import (
    KVStoreApplication, make_val_set_change_tx,
)
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.statetree import StateTree
from cometbft_tpu_torch.types.timestamp import Timestamp
from torch_chain import cs
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

PORT = (abci, KVStoreApplication, AppConns, MemDB, Timestamp)
REF = (r_abci, RKVStore, RAppConns, RMemDB, RTimestamp)


def _keys(n, seed):
    rng = np.random.default_rng(seed)
    return [r_ed.Ed25519PrivKey(rng.bytes(32)).pub_key().bytes()
            for _ in range(n)]


def _heights():
    """The txs of each height."""
    vals = _keys(4, 301)
    rng = np.random.default_rng(302)
    out = []
    for h in range(1, 7):
        txs = [b"k%d=v%d" % (int(rng.integers(0, 5)), h) for _ in range(3)]
        txs += [b"key%d:val%d" % (h, h), b"bad", b"=x", b"a=b=c"]
        txs += [cs._load_tx(3, h, j) for j in range(2)]
        txs.append(b"%d=lane" % int(rng.integers(0, 100)))
        out.append(txs)
    for tx_list, (pub, power) in zip(out, [(vals[0], 10), (vals[1], 7),
                                           (vals[0], 12), (vals[1], 0),
                                           (vals[2], 5), (vals[2], 0)]):
        tx = make_val_set_change_tx("ed25519", pub, power)
        assert tx == r_val_tx("ed25519", pub, power)
        tx_list.append(tx)
    out[2].append(b"val=ed25519!notbase64!x")   # a malformed val= tx
    return vals, out


def _result(x):
    """A response as plain data (dataclasses of either package)."""
    if isinstance(x, (list, tuple)):
        return [_result(v) for v in x]
    if isinstance(x, dict):
        return {k: _result(v) for k, v in x.items()}
    if hasattr(x, "__dataclass_fields__"):
        return {k: _result(getattr(x, k)) for k in x.__dataclass_fields__}
    return x


def _drive(side, genesis_vals):
    """InitChain, then each height through the consensus conn; returns
    the per-height record and the app."""
    a, kv, conns_cls, mem, ts = side
    db = mem()
    app = kv(db=db)
    conns = conns_cls(app)
    rec = []

    async def go():
        init = await conns.consensus.init_chain(a.InitChainRequest(
            time=ts(1_700_000_000, 0), chain_id="kv-parity",
            validators=[a.ValidatorUpdate(power=10, pub_key_bytes=pub,
                                          pub_key_type="ed25519")
                        for pub in genesis_vals], initial_height=1))
        rec.append(("init", init.app_hash))
        _, heights = _heights()
        for h, txs in enumerate(heights, 1):
            prep = await conns.consensus.prepare_proposal(
                a.PrepareProposalRequest(max_tx_bytes=10**6, txs=txs,
                                         height=h))
            ok = await conns.consensus.process_proposal(
                a.ProcessProposalRequest(txs=prep.txs, height=h))
            raw = await conns.consensus.process_proposal(
                a.ProcessProposalRequest(txs=txs, height=h))
            fin = await conns.consensus.finalize_block(
                a.FinalizeBlockRequest(txs=prep.txs, height=h,
                                       time=ts(1_700_000_000 + h, 0)))
            com = await conns.consensus.commit()
            info = await conns.query.info(a.InfoRequest())
            rec.append((h, prep.txs, ok.status, raw.status, _result(fin),
                        com.retain_height, _result(info)))
        checks = [await conns.mempool.check_tx(a.CheckTxRequest(tx=tx))
                  for tx in heights[2] + [b"33=x", b"22=y", b"5=z"]]
        rec.append(("check", _result(checks)))
        queries = []
        for data, path, height in ((b"k1", "", 0), (b"k1", "", 2),
                                   (b"nope", "", 0), (b"k2", "", 99),
                                   (b"a", "", 4), (b"key3", "", 0)):
            queries.append(await conns.query.query(a.QueryRequest(
                data=data, path=path, height=height)))
        for pub in _keys(4, 301)[:3]:
            queries.append(await conns.query.query(a.QueryRequest(
                data=base64.b64encode(pub), path="/val")))
        rec.append(("query", _result(queries)))
        rec.append(("validators", sorted(_result(app.get_validators()),
                                         key=lambda d: d["pub_key_bytes"])))
        rec.append(("echo", (await conns.query.echo("hi")).message))
    asyncio.run(go())
    return rec, app, db


def test_app_hashes_results_and_queries_match():
    genesis_vals = _keys(2, 303)
    got, app, _ = _drive(PORT, genesis_vals)
    want, r_app, _ = _drive(REF, genesis_vals)
    assert len(got) == len(want) == 11
    for g, w in zip(got, want):
        assert g == w, g[0]
    assert app.tree.root() == r_app.tree.root()


def test_restart_resumes_at_the_same_height_and_hash():
    genesis_vals = _keys(2, 304)
    outs = []
    for side in (PORT, REF):
        _, app, db = _drive(side, genesis_vals)
        again = side[1](db=db)
        info = asyncio.run(again.info(side[0].InfoRequest()))
        assert info.last_block_height == 6
        assert info.last_block_app_hash == app.tree.root()
        outs.append((_result(info), sorted(
            _result(again.get_validators()),
            key=lambda d: d["pub_key_bytes"])))
    assert outs[0] == outs[1]


def test_unsync_client_and_multistore():
    app = KVStoreApplication()
    client = UnsyncLocalClient(app)
    resp = asyncio.run(client.check_tx(abci.CheckTxRequest(tx=b"k=v")))
    assert resp.is_ok() and resp.lane_id == "default"
    with pytest.raises(NotImplementedError, match="A.7b'"):
        asyncio.run(app.query(abci.QueryRequest(
            data=b'{"keys": []}', path="/multistore")))


@pytest.mark.parametrize("leaves", [0, 1, 1000])
def test_state_tree_roots_match(leaves):
    rng = np.random.default_rng(400 + leaves)
    pairs = [(b"key/%d/" % i + rng.bytes(int(rng.integers(0, 8))),
              rng.bytes(int(rng.integers(0, 40)))) for i in range(leaves)]
    trees = (StateTree(MemDB()), RStateTree(RMemDB()))
    roots = []
    for tree in trees:
        got = [tree.root()]
        for k, v in pairs:
            tree.set(k, v)
        got.append(tree.working_root(0))
        got.append(tree.commit(0, extra={"size": leaves}))
        # version 1: a third deleted, a third rewritten, a new key
        for i, (k, v) in enumerate(pairs):
            if i % 3 == 0:
                tree.delete(k)
            elif i % 3 == 1:
                tree.set(k, v + b"!")
        tree.set(b"fresh", b"1")
        got.append(tree.commit(1))
        got.append(tree.root(0))
        got.append([tree.get(k, 0) for k, _ in pairs[:50]])
        got.append([tree.get(k) for k, _ in pairs[:50]])
        got.append(tree.pairs(0)[:50])
        got.append((tree.total(), tree.total(0), tree.versions(),
                    tree.version_extra(0)))
        roots.append(got)
    assert roots[0] == roots[1]
    reopened = StateTree(trees[0]._db)
    assert reopened.root() == roots[0][3]
    assert reopened.latest_version == 1
