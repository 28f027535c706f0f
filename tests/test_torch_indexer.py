"""The port's kv indexers and IndexerService (cometbft_tpu_torch/indexer/)
against the JAX package's: the JAX TestIndexer cases on both, equal rows
for equal events, equal answers to a seeded set of tx and block searches,
equal rows after prune, and the service fed by each package's EventBus.
"""
import asyncio

import numpy as np
import pytest

from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.indexer import kv as r_kv
from cometbft_tpu.indexer import service as r_service
from cometbft_tpu.libs import pubsub as r_pubsub
from cometbft_tpu.types import events as r_events
from cometbft_tpu.types import tx as r_tx
from cometbft_tpu_torch.abci import types as p_abci
from cometbft_tpu_torch.db import MemDB as PMemDB
from cometbft_tpu_torch.indexer import kv as p_kv
from cometbft_tpu_torch.indexer import service as p_service
from cometbft_tpu_torch.libs import pubsub as p_pubsub
from cometbft_tpu_torch.types import events as p_events
from cometbft_tpu_torch.types import tx as p_tx

from torch_helpers import one_torch_thread  # noqa: F401


class Pkg:
    def __init__(self, name, abci, db, kv, service, pubsub, events, tx):
        self.name, self.abci, self.MemDB, self.kv = name, abci, db, kv
        self.service, self.pubsub, self.events, self.tx = \
            service, pubsub, events, tx


PORT = Pkg("port", p_abci, PMemDB, p_kv, p_service, p_pubsub, p_events, p_tx)
JAX = Pkg("jax", r_abci, RMemDB, r_kv, r_service, r_pubsub, r_events, r_tx)
BOTH = pytest.mark.parametrize("pkg", [PORT, JAX], ids=["port", "jax"])


@BOTH
def test_tx_index_and_search(pkg):
    abci, Query = pkg.abci, pkg.pubsub.Query
    txi = pkg.kv.TxIndexer(pkg.MemDB())
    res = abci.ExecTxResult(code=0, events=[abci.Event(
        type="app", attributes=[
            abci.EventAttribute("key", "alice", True),
            abci.EventAttribute("noindex", "x", False)])])
    txi.index(abci.TxResult(height=7, index=0, tx=b"alice=1", result=res))
    h = pkg.tx.tx_hash(b"alice=1")
    got = txi.get(h)
    assert got is not None and got.height == 7
    assert got.result.events[0].attributes[0].value == "alice"
    assert txi.search(Query("app.key = 'alice'")) == [h]
    assert txi.search(Query("app.noindex = 'x'")) == []
    assert txi.search(Query("tx.height = 7")) == [h]
    assert txi.search(Query("tx.height > 7")) == []


@BOTH
def test_block_index_and_search(pkg):
    abci, Query = pkg.abci, pkg.pubsub.Query
    bi = pkg.kv.BlockIndexer(pkg.MemDB())
    bi.index(5, [abci.Event(type="begin_event", attributes=[
        abci.EventAttribute("foo", "100", True)])])
    bi.index(6, [abci.Event(type="begin_event", attributes=[
        abci.EventAttribute("foo", "200", True)])])
    assert bi.search(Query("begin_event.foo = '100'")) == [5]
    assert bi.search(Query("block.height > 5")) == [6]
    assert bi.search(Query(
        "begin_event.foo = '200' AND block.height = 6")) == [6]


TYPES = ("transfer", "message", "app")
KEYS = ("sender", "amount", "action", "memo")


def _events(pkg, rng, n):
    abci = pkg.abci
    out = []
    for _ in range(n):
        attrs = []
        for _ in range(int(rng.integers(1, 4))):
            key = KEYS[int(rng.integers(0, len(KEYS)))]
            value = str(int(rng.integers(0, 30))) if key == "amount" else \
                f"v{int(rng.integers(0, 6))}"
            attrs.append(abci.EventAttribute(key, value,
                                             bool(rng.integers(0, 4))))
        out.append(abci.Event(type=TYPES[int(rng.integers(0, len(TYPES)))],
                              attributes=attrs))
    return out


def _history(pkg, seed, heights=12):
    """Seeded tx results and block events, the same in each package: a
    few txs a height, one re-committed at a later height, some without
    events."""
    rng = np.random.default_rng(seed)
    txs, blocks = [], []
    for h in range(1, heights + 1):
        blocks.append((h, _events(pkg, rng, int(rng.integers(0, 3)))))
        for i in range(int(rng.integers(1, 4))):
            tx = b"tx-%d-%d" % (h, i) if not (h == 9 and i == 0) else \
                b"tx-3-0"
            res = pkg.abci.ExecTxResult(
                code=int(rng.integers(0, 2)), data=rng.bytes(3),
                log=f"log{h}", gas_wanted=int(rng.integers(0, 9)),
                gas_used=int(rng.integers(0, 9)),
                events=_events(pkg, rng, int(rng.integers(0, 3))))
            txs.append(pkg.abci.TxResult(height=h, index=i, tx=tx,
                                         result=res))
    return txs, blocks


def _indexed(pkg, seed):
    txi = pkg.kv.TxIndexer(pkg.MemDB())
    bi = pkg.kv.BlockIndexer(pkg.MemDB())
    txs, blocks = _history(pkg, seed)
    for tr in txs:
        txi.index(tr)
    for h, evs in blocks:
        bi.index(h, evs)
    return txi, bi


def _rows(indexer):
    return list(indexer._db.iterator())


def _queries(seed, n=40):
    rng = np.random.default_rng(seed + 100)
    out = []
    for _ in range(n):
        conds = []
        for _ in range(int(rng.integers(1, 3))):
            kind = int(rng.integers(0, 6))
            t, k = TYPES[int(rng.integers(0, 3))], \
                KEYS[int(rng.integers(0, 4))]
            if kind == 0:
                conds.append(f"{t}.{k} = 'v{int(rng.integers(0, 6))}'")
            elif kind == 1:
                op = ("<", "<=", ">", ">=", "=")[int(rng.integers(0, 5))]
                conds.append(f"{t}.amount {op} {int(rng.integers(0, 30))}")
            elif kind == 2:
                conds.append(f"{t}.{k} EXISTS")
            elif kind == 3:
                conds.append(f"{t}.{k} CONTAINS 'v'")
            elif kind == 4:
                op = ("<", ">=", "=")[int(rng.integers(0, 3))]
                conds.append(f"HEIGHT {op} {int(rng.integers(1, 13))}")
            else:
                conds.append(f"{t}.memo = 'v{int(rng.integers(0, 6))}'")
        out.append(" AND ".join(conds))
    return out


def _tx_query(q):
    return q.replace("HEIGHT", "tx.height")


def _block_query(q):
    return q.replace("HEIGHT", "block.height")


@pytest.mark.parametrize("seed", [0, 1])
def test_rows_and_searches_equal_the_jax_ones(seed):
    (ptx, pbl), (rtx, rbl) = _indexed(PORT, seed), _indexed(JAX, seed)
    assert _rows(ptx) == _rows(rtx)
    assert _rows(pbl) == _rows(rbl)
    hits = 0
    for q in _queries(seed):
        mine = ptx.search(p_pubsub.Query(_tx_query(q)))
        theirs = rtx.search(r_pubsub.Query(_tx_query(q)))
        assert sorted(mine) == sorted(theirs), q
        assert ptx.search(p_pubsub.Query(_tx_query(q)), limit=2) == \
            mine[:2]
        assert pbl.search(p_pubsub.Query(_block_query(q))) == \
            rbl.search(r_pubsub.Query(_block_query(q))), q
        hits += bool(mine)
        for h in mine:
            a, b = ptx.get(h), rtx.get(h)
            assert (a.height, a.index, a.tx, a.result.code, a.result.data,
                    a.result.log, len(a.result.events)) == \
                (b.height, b.index, b.tx, b.result.code, b.result.data,
                 b.result.log, len(b.result.events))
    assert hits > 10


@pytest.mark.parametrize("lo, hi", [(1, 4), (3, 10), (1, 13), (5, 5)])
def test_rows_after_prune_equal_the_jax_ones(lo, hi):
    (ptx, pbl), (rtx, rbl) = _indexed(PORT, 2), _indexed(JAX, 2)
    assert ptx.prune(lo, hi) == rtx.prune(lo, hi)
    assert pbl.prune(lo, hi) == rbl.prune(lo, hi)
    assert _rows(ptx) == _rows(rtx)
    assert _rows(pbl) == _rows(rbl)
    # a second pass over the same range finds nothing more
    assert ptx.prune(lo, hi) == rtx.prune(lo, hi) == 0


def test_indexer_service_rows_equal_the_jax_ones():
    async def run(pkg):
        bus = pkg.events.EventBus()
        txi = pkg.kv.TxIndexer(pkg.MemDB())
        bi = pkg.kv.BlockIndexer(pkg.MemDB())
        svc = pkg.service.IndexerService(txi, bi, bus)
        await svc.start()
        txs, blocks = _history(pkg, 3)
        for h, evs in blocks:
            for tr in (t for t in txs if t.height == h):
                bus.publish_tx(tr.height, tr.index, tr.tx, tr.result,
                               tr.result.events)
            bus.publish_new_block_events(h, evs, 0)
        for _ in range(50):
            await asyncio.sleep(0)
        await svc.stop()
        return _rows(txi), _rows(bi)
    mine, theirs = asyncio.run(run(PORT)), asyncio.run(run(JAX))
    assert mine == theirs and mine[0] and mine[1]


def test_searches_past_one_hundred_matches_page_over_every_one():
    """The port's tx_search and block_search page over every match; the
    JAX routes stop at the indexer's default cap of 100 (ROADMAP.md
    section C)."""
    from cometbft_tpu.rpc import core as r_core
    from cometbft_tpu_torch.rpc import core as p_core

    class Node:
        class block_store:            # the pages' blocks are not asked for
            load_block_meta = load_block = staticmethod(lambda h: None)
    outs = {}
    for name, pkg, core in (("port", PORT, p_core), ("jax", JAX, r_core)):
        node = Node()
        node.tx_indexer = pkg.kv.TxIndexer(pkg.MemDB())
        node.block_indexer = pkg.kv.BlockIndexer(pkg.MemDB())
        for i in range(150):
            node.tx_indexer.index(pkg.abci.TxResult(
                height=5, index=i, tx=b"tx-%d" % i,
                result=pkg.abci.ExecTxResult()))
        for h in range(1, 131):
            node.block_indexer.index(h, [])
        routes = core.routes(core.Environment(node))
        pages = [asyncio.run(routes["tx_search"](
            query="tx.height = 5", page=str(p), per_page="100"))
            for p in (1, 2)]
        blocks = asyncio.run(routes["block_search"](
            query="block.height >= 1", per_page="100", page="2"))
        outs[name] = ([r["total_count"] for r in pages],
                      [len(r["txs"]) for r in pages],
                      blocks["total_count"], len(blocks["blocks"]))
    assert outs["port"] == (["150", "150"], [100, 50], "130", 0)
    assert outs["jax"] == (["100", "100"], [100, 0], "100", 0)
