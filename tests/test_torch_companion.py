"""The port's data-companion surface against the JAX package's:

  * the pruner's three companion retain heights (ABCI results, tx index,
    block index) and the pass that prunes to them
    (state/pruner.py): tests/test_grpc_companion.py:133-184 in both
    packages, their checks and texts, the per-class watermarks and the
    per-pass bound, and a pass over twin stores leaving the same rows;
  * the companion services' bodies (rpc/grpc/services.py) over twin
    chains answer the dicts, statuses and texts the JAX gRPC server's
    handlers answer; over a real gRPC channel the port's server and
    clients interoperate with the JAX ones both ways (skipped only where
    ``grpc`` cannot be imported);
  * the SQL event sink (indexer/sink_sql.py) on sqlite3: the same schema,
    views and rows (timestamps aside) for the same events, the same
    pruning counts, and the JAX text for a PostgreSQL DSN without
    psycopg2.

The twin chains run the accept-all stand-in kernel (no signature decides
an outcome here).  Equality is exact.
"""
import asyncio

import pytest

from cometbft_tpu import version as r_version
from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.indexer import BlockIndexer as RBlockIndexer
from cometbft_tpu.indexer import TxIndexer as RTxIndexer
from cometbft_tpu.indexer import sink_sql as r_sink_sql
from cometbft_tpu.libs.pubsub import Query as RQuery
from cometbft_tpu.state import pruner as r_pruner
from cometbft_tpu.types.events import EventBus as REventBus
from cometbft_tpu_torch import version
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.indexer import BlockIndexer, TxIndexer
from cometbft_tpu_torch.indexer import sink_sql
from cometbft_tpu_torch.libs.pubsub import Query
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.rpc.grpc import pb as grpc_pb
from cometbft_tpu_torch.rpc.grpc import services
from cometbft_tpu_torch.state import pruner
from cometbft_tpu_torch.types.events import EventBus
from cometbft_tpu_torch.types.tx import tx_hash
from cometbft_tpu_torch.wire import encode
from torch_chain import RChain, accept_all, cs, port_chain, rows, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

PORT = {"abci": abci, "MemDB": MemDB, "TxIndexer": TxIndexer,
        "BlockIndexer": BlockIndexer, "Query": Query, "pruner": pruner,
        "sink_sql": sink_sql}
JAX = {"abci": r_abci, "MemDB": RMemDB, "TxIndexer": RTxIndexer,
       "BlockIndexer": RBlockIndexer, "Query": RQuery, "pruner": r_pruner,
       "sink_sql": r_sink_sql}
SIDES = {"port": PORT, "jax": JAX}
CHAIN_ID = "companion-parity"
N, TOP = 4, 8


@pytest.fixture(autouse=True)
def _fresh():
    yield
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# -- the pruner's companion retain heights -------------------------------------

class _Stores:
    height = 10
    base = 1


def _indexed(s, top=10):
    a = s["abci"]
    tx_idx, blk_idx = s["TxIndexer"](s["MemDB"]()), \
        s["BlockIndexer"](s["MemDB"]())
    for h in range(1, top + 1):
        ev = a.Event(type="transfer", attributes=[
            a.EventAttribute(key="acct", value=f"a{h}", index=True)])
        tx_idx.index(a.TxResult(height=h, index=0, tx=b"tx%d" % h,
                                result=a.ExecTxResult(code=0, events=[ev])))
        blk_idx.index(h, [ev])
    return tx_idx, blk_idx


class _StateStore:
    def __init__(self):
        self.deleted = []

    def prune_abci_responses(self, lo, hi):
        self.deleted.append((lo, hi))
        return hi - lo


@pytest.mark.parametrize("side", ["port", "jax"])
def test_indexer_and_results_pruning(side):
    """tests/test_grpc_companion.py:133-184: the pruner drives tx/block
    indexer pruning and ABCI-result deletion up to the companion retain
    heights."""
    s = SIDES[side]
    Q = s["Query"]
    tx_idx, blk_idx = _indexed(s)
    ss = _StateStore()
    p = s["pruner"].Pruner(ss, _Stores(), s["MemDB"](),
                           companion_enabled=True, tx_indexer=tx_idx,
                           block_indexer=blk_idx)
    p.set_abci_results_retain_height(6)
    p.set_tx_indexer_retain_height(6)
    p.set_block_indexer_retain_height(6)
    p.prune_once()
    assert ss.deleted == [(1, 6)]
    # indexed txs below 6 are gone, 6+ remain
    assert tx_idx.search(Q("transfer.acct = 'a3'")) == []
    assert len(tx_idx.search(Q("transfer.acct = 'a7'"))) == 1
    assert blk_idx.search(Q("transfer.acct = 'a4'")) == []
    assert blk_idx.search(Q("transfer.acct = 'a8'")) == [8]
    # watermark: a second pass re-prunes nothing
    assert p.prune_once() == (0, 1)
    # retain heights cannot move backwards
    with pytest.raises(ValueError):
        p.set_tx_indexer_retain_height(3)


def _pruner_story(s, monkeypatch):
    """One seeded sequence of knob settings and passes, three heights a
    pass; returns what each step answered or raised and the rows of every
    db."""
    tx_idx, blk_idx = _indexed(s, top=10)
    ss, db = _StateStore(), s["MemDB"]()
    p = s["pruner"].Pruner(ss, _Stores(), db, companion_enabled=True,
                           tx_indexer=tx_idx, block_indexer=blk_idx)
    if s is PORT:
        monkeypatch.setattr(s["pruner"], "MAX_HEIGHTS_PER_PASS", 3)
    else:
        p.max_heights_per_pass = 3
    out = []

    def step(fn, *a):
        try:
            out.append(("ok", fn(*a)))
        except ValueError as e:
            out.append(("ValueError", str(e)))
    for setter in ("set_abci_results_retain_height",
                   "set_tx_indexer_retain_height",
                   "set_block_indexer_retain_height",
                   "set_companion_retain_height"):
        for h in (0, -2, 11, 5, 4, 5, 9):
            step(getattr(p, setter), h)
    out.append(("effective", p.effective_retain_height()))
    for _ in range(4):
        step(p.prune_once)
        out.append(("deleted", list(ss.deleted)))
    p.set_application_retain_height(7)
    out.append(("effective", p.effective_retain_height()))
    p.companion_enabled = False
    out.append(("effective", p.effective_retain_height()))
    out.append(("getters", p.get_abci_results_retain_height(),
                p.get_tx_indexer_retain_height(),
                p.get_block_indexer_retain_height(),
                p.get_companion_retain_height(),
                p.get_application_retain_height()))
    return out, rows(db), rows(tx_idx._db), rows(blk_idx._db)


def test_companion_knobs_watermarks_and_texts_equal_the_jax_ones(
        monkeypatch):
    mine, theirs = _pruner_story(PORT, monkeypatch), \
        _pruner_story(JAX, monkeypatch)
    assert mine == theirs
    texts = {o[1] for o in mine[0] if o[0] == "ValueError"}
    assert texts == {"retain height must be positive",
                     "retain height beyond store height",
                     "retain height cannot move backwards"}
    # the per-pass bound: 1-4, 4-7, 7-9, then nothing new
    assert [o for o in mine[0] if o[0] == "deleted"][-1] == \
        ("deleted", [(1, 4), (4, 7), (7, 9)])


def test_an_unwired_target_keeps_its_watermark():
    """A class with no target (no indexer) prunes nothing and keeps its
    watermark, in both packages: wiring the indexer later prunes from the
    first height."""
    out = []
    for s in (PORT, JAX):
        tx_idx, _ = _indexed(s, top=10)
        p = s["pruner"].Pruner(_StateStore(), _Stores(), s["MemDB"]())
        p.set_tx_indexer_retain_height(5)
        p.prune_once()
        before = len(tx_idx.search(s["Query"]("tx.height > 0"), limit=None))
        p.tx_indexer = tx_idx
        p.prune_once()
        out.append((before, len(tx_idx.search(s["Query"]("tx.height > 0"),
                                              limit=None))))
    assert out[0] == out[1] == (10, 6)


@pytest.fixture(scope="module")
def chains():
    """Twin chains of N validators and TOP heights of keyed txs, with kv
    indexers fed from each height's results."""
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        p = port_chain(CHAIN_ID, seeds(N, 181))
        r = RChain(CHAIN_ID, seeds(N, 181))
        for h in range(1, TOP + 1):
            txs = [cs._keyed_tx(181, h, j) for j in range(3)]
            assert p.step(txs)[0].hash() == r.step(txs).hash()
        r_batch.set_backend("auto")
    for chain, s in ((p, PORT), (r, JAX)):
        chain.tx_idx = s["TxIndexer"](s["MemDB"]())
        chain.blk_idx = s["BlockIndexer"](s["MemDB"]())
        for h in range(1, TOP + 1):
            fb = chain.state_store.load_finalize_block_response(h)
            txs = chain.block_store.load_block(h).data.txs
            for i, (tx, res) in enumerate(zip(txs, fb.tx_results)):
                chain.tx_idx.index(s["abci"].TxResult(
                    height=h, index=i, tx=tx, result=res))
            chain.blk_idx.index(h, fb.events)
    return {"port": p, "jax": r}


def _copied(db_cls, db):
    out = db_cls()
    for k, v in db.iterator():
        out.set(k, v)
    return out


def test_a_pass_over_twin_stores_leaves_the_same_rows(chains):
    """On copies of the twin chains' stores and indexes (the other tests
    read the chains unpruned)."""
    from cometbft_tpu.state.store import Store as RStore
    from cometbft_tpu.store import BlockStore as RBlockStore
    from cometbft_tpu_torch.state.store import Store
    from cometbft_tpu_torch.store import BlockStore
    out = []
    for chain, s, stores in ((chains["port"], PORT, (Store, BlockStore)),
                             (chains["jax"], JAX, (RStore, RBlockStore))):
        ss = stores[0](_copied(s["MemDB"], chain.dbs["state"]))
        bs = stores[1](_copied(s["MemDB"], chain.dbs["block"]))
        tx_idx = s["TxIndexer"](_copied(s["MemDB"], chain.tx_idx._db))
        blk_idx = s["BlockIndexer"](_copied(s["MemDB"], chain.blk_idx._db))
        pr = s["pruner"].Pruner(ss, bs, s["MemDB"](), companion_enabled=True,
                                tx_indexer=tx_idx, block_indexer=blk_idx)
        pr.set_abci_results_retain_height(TOP - 2)
        pr.set_tx_indexer_retain_height(3)
        pr.set_block_indexer_retain_height(4)
        out.append((pr.prune_once(), rows(ss._db), rows(tx_idx._db),
                    rows(blk_idx._db), ss.load_finalize_block_response(
                        TOP - 3), ss.load_finalize_block_response(TOP - 2)))
    assert out[0][:4] == out[1][:4]
    assert out[0][4] is None and out[0][5] is not None


# -- the companion services ------------------------------------------------------

class _Aborted(Exception):
    def __init__(self, code, details):
        super().__init__(details)
        self.code, self.details = code, details


class _Ctx:
    async def abort(self, code, details):
        raise _Aborted(code.name, details)


def _jax_server(chain, pr):
    pytest.importorskip("grpc")
    from cometbft_tpu.rpc.grpc.server import GRPCServer
    return GRPCServer(block_store=chain.block_store,
                      state_store=chain.state_store, event_bus=REventBus(),
                      pruner=pr, version_service=True, block_service=True,
                      block_results_service=True, pruning_service=True)


async def _jax_call(srv, service, method, req):
    h = srv._handlers._methods[f"/{service}/{method}"]
    try:
        return await h.unary_unary(req, _Ctx())
    except _Aborted as e:
        return ("aborted", e.code, e.details)


async def _port_call(svc, method, req):
    try:
        return await getattr(svc, method)(req)
    except services.ServiceError as e:
        return ("aborted", e.code, e.message)


def _snake(method):
    return "".join("_" + c.lower() if c.isupper() else c
                   for c in method).lstrip("_")


def _calls(top):
    v, b, br, pr = (grpc_pb.VERSION_SERVICE, grpc_pb.BLOCK_SERVICE,
                    grpc_pb.BLOCK_RESULTS_SERVICE, grpc_pb.PRUNING_SERVICE)
    return [
        (v, "GetVersion", {}),
        (b, "GetByHeight", {}), (b, "GetByHeight", {"height": 3}),
        (b, "GetByHeight", {"height": top + 5}),
        (br, "GetBlockResults", {}), (br, "GetBlockResults", {"height": 2}),
        (br, "GetBlockResults", {"height": top + 1}),
        (br, "GetBlockResults", {"height": -1}),
        (pr, "GetBlockRetainHeight", {}),
        (pr, "SetBlockRetainHeight", {"height": 4}),
        (pr, "SetBlockRetainHeight", {"height": 2}),
        (pr, "SetBlockRetainHeight", {"height": top + 1}),
        (pr, "SetBlockRetainHeight", {}),
        (pr, "GetBlockRetainHeight", {}),
        (pr, "SetBlockResultsRetainHeight", {"height": 5}),
        (pr, "GetBlockResultsRetainHeight", {}),
        (pr, "SetTxIndexerRetainHeight", {"height": 3}),
        (pr, "SetTxIndexerRetainHeight", {"height": 1}),
        (pr, "GetTxIndexerRetainHeight", {}),
        (pr, "SetBlockIndexerRetainHeight", {"height": 6}),
        (pr, "GetBlockIndexerRetainHeight", {}),
    ]


def _resp_desc(method):
    return getattr(grpc_pb, _snake(method).upper() + "_RESPONSE")


def test_servicers_answer_the_jax_servers_dicts(chains):
    p, r = chains["port"], chains["jax"]
    p_pr = pruner.Pruner(p.state_store, p.block_store, MemDB(),
                         companion_enabled=True)
    r_pr = r_pruner.Pruner(r.state_store, r.block_store, RMemDB(),
                           companion_enabled=True)
    p_pr.set_application_retain_height(6)
    r_pr.set_application_retain_height(6)
    srv = _jax_server(r, r_pr)
    svcs = {grpc_pb.VERSION_SERVICE: services.VersionServicer(),
            grpc_pb.BLOCK_SERVICE: services.BlockServicer(p.block_store,
                                                          EventBus()),
            grpc_pb.BLOCK_RESULTS_SERVICE: services.BlockResultsServicer(
                p.block_store, p.state_store),
            grpc_pb.PRUNING_SERVICE: services.PruningServicer(p_pr)}

    async def go():
        out = []
        for service, method, req in _calls(TOP):
            mine = await _port_call(svcs[service], _snake(method), req)
            theirs = await _jax_call(srv, service, method, req)
            if isinstance(mine, dict) and isinstance(theirs, dict):
                desc = _resp_desc(method)
                assert encode(desc, mine) == encode(desc, theirs), method
            else:
                assert mine == theirs, method
            out.append(mine)
        return out
    out = run(go())
    assert out[0] == {"node": version.CMT_SEM_VER,
                      "abci": version.ABCI_SEM_VER,
                      "p2p": version.P2P_PROTOCOL,
                      "block": version.BLOCK_PROTOCOL}
    assert r_version.CMT_SEM_VER == version.CMT_SEM_VER
    assert out[3] == ("aborted", "NOT_FOUND",
                      f"height {TOP + 5} not in store [1,{TOP}]")
    assert out[10] == ("aborted", "INVALID_ARGUMENT",
                       "retain height cannot move backwards")
    assert out[13] == {"app_retain_height": 6,
                       "pruning_service_retain_height": 4}


def test_latest_height_stream_starts_at_the_store_height(chains):
    bus = EventBus()
    svc = services.BlockServicer(chains["port"].block_store, bus)

    async def go():
        agen = svc.get_latest_height({}, "sub")
        first = await agen.__anext__()
        await agen.aclose()
        return first
    assert run(go()) == {"height": TOP}


def test_servicers_load_without_grpc():
    import subprocess
    import sys
    code = ("import sys\nsys.modules['grpc'] = None\n"
            "import cometbft_tpu_torch.rpc.grpc as g\n"
            "from cometbft_tpu_torch.rpc.grpc import services, pb\n"
            "try:\n"
            "    g.GRPCServer\n"
            "except ImportError:\n"
            "    print('transport needs grpc')\n")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=cs.__file__.rsplit("/", 1)[0],
                         capture_output=True, text=True, timeout=60)
    assert out.stdout.strip() == "transport needs grpc", out.stderr


def _live_answers(server_mod, client_mod, chain, bus, pr):
    """Start ``server_mod``'s GRPCServer on the chain's stores, drive it
    with ``client_mod``'s clients; returns their answers."""
    async def go():
        srv = server_mod.GRPCServer(
            block_store=chain.block_store, state_store=chain.state_store,
            event_bus=bus, version_service=True, block_service=True,
            block_results_service=True)
        priv = server_mod.GRPCServer(pruner=pr, pruning_service=True)
        port = await srv.start("tcp://127.0.0.1:0")
        pport = await priv.start("127.0.0.1:0")
        addr, paddr = f"127.0.0.1:{port}", f"127.0.0.1:{pport}"
        out = []
        try:
            async with client_mod.VersionServiceClient(addr) as c:
                out.append(await c.get_version())
            async with client_mod.BlockServiceClient(addr) as c:
                out.append(await c.get_by_height(3))
                out.append(await c.get_by_height())
                async for h in c.get_latest_height():
                    out.append(h)
                    break
                try:
                    await c.get_by_height(TOP + 9)
                except Exception as e:  # noqa: BLE001 — compared
                    out.append((e.code().name, e.details()))
            async with client_mod.BlockResultsServiceClient(addr) as c:
                out.append(await c.get_block_results(2))
            async with client_mod.PruningServiceClient(paddr) as c:
                await c.set_block_retain_height(3)
                out.append(await c.get_block_retain_height())
                await c.set_block_results_retain_height(4)
                out.append(await c.get_block_results_retain_height())
                await c.set_tx_indexer_retain_height(2)
                out.append(await c.get_tx_indexer_retain_height())
                await c.set_block_indexer_retain_height(2)
                out.append(await c.get_block_indexer_retain_height())
                try:
                    await c.set_block_retain_height(1)
                except Exception as e:  # noqa: BLE001 — compared
                    out.append((e.code().name, e.details()))
        finally:
            await srv.stop()
            await priv.stop()
        return out
    return run(go())


@pytest.mark.parametrize("server_side, client_side",
                         [("port", "jax"), ("jax", "port")])
def test_grpc_companion_interop_both_ways(chains, server_side, client_side):
    pytest.importorskip("grpc")
    from cometbft_tpu.rpc.grpc import client as r_gclient
    from cometbft_tpu.rpc.grpc import server as r_gserver
    from cometbft_tpu_torch.rpc.grpc import client as p_gclient
    from cometbft_tpu_torch.rpc.grpc import server as p_gserver
    mods = {"port": (p_gserver, p_gclient, EventBus, MemDB, pruner),
            "jax": (r_gserver, r_gclient, REventBus, RMemDB, r_pruner)}
    got = []
    for srv_side, cli_side in ((server_side, client_side), ("jax", "jax")):
        server_mod, bus_cls, db_cls, pr_mod = (mods[srv_side][0],) + \
            mods[srv_side][2:]
        chain = chains[srv_side]
        pr = pr_mod.Pruner(chain.state_store, chain.block_store, db_cls(),
                           companion_enabled=True)
        got.append(_live_answers(server_mod, mods[cli_side][1], chain,
                                 bus_cls(), pr))
    assert got[0] == got[1]
    assert got[0][3] == TOP
    assert got[0][4][0] == "NOT_FOUND"
    assert got[0][-1] == ("INVALID_ARGUMENT",
                          "retain height cannot move backwards")


# -- the SQL event sink ----------------------------------------------------------

def _sink_events(s):
    a = s["abci"]
    blocks = {h: [a.Event(type="rewards", attributes=[
        a.EventAttribute(key="amount", value=str(12 * h), index=True),
        a.EventAttribute(key="", value="dropped", index=True)]),
        a.Event(type="", attributes=[])] for h in range(1, 5)}
    txs = [a.TxResult(height=h, index=i, tx=b"k%d.%d=v" % (h, i),
                      result=a.ExecTxResult(code=i % 2, data=b"d", events=[
                          a.Event(type="transfer", attributes=[
                              a.EventAttribute(key="to", value=f"bob{i}",
                                               index=True),
                              a.EventAttribute(key="memo", value="x",
                                               index=False)])]))
           for h in range(1, 5) for i in range(3)]
    return blocks, txs


_TABLES = {
    "blocks": "SELECT rowid, height, chain_id FROM blocks ORDER BY rowid",
    "tx_results": 'SELECT rowid, block_id, "index", tx_hash, tx_result '
                  "FROM tx_results ORDER BY rowid",
    "events": "SELECT rowid, block_id, tx_id, type FROM events "
              "ORDER BY rowid",
    "attributes": "SELECT event_id, key, composite_key, value FROM "
                  "attributes ORDER BY event_id, key",
    "block_events": "SELECT * FROM block_events ORDER BY 1, 4, 5",
    "tx_events": "SELECT height, \"index\", chain_id, type, key, "
                 "composite_key, value FROM tx_events ORDER BY 1, 2, 4, 5",
}


def _sink_rows(s, reindex=False, prune=None):
    sink = s["sink_sql"].SQLEventSink(":memory:", "sink-chain")
    blocks, txs = _sink_events(s)
    for h, evs in blocks.items():
        sink.block_indexer.index(h, evs)
        sink.index_tx_events([t for t in txs if t.height == h])
    if reindex:
        sink.index_block_events(2, blocks[2])
        sink.index_tx_events([t for t in txs if t.height == 2])
    pruned = None
    if prune is not None:
        pruned = (sink.tx_indexer.prune(*prune),
                  sink.block_indexer.prune(*prune))
    out = {k: sink._conn.execute(q).fetchall() for k, q in _TABLES.items()}
    assert sink.tx_indexer.get(b"x") is None
    sink.close()
    return out, pruned


@pytest.mark.parametrize("reindex, prune", [(False, None), (True, None),
                                            (False, (1, 3)), (True, (2, 9))])
def test_sql_sink_rows_equal_the_jax_ones(reindex, prune):
    mine, theirs = _sink_rows(PORT, reindex, prune), \
        _sink_rows(JAX, reindex, prune)
    assert mine == theirs
    assert mine[0]["blocks"]


def test_sql_sink_schema_views_and_searches_equal_the_jax_ones():
    assert sink_sql._SCHEMA == r_sink_sql._SCHEMA
    assert sink_sql._psql_schema() == r_sink_sql._psql_schema()
    sink = sink_sql.SQLEventSink(":memory:", "c")
    names = sink._conn.execute(
        "SELECT type, name FROM sqlite_master WHERE name NOT LIKE "
        "'sqlite_%' ORDER BY name").fetchall()
    assert names == [
        ("table", "attributes"), ("view", "block_events"),
        ("table", "blocks"), ("view", "event_attributes"),
        ("table", "events"), ("index", "idx_blocks_height_chain"),
        ("view", "tx_events"),
        ("table", "tx_results")]
    texts = []
    for mod, s in ((sink_sql, sink), (r_sink_sql, r_sink_sql.SQLEventSink(
            ":memory:", "c"))):
        for adapter in (s.tx_indexer, s.block_indexer):
            with pytest.raises(NotImplementedError) as e:
                adapter.search(None)
            texts.append(str(e.value))
    assert texts[:2] == texts[2:]


def test_postgres_dsn_without_psycopg2_raises_the_jax_text():
    texts = []
    for mod in (sink_sql, r_sink_sql):
        with pytest.raises(RuntimeError) as e:
            mod.SQLEventSink("postgres://u:p@127.0.0.1/db", "c")
        texts.append(str(e.value))
    assert texts[0] == texts[1]
    assert "psycopg2 is not installed" in texts[0]


def test_sql_sink_cursor_rewrites_the_paramstyle():
    class Rec:
        def execute(self, sql, params=()):
            self.sql = sql

        def fetchone(self):
            return (7,)
    for mod in (sink_sql, r_sink_sql):
        rec = Rec()
        cur = mod._Cursor(rec, "%s")
        cur.execute("SELECT ? , ?", (1, 2))
        assert rec.sql == "SELECT %s , %s"
        assert cur.insert_returning("INSERT INTO t VALUES (?)", (1,)) == 7
        assert rec.sql == "INSERT INTO t VALUES (%s) RETURNING rowid"


def test_sql_sink_behind_the_indexer_service():
    """An IndexerService feeds the sink from the event bus, as a node's
    does."""
    from cometbft_tpu_torch.indexer.service import IndexerService
    sink = sink_sql.SQLEventSink(":memory:", "svc")
    bus = EventBus()

    async def go():
        svc = IndexerService(sink.tx_indexer, sink.block_indexer, bus)
        await svc.start()
        bus.publish_new_block_events(1, [], 1)
        bus.publish_tx(1, 0, b"a=b", abci.ExecTxResult(), [])
        for _ in range(200):
            if sink._conn.execute("SELECT count(*) FROM tx_results"
                                  ).fetchone()[0]:
                break
            await asyncio.sleep(0.01)
        await svc.stop()
    run(go())
    assert sink._conn.execute("SELECT height, chain_id FROM blocks"
                              ).fetchall() == [(1, "svc")]
    assert sink._conn.execute('SELECT "index", tx_hash FROM tx_results'
                              ).fetchall() == [(0, tx_hash(b"a=b").hex()
                                                .upper())]
