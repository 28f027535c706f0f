"""The port's pruning and rollback against the JAX package's:

  * the state tree's ``prune`` and ``import_snapshot``
    (statetree/tree.py): tests/test_statetree.py ``TestPruning`` and the
    statesync restore case run against the port, and seeded histories of
    sets, deletes, prunes and pins whose tree rows equal the JAX tree's
    row for row after every prune;
  * the kvstore's ``version_pin``: a height a lightserve ResponseCache
    holds survives the kvstore's prune, and its proof still verifies;
  * the kvstore's snapshots and retain height (abci/kvstore.py): the same
    snapshot list, chunks, retain heights, pruned versions and query texts;
  * the stores' ``prune_blocks``, ``delete_latest_block``,
    ``save_seen_commit_standalone`` (store/store.py), ``prune_states``,
    ``prune_abci_responses`` and ``bootstrap`` (state/store.py) and
    ``rollback_state`` (state/rollback.py), row for row on copies of one
    seeded chain built in both packages (tests/torch_chain.py), with the
    same return values and texts;
  * ``Pruner`` (state/pruner.py): tests/test_metrics_flowrate.py
    ``test_pruner_prunes_to_min_retain`` and the pruner of
    tests/test_grpc_companion.py with the companion off (its knobs come
    with the pruning service, ROADMAP A.7e-5), a pass over the twin
    stores, the service loop, and the executor's hand-off of the app's
    retain height;
  * ``StateSyncConfig``, ``StorageConfig`` and the pruner's gauges equal
    the JAX ones.

The port runs ``device="cpu"`` with the accept-all stand-in kernel (no
signature here decides an outcome); the JAX package its ``cpu`` backend.
Equality is exact.
"""
import asyncio
import dataclasses
import json
import random

import pytest

from cometbft_tpu import config as r_config
from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.db import SQLiteDB as RSQLiteDB
from cometbft_tpu.state import pruner as r_pruner
from cometbft_tpu.state import rollback as r_rollback
from cometbft_tpu.state.metrics import Metrics as RStateMetrics
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.statetree import StateTree as RStateTree
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.store.store import BlockStoreError as RBlockStoreError
from cometbft_tpu_torch import config as p_config
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.db import MemDB, SQLiteDB
from cometbft_tpu_torch.libs import metrics as p_libmetrics
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.state import pruner as p_pruner
from cometbft_tpu_torch.state import rollback as p_rollback
from cometbft_tpu_torch.state.metrics import Metrics as PStateMetrics
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.statetree import StateTree
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.store.store import BlockStoreError
from torch_chain import RChain, accept_all, cs, port_chain, rows, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "prune-parity"
N, TOP = 5, 12
PORT = {"MemDB": MemDB, "Store": Store, "BlockStore": BlockStore,
        "pruner": p_pruner, "rollback": p_rollback, "abci": abci,
        "KVStore": KVStoreApplication, "StateTree": StateTree}
REF = {"MemDB": RMemDB, "Store": RStore, "BlockStore": RBlockStore,
       "pruner": r_pruner, "rollback": r_rollback, "abci": r_abci,
       "KVStore": RKVStore, "StateTree": RStateTree}
SIDES = {"port": PORT, "jax": REF}


@pytest.fixture(autouse=True)
def _fresh():
    r_batch.set_backend("cpu")
    yield
    r_batch.set_backend("auto")
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


# -- the state tree ------------------------------------------------------------

def _tree_5_versions(tree_cls=StateTree, db=None):
    t = tree_cls(db if db is not None else
                 (MemDB() if tree_cls is StateTree else RMemDB()))
    for v in range(1, 6):
        t.set(b"hot", b"v%d" % v)
        t.set(b"k%d" % v, b"x")
        t.commit(v)
    return t


def _root_of(pairs):
    """The root a fresh tree commits for ``pairs``."""
    t = StateTree(MemDB())
    for k, v in pairs:
        t.set(k, v)
    return t.commit(1)


def test_prune_keeps_retained_and_pinned():
    t = _tree_5_versions()
    roots = {v: t.root(v) for v in range(1, 6)}
    dropped = t.prune(4, pinned={2})
    assert dropped == 2                       # versions 1 and 3
    assert t.base_version == 2
    assert sorted(t.versions()) == [2, 4, 5]
    # retained + pinned versions materialize the exact same state
    assert t.get(b"hot", 2) == b"v2"
    assert t.get(b"hot", 4) == b"v4"
    assert t.pairs(2) == [(b"hot", b"v2"), (b"k1", b"x"), (b"k2", b"x")]
    for v in (2, 4, 5):
        assert _root_of(t.pairs(v)) == roots[v] == t.root(v)
    # dropped versions are gone
    with pytest.raises(KeyError):
        t.pairs(3)
    assert t.get(b"hot", 1) is None
    r = _tree_5_versions(RStateTree)
    assert r.prune(4, pinned={2}) == dropped
    assert rows(r._db) == rows(t._db)


def test_prune_survives_reopen(tmp_path):
    db = SQLiteDB(str(tmp_path / "t.db"))
    t = StateTree(db)
    for v in range(1, 4):
        t.set(b"k", b"v%d" % v)
        t.commit(v)
    r3 = t.root(3)
    t.prune(3)
    t2 = StateTree(db)
    assert t2.base_version == 3 and t2.root() == r3
    assert t2.get(b"k") == b"v3"
    rdb = RSQLiteDB(str(tmp_path / "r.db"))
    r = RStateTree(rdb)
    for v in range(1, 4):
        r.set(b"k", b"v%d" % v)
        r.commit(v)
    r.prune(3)
    assert list(rdb.iterator()) == list(db.iterator())
    db.close()
    rdb.close()


def test_prune_everything_below_tip():
    t = _tree_5_versions()
    r5 = t.root(5)
    assert t.prune(10) == 4                   # clamped to latest
    assert t.versions() == [5] and t.root() == r5
    assert _root_of(t.pairs(5)) == r5
    assert t.prune(10) == 0
    r = _tree_5_versions(RStateTree)
    r.prune(10)
    assert rows(r._db) == rows(t._db)


@pytest.mark.parametrize("seed", range(24))
def test_prune_rows_equal_the_jax_trees(seed):
    """A seeded history of sets, deletes (tombstones), commits and prunes
    with pins below and above the retain height: after every prune the
    port's tree rows, count, base and every retained version's pairs and
    root equal the JAX tree's."""
    rng = random.Random(seed)
    pdb, rdb = MemDB(), RMemDB()
    p, r = StateTree(pdb), RStateTree(rdb)
    keys = [b"k%d" % i for i in range(rng.randint(2, 8))]
    for v in range(1, rng.randint(6, 16)):
        for _ in range(rng.randint(0, 5)):
            k = rng.choice(keys)
            if rng.random() < 0.3:
                p.delete(k)
                r.delete(k)
            else:
                val = b"v%d" % rng.randint(0, 3)
                p.set(k, val)
                r.set(k, val)
        assert p.commit(v) == r.commit(v)
        if rng.random() < 0.5:
            retain = rng.randint(0, v + 2)
            pins = [rng.randint(0, v) for _ in range(rng.randint(0, 3))]
            assert p.prune(retain, pinned=pins) == \
                r.prune(retain, pinned=pins)
            assert rows(pdb) == rows(rdb)
            assert p.base_version == r.base_version
            for kept in p.versions():
                assert p.pairs(kept) == r.pairs(kept)
                assert _root_of(p.pairs(kept)) == r.root(kept)


def test_import_snapshot_replaces_everything():
    t = _tree_5_versions()
    root = t.import_snapshot(9, [(b"b", b"2"), (b"a", b"1")],
                             extra={"size": 2})
    assert t.versions() == [9] and t.base_version == 9
    assert t.pairs() == [(b"a", b"1"), (b"b", b"2")]
    assert root == _root_of(t.pairs()) and t.version_extra() == {"size": 2}
    r = _tree_5_versions(RStateTree)
    assert r.import_snapshot(9, [(b"b", b"2"), (b"a", b"1")],
                             extra={"size": 2}) == root
    assert rows(r._db) == rows(t._db)


# -- the kvstore's snapshots and retain height ---------------------------------

async def _drive_blocks(side, app, txs_per_block, start_height=1):
    a = SIDES[side]["abci"]
    out = []
    for h, txs in enumerate(txs_per_block, start_height):
        await app.finalize_block(a.FinalizeBlockRequest(txs=txs, height=h))
        out.append(await app.commit(a.CommitRequest()))
    return out


@pytest.mark.parametrize("side", ["port", "jax"])
def test_statesync_restore_reproduces_identical_root(side):
    """tests/test_statetree.py's restore case: the consumer's root is
    byte-identical to the producer's; a corrupted chunk is refused.  The
    producer is either package, the consumer the port."""
    a = SIDES[side]["abci"]
    producer = SIDES[side]["KVStore"](snapshot_interval=2)

    async def go():
        await _drive_blocks(side, producer,
                            [[b"a=1", b"b=2"], [b"c=3", b"a=9"]])
        snaps = await producer.list_snapshots(a.ListSnapshotsRequest())
        assert [s.height for s in snaps.snapshots] == [2]
        s = snaps.snapshots[0]
        consumer = KVStoreApplication()
        offer = await consumer.offer_snapshot(abci.OfferSnapshotRequest(
            snapshot=abci.Snapshot(height=s.height, format=s.format,
                                   chunks=s.chunks, hash=s.hash)))
        assert offer.result == abci.OFFER_SNAPSHOT_RESULT_ACCEPT
        chunk = await producer.load_snapshot_chunk(
            a.LoadSnapshotChunkRequest(height=2, format=1, chunk=0))
        applied = await consumer.apply_snapshot_chunk(
            abci.ApplySnapshotChunkRequest(index=0, chunk=chunk.chunk))
        assert applied.result == abci.APPLY_SNAPSHOT_CHUNK_RESULT_ACCEPT
        assert consumer.tree.root(2) == producer.tree.root(2)
        info = await consumer.info(abci.InfoRequest())
        assert info.last_block_height == 2
        assert info.last_block_app_hash == producer.tree.root(2)
        assert consumer.tree.pairs(2) == producer.tree.pairs(2)
        bad = await consumer.apply_snapshot_chunk(
            abci.ApplySnapshotChunkRequest(index=0, chunk=b"garbage"))
        assert bad.result == \
            abci.APPLY_SNAPSHOT_CHUNK_RESULT_REJECT_SNAPSHOT
        # the producer goes on, the consumer follows to the same root
        await _drive_blocks(side, producer, [[b"d=4"]], start_height=3)
        await _drive_blocks("port", consumer, [[b"d=4"]], start_height=3)
        assert consumer.tree.root(3) == producer.tree.root(3)
    run(go())


def test_snapshot_window_listing_and_offers_equal_the_jax_app():
    async def go(side):
        a = SIDES[side]["abci"]
        app = SIDES[side]["KVStore"](snapshot_interval=1)
        await _drive_blocks(side, app, [[b"k%d=v" % h] for h in range(8)])
        snaps = (await app.list_snapshots(a.ListSnapshotsRequest())
                 ).snapshots
        chunks = [(await app.load_snapshot_chunk(a.LoadSnapshotChunkRequest(
            height=h, format=1, chunk=0))).chunk for h in (3, 8, 9)]
        offers = []
        for s in (a.Snapshot(height=8, format=2, chunks=1, hash=b"h"),
                  a.Snapshot(height=8, format=1, chunks=2, hash=b"h"),
                  None):
            offers.append((await app.offer_snapshot(
                a.OfferSnapshotRequest(snapshot=s))).result)
        unoffered = await SIDES[side]["KVStore"]().apply_snapshot_chunk(
            a.ApplySnapshotChunkRequest(index=0, chunk=chunks[1]))
        return ([(s.height, s.format, s.chunks, s.hash) for s in snaps],
                chunks, offers, unoffered.result)

    got, want = run(go("port")), run(go("jax"))
    assert got == want
    assert [h for h, *_ in got[0]] == [4, 5, 6, 7, 8]
    assert got[1][0] == b"" and got[1][2] == b""
    assert got[2] == [abci.OFFER_SNAPSHOT_RESULT_REJECT_FORMAT] * 3


def test_kvstore_retain_blocks_prunes_the_tree():
    """The app answers a retain height once it holds retain_blocks heights
    and prunes the tree's versions below it (no lightserve pin); a pruned
    height's query carries the JAX text."""
    async def go(side):
        a = SIDES[side]["abci"]
        app = SIDES[side]["KVStore"]()
        app.retain_blocks = 2
        resps = await _drive_blocks(
            side, app, [[b"a=1"], [b"b=2"], [b"c=3"], [b"d=4"], [b"e=5"]])
        q = await app.query(a.QueryRequest(data=b"a", height=1))
        ok = await app.query(a.QueryRequest(data=b"a", height=3))
        return ([r.retain_height for r in resps], app.tree.versions(),
                rows(app.db), (q.code, q.log, q.height),
                (ok.value, ok.log, ok.height))

    got, want = run(go("port")), run(go("jax"))
    assert got == want
    assert got[0] == [0, 1, 2, 3, 4] and got[1] == [3, 4, 5]
    assert got[3][1] == "height 1 pruned (oldest retained 3)"


def test_cached_height_survives_the_kvstores_prune():
    """A proven batch cached at height 2 pins version 2: commits past the
    retain horizon keep it, and its proof envelope still verifies against
    the version's root, while the unpinned versions below the horizon are
    gone.  The same rows, answers and texts as the JAX kvstore."""
    from cometbft_tpu.lightserve.cache import ResponseCache as RCache
    from cometbft_tpu.statetree import verify_proof_envelope as r_verify
    from cometbft_tpu_torch.lightserve.cache import ResponseCache
    from cometbft_tpu_torch.statetree import verify_proof_envelope
    cache_of = {"port": ResponseCache, "jax": RCache}
    verify_of = {"port": verify_proof_envelope, "jax": r_verify}
    keys = json.dumps({"keys": [b"a".hex(), b"zz".hex()]}).encode()

    async def go(side):
        a = SIDES[side]["abci"]
        app, cache = SIDES[side]["KVStore"](), cache_of[side]()
        app.retain_blocks = 2
        app.version_pin = cache.heights
        blocks = [[b"a=%d" % h, b"k%d=v" % h] for h in range(1, 9)]
        await _drive_blocks(side, app, blocks[:3])
        q = await app.query(a.QueryRequest(path="/multistore", data=keys,
                                           height=2, prove=True))
        assert cache.put("abci_query_batch", 2, ("", ("61", "7a7a")),
                         json.loads(q.value), latest_height=3)
        await _drive_blocks(side, app, blocks[3:], start_height=4)
        again = await app.query(a.QueryRequest(
            path="/multistore", data=keys, height=2, prove=True))
        env = json.loads(again.value)
        verify_of[side](env, present=[(b"a", b"2")], absent=[b"zz"],
                        expected_root=app.tree.root(2))
        gone = await app.query(a.QueryRequest(
            path="/multistore", data=keys, height=3, prove=True))
        return (app.tree.versions(), rows(app.db), env == json.loads(q.value),
                (gone.code, gone.log))

    got, want = run(go("port")), run(go("jax"))
    assert got == want
    assert got[0] == [2, 6, 7, 8] and got[2]
    assert got[3][1] == "multistore: 'state tree has no version 3'"


# -- the stores, row for row ---------------------------------------------------

def _updates(new_seed, genesis_pub, gone_pub):
    """val= txs: add a validator at 2, re-power one at 3, remove one at 5,
    so the state store holds validator pointers and full records."""
    from cometbft_tpu_torch.abci.kvstore import make_val_set_change_tx
    from cometbft_tpu_torch.crypto import ed25519 as p_ed
    new_pub = p_ed.Ed25519PrivKey(new_seed).pub_key().bytes()
    plan = {2: (new_pub, 10), 3: (genesis_pub, 20), 5: (gone_pub, 0)}
    return {h: make_val_set_change_tx("ed25519", pub, power)
            for h, (pub, power) in plan.items()}


@pytest.fixture(scope="module")
def chains():
    from cometbft_tpu_torch.crypto import ed25519 as p_ed
    key_seeds = seeds(N, 171)
    new_seed = seeds(1, 172)[0]
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        p = port_chain(CHAIN_ID, key_seeds)
        r = RChain(CHAIN_ID, key_seeds)
        p.seed_of[p_ed.Ed25519PrivKey(new_seed).pub_key().address()] = \
            new_seed
        r.add_keys([new_seed])
        vals = r.state.validators.validators
        updates = _updates(new_seed, vals[0].pub_key.bytes(),
                           vals[1].pub_key.bytes())
        p.states, r.states = {}, {}
        for h in range(1, TOP + 1):
            txs = [cs._load_tx(23, h, j) for j in range(3)]
            if h in updates:
                txs.append(updates[h])
            assert p.step(txs)[0].hash() == r.step(txs).hash()
            p.states[h], r.states[h] = p.state, r.state
            assert p.state.bytes() == r.state.bytes()
    return {"port": p, "jax": r}


def _copy(side, chain):
    """Fresh stores of ``side`` over copies of the chain's dbs."""
    s = SIDES[side]
    dbs = {}
    for name in ("state", "block"):
        db = s["MemDB"]()
        for k, v in chain.dbs[name].iterator():
            db.set(k, v)
        dbs[name] = db
    return s["Store"](dbs["state"]), s["BlockStore"](dbs["block"]), dbs


def _both(chains, fn):
    """fn(side, state_store, block_store) on copies in both packages;
    returns ((port result, rows), (jax result, rows))."""
    out = []
    for side in ("port", "jax"):
        ss, bs, dbs = _copy(side, chains[side])
        try:
            res = ("ok", fn(side, ss, bs))
        except Exception as e:  # noqa: BLE001 — compared across packages
            res = (type(e).__name__, str(e))
        out.append((res, {k: rows(db) for k, db in dbs.items()},
                    (bs.base, bs.height)))
    return out


@pytest.mark.parametrize("retain", [0, 1, 4, TOP, TOP + 1])
def test_prune_blocks_rows(chains, retain):
    got, want = _both(chains, lambda side, ss, bs: bs.prune_blocks(retain))
    assert got == want
    if retain > TOP:
        assert got[0] == ("BlockStoreError",
                          f"cannot prune beyond the latest height {TOP}")
    elif retain > 1:
        assert got[0] == ("ok", (retain - 1, retain))


@pytest.mark.parametrize("span", [(0, 5, 5), (1, 8, 8), (2, 10, 6),
                                  (3, 3, 3), (1, TOP + 1, TOP)])
def test_prune_states_rows(chains, span):
    got, want = _both(chains,
                      lambda side, ss, bs: ss.prune_states(*span))
    assert got == want
    assert got[0][0] == "ok"


@pytest.mark.parametrize("span", [(0, 4), (2, 7), (5, 5), (1, TOP + 1)])
def test_prune_abci_responses_rows(chains, span):
    got, want = _both(chains,
                      lambda side, ss, bs: ss.prune_abci_responses(*span))
    assert got == want


@pytest.mark.parametrize("height", [1, 4, 8])
def test_bootstrap_rows(chains, height):
    """Store.bootstrap of the chain's State at ``height`` into an empty
    store writes the JAX rows."""
    out = []
    for side in ("port", "jax"):
        s = SIDES[side]
        db = s["MemDB"]()
        ss = s["Store"](db)
        ss.bootstrap(chains[side].states[height])
        out.append((rows(db), ss.load().bytes(),
                    [ss.load_validators(h).hash()
                     for h in range(max(height, 1), height + 3)]))
    assert out[0] == out[1]


@pytest.mark.parametrize("height", [1, 6])
def test_save_seen_commit_standalone_rows(chains, height):
    out = []
    for side in ("port", "jax"):
        s = SIDES[side]
        db = s["MemDB"]()
        bs = s["BlockStore"](db)
        commit = chains[side].block_store.load_seen_commit(height)
        bs.save_seen_commit_standalone(commit)
        reopened = s["BlockStore"](db)
        out.append((rows(db), bs.base, bs.height, reopened.base,
                    reopened.height, bs.load_seen_commit(height).hash()))
    assert out[0] == out[1]
    assert out[0][1:5] == (height + 1, height, height + 1, height)


def test_delete_latest_block_rows(chains):
    def twice(side, ss, bs):
        bs.delete_latest_block()
        bs.delete_latest_block()
        return bs.load_block(TOP) is None, bs.load_block(TOP - 2) is not None
    got, want = _both(chains, twice)
    assert got == want and got[0] == ("ok", (True, True))
    assert got[2] == (1, TOP - 2)
    for side, err in (("port", BlockStoreError), ("jax", RBlockStoreError)):
        with pytest.raises(err, match="no blocks to delete"):
            SIDES[side]["BlockStore"](SIDES[side]["MemDB"]()
                                      ).delete_latest_block()


@pytest.mark.parametrize("remove_block", [False, True])
def test_rollback_state_rows(chains, remove_block):
    def roll(side, ss, bs):
        return SIDES[side]["rollback"].rollback_state(
            ss, bs, remove_block=remove_block)
    got, want = _both(chains, roll)
    assert got == want
    assert got[0][1][0] == TOP - 1
    assert got[0][1][1] == chains["port"].states[TOP - 1].app_hash


def test_rollback_state_refusals(chains):
    cases = []
    for side in ("port", "jax"):
        s = SIDES[side]
        rb = s["rollback"]
        texts = []
        try:
            rb.rollback_state(s["Store"](s["MemDB"]()),
                              s["BlockStore"](s["MemDB"]()))
        except rb.RollbackError as e:
            texts.append(str(e))
        ss, bs, _ = _copy(side, chains[side])
        bs.delete_latest_block()
        bs.delete_latest_block()
        try:
            rb.rollback_state(ss, bs)
        except rb.RollbackError as e:
            texts.append(str(e))
        ss, bs, _ = _copy(side, chains[side])
        bs.prune_blocks(TOP)
        try:
            rb.rollback_state(ss, bs)
        except rb.RollbackError as e:
            texts.append(str(e))
        cases.append(texts)
    assert cases[0] == cases[1]
    assert cases[0] == [
        "no state found",
        f"statestore height ({TOP}) is not one off from blockstore height "
        f"({TOP - 2})",
        f"block at height {TOP - 1} not found"]


# -- Pruner ----------------------------------------------------------------------

@pytest.mark.parametrize("side", ["port", "jax"])
def test_pruner_prunes_to_min_retain(side):
    """tests/test_metrics_flowrate.py's case with the companion off (its
    knobs come with the pruning service, ROADMAP A.7e-5): a pass prunes
    to the smaller of the app's retain height and the tip, the app's knob
    keeps its max, and the gauges follow."""
    class FakeBlockStore:
        def __init__(self):
            self.base = 1
            self.height = 100

        def prune_blocks(self, retain):
            pruned = retain - self.base
            self.base = retain
            return pruned, retain

    class FakeStateStore:
        def __init__(self):
            self.calls = []

        def prune_states(self, frm, to, ev):
            self.calls.append((frm, to, ev))
            return to - frm

    s = SIDES[side]
    bs, ss = FakeBlockStore(), FakeStateStore()
    pr = s["pruner"].Pruner(ss, bs, s["MemDB"]())
    # nothing set yet: nothing prunes
    assert pr.prune_once() == (0, 1)
    pr.set_application_retain_height(30)
    assert pr.prune_once() == (29, 30)
    assert ss.calls == [(1, 30, 30)]
    # the app knob silently keeps its max
    pr.set_application_retain_height(20)
    assert pr.get_application_retain_height() == 30
    assert pr.prune_once() == (0, 30)
    # beyond the tip: the tip wins
    pr.set_application_retain_height(150)
    assert pr.prune_once() == (70, 100)
    assert ss.calls == [(1, 30, 30), (30, 100, 100)]
    assert pr.metrics.application_block_retain_height.value == 150
    assert pr.metrics.block_store_base_height.value == 100


def test_pruner_companion_artifacts():
    """tests/test_grpc_companion.py's pruner with no companion: the JAX
    pruner's companion pass has no retain height to prune ABCI results
    or indices to, so it calls no target and writes no watermark; the
    port's pruner, which leaves that pass to the pruning service (ROADMAP
    A.7e-5), writes the same rows and makes the same calls."""
    class Stores:
        height = 10
        base = 1

        def __init__(self):
            self.pruned = []

        def prune_blocks(self, retain):
            self.pruned.append(retain)
            pruned, self.base = retain - self.base, retain
            return pruned, retain

    class StateStore:
        def __init__(self):
            self.calls = []

        def prune_states(self, frm, to, ev):
            self.calls.append(("states", frm, to, ev))

        def prune_abci_responses(self, lo, hi):
            self.calls.append(("abci", lo, hi))
            return hi - lo

    out = []
    for side in ("port", "jax"):
        s = SIDES[side]
        ss, bs, db = StateStore(), Stores(), s["MemDB"]()
        p = s["pruner"].Pruner(ss, bs, db)
        p.set_application_retain_height(6)
        first = p.prune_once()
        second = p.prune_once()
        out.append((ss.calls, bs.pruned, first, second, rows(db)))
    assert out[0] == out[1]
    assert out[0][:4] == ([("states", 1, 6, 6)], [6], (5, 6), (0, 6))
    assert [k for k, _ in out[0][4]] == [b"prune/app_retain_height"]


def test_pruner_pass_over_the_twin_stores(chains):
    def prune(side, ss, bs):
        s = SIDES[side]
        pr = s["pruner"].Pruner(ss, bs, s["MemDB"]())
        pr.set_application_retain_height(7)
        pr.set_application_retain_height(TOP + 5)   # a buggy app: clamped
        first = pr.prune_once()
        return first, pr.prune_once(), pr.get_application_retain_height()
    got, want = _both(chains, prune)
    assert got == want
    assert got[0] == ("ok", ((TOP - 1, TOP), (0, TOP), TOP + 5))


def test_pruner_service_wakes_and_retries():
    """The service prunes when the app's retain height moves, logs an
    error and goes on (the JAX log-and-retry), and stops when asked."""
    class Blocks:
        base, height = 1, 20
        fail = 1

        def prune_blocks(self, retain):
            if self.fail:
                self.fail -= 1
                raise OSError("disk hiccup")
            pruned, self.base = retain - self.base, retain
            return pruned, retain

    class States:
        def __init__(self):
            self.calls = []

        def prune_states(self, frm, to, ev):
            self.calls.append((frm, to))

    async def go():
        bs, ss = Blocks(), States()
        pr = p_pruner.Pruner(ss, bs, MemDB(), interval_s=0.02)
        errors = []
        pr.logger = type("L", (), {
            "info": lambda self, *a, **k: None,
            "error": lambda self, msg, **k: errors.append(msg)})()
        await pr.start()
        pr.set_application_retain_height(5)
        for _ in range(200):
            if bs.base == 5:
                break
            await asyncio.sleep(0.01)
        pr.set_application_retain_height(9)
        for _ in range(200):
            if bs.base == 9:
                break
            await asyncio.sleep(0.01)
        await pr.stop()
        return bs.base, ss.calls, errors, pr._task.done()

    base, calls, errors, done = run(go())
    assert base == 9 and calls == [(1, 5), (5, 9)] and done
    assert errors == ["pruning failed"]


def test_executor_hands_the_retain_height_to_the_pruner():
    """BlockExecutor passes the app's Commit retain_height to its pruner,
    as the JAX executor does, on a chain whose app keeps 3 heights."""
    key_seeds = seeds(3, 173)
    out = []
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        for side in ("port", "jax"):
            chain = (port_chain if side == "port" else RChain)(
                CHAIN_ID, key_seeds)
            chain.app.retain_blocks = 3
            s = SIDES[side]
            pr = s["pruner"].Pruner(chain.state_store, chain.block_store,
                                    s["MemDB"]())
            chain.exec.pruner = pr
            seen = []
            for h in range(1, 7):
                chain.step([b"k%d=v" % h])
                seen.append((chain.exec.last_retain_height,
                             pr.get_application_retain_height()))
            pr.prune_once()
            out.append((seen, chain.block_store.base,
                        rows(chain.dbs["block"]), rows(chain.dbs["state"]),
                        rows(chain.dbs["app"])))
    assert out[0] == out[1]
    assert out[0][0] == [(0, 0), (0, 0), (1, 1), (2, 2), (3, 3), (4, 4)]
    assert out[0][1] == 4


# -- config and metrics --------------------------------------------------------

def test_statesync_and_storage_config_equal_the_jax_ones():
    """Both sections hold the JAX fields with the JAX defaults, and the
    Config tree holds both sections."""
    for name in ("StateSyncConfig", "StorageConfig"):
        p, r = getattr(p_config, name)(), getattr(r_config, name)()
        for f in dataclasses.fields(p):
            assert getattr(p, f.name) == getattr(r, f.name), f.name
    assert [f.name for f in dataclasses.fields(p_config.StateSyncConfig)] \
        == [f.name for f in dataclasses.fields(r_config.StateSyncConfig)] \
        == ["enable", "rpc_servers", "trust_height", "trust_hash",
            "trust_period_ns", "discovery_time_ns",
            "chunk_request_timeout_ns", "chunk_fetchers", "temp_dir"]
    assert [f.name for f in dataclasses.fields(p_config.StorageConfig)] == \
        ["discard_abci_responses", "pruning_interval_ns"]
    cfg = p_config.Config()
    assert cfg.statesync == p_config.StateSyncConfig()
    assert cfg.storage.pruning_interval_ns == 10 * 10**9


def test_pruner_gauges_equal_the_jax_ones():
    p, r = PStateMetrics(), RStateMetrics()
    for name in ("application_block_retain_height",
                 "pruning_service_block_retain_height",
                 "block_store_base_height"):
        pg, rg = getattr(p, name), getattr(r, name)
        assert (pg.name, pg.help) == (rg.name, rg.help), name
    reg = p_libmetrics.Registry()
    PStateMetrics(reg).block_store_base_height.set(7)
    assert "cometbft_state_block_store_base_height 7" in reg.render()
