"""The port's Handshaker (cometbft_tpu_torch/consensus/replay.py) against
the JAX package's, the cases of tests/test_replay.py:62-143 on chains
built through the block executor instead of a ConsensusState:

  * genesis: the handshake sends InitChain; the app hash is the kvstore's
    version-0 tree root and Info reports height 0;
  * the app behind: a fresh app on the same stores gets heights 1..N
    replayed, ending at the final state's app hash;
  * the app synced: nothing is replayed;
  * an app hash that does not match the state's: the same ReplayError;
  * the app one block behind the stores (state saved at N - 1): the last
    block goes through a fresh executor, the state comes out equal;
  * ``exec_commit_block`` gives the app hash the stored block's successor
    carries;
  * a genesis without validators (C.11): the state's copy, and the
    store's rows after a handshake whose InitChain sets the validators.

Both sides run the same steps on the same seeded keys and are compared
exactly: app hashes, block counts, error texts.  The port runs
``device="cpu"`` with the accept-all stand-in kernel.
"""
import asyncio

import pytest

from cometbft_tpu.abci import types as r_abci
from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu.abci.kvstore import KVStoreApplication as RKVStore
from cometbft_tpu.consensus import replay as r_replay
from cometbft_tpu.crypto import batch as r_batch
from cometbft_tpu.crypto.ed25519 import Ed25519PrivKey as REd25519PrivKey
from cometbft_tpu.db import MemDB as RMemDB
from cometbft_tpu.libs.log import new_logger as r_new_logger
from cometbft_tpu.state import make_genesis_state as r_make_genesis_state
from cometbft_tpu.state.execution import BlockExecutor as RBlockExecutor
from cometbft_tpu.state.store import Store as RStore
from cometbft_tpu.store import BlockStore as RBlockStore
from cometbft_tpu.types.genesis import GenesisDoc as RGenesisDoc
from cometbft_tpu.types.timestamp import Timestamp as RTimestamp
from cometbft_tpu_torch.abci import types as abci
from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import KVStoreApplication
from cometbft_tpu_torch.consensus import replay
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.crypto.ed25519 import Ed25519PrivKey
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.libs.log import new_logger
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types.genesis import GenesisDoc
from cometbft_tpu_torch.types.timestamp import Timestamp
from torch_chain import RChain, accept_all, cs, port_chain, seeds
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)

CHAIN_ID = "replay-parity"
N, TOP = 4, 5


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    r_batch.set_backend("cpu")
    accept_all(monkeypatch)
    yield
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def _txs(h):
    return [b"k%d=v%d" % (h, j) for j in range(3)] + [cs._load_tx(7, h, 0)]


@pytest.fixture(scope="module")
def chains():
    key_seeds = seeds(N, 201)
    with pytest.MonkeyPatch.context() as mp:
        accept_all(mp)
        r_batch.set_backend("cpu")
        p = port_chain(CHAIN_ID, key_seeds)
        r = RChain(CHAIN_ID, key_seeds)
        for h in range(1, TOP + 1):
            p.step(_txs(h))
            r.step(_txs(h))
    assert p.applied == r.applied
    return p, r


PORT = {"kv": KVStoreApplication, "conns": AppConns, "mem": MemDB,
        "hs": lambda *a: replay.Handshaker(*a, device="cpu"),
        "exec": lambda *a, **kw: BlockExecutor(*a, device="cpu", **kw),
        "info": abci.InfoRequest, "store": Store, "bstore": BlockStore,
        "genesis": make_genesis_state, "replay": replay,
        "logger": new_logger}
REF = {"kv": RKVStore, "conns": RAppConns, "mem": RMemDB,
       "hs": r_replay.Handshaker, "exec": RBlockExecutor,
       "info": r_abci.InfoRequest, "store": RStore, "bstore": RBlockStore,
       "genesis": r_make_genesis_state, "replay": r_replay,
       "logger": r_new_logger}


def _both(chains):
    p, r = chains
    return ((p, PORT), (r, REF))


def _init_chain(chain, side):
    """A fresh app after the genesis handshake, and its conns."""
    state = side["genesis"](chain.doc)
    ss = side["store"](side["mem"]())
    ss.save(state)
    conns = side["conns"](side["kv"](db=side["mem"]()))
    asyncio.run(side["hs"](ss, state, side["bstore"](side["mem"]()),
                           chain.doc).handshake(conns))
    return conns


def test_genesis_handshake_calls_init_chain(chains):
    out = []
    for chain, side in _both(chains):
        state = side["genesis"](chain.doc)
        app = side["kv"]()
        conns = side["conns"](app)
        ss, bs = side["store"](side["mem"]()), side["bstore"](side["mem"]())
        ss.save(state)
        app_hash = asyncio.run(side["hs"](ss, state, bs, chain.doc)
                               .handshake(conns))
        assert len(app_hash) == 32 and app_hash == app.tree.root(0)
        info = asyncio.run(conns.query.info(side["info"]()))
        assert info.last_block_height == 0
        out.append((app_hash, state.app_hash, ss.load().bytes()))
    assert out[0] == out[1]


def test_app_behind_replays_blocks(chains):
    out = []
    for chain, side in _both(chains):
        final = chain.state_store.load()
        conns = side["conns"](side["kv"](db=side["mem"]()))
        hs = side["hs"](chain.state_store, final, chain.block_store,
                        chain.doc)
        app_hash = asyncio.run(hs.handshake(conns))
        info = asyncio.run(conns.query.info(side["info"]()))
        assert hs.n_blocks == TOP
        assert info.last_block_height == chain.block_store.height == TOP
        assert app_hash == info.last_block_app_hash == final.app_hash
        out.append((app_hash, hs.n_blocks))
    assert out[0] == out[1]


def test_app_synced_noop(chains):
    for chain, side in _both(chains):
        hs = side["hs"](chain.state_store, chain.state_store.load(),
                        chain.block_store, chain.doc)
        assert asyncio.run(hs.handshake(chain.conns)) == chain.state.app_hash
        assert hs.n_blocks == 0


def test_app_hash_mismatch_raises_the_same_error(chains):
    out = []
    for chain, side in _both(chains):
        final = chain.state_store.load()
        final.app_hash = b"\x42" * 32
        hs = side["hs"](chain.state_store, final, chain.block_store,
                        chain.doc)
        try:
            asyncio.run(hs.handshake(chain.conns))
        except Exception as e:  # noqa: BLE001 — compared below
            out.append((type(e).__name__, str(e)))
    assert out[0] == out[1]
    assert out[0][0] == "ReplayError"
    assert "does not match state app hash" in out[0][1]


def test_app_and_state_one_block_behind_the_store(chains):
    """The stores hold TOP blocks, the state and the app stop at TOP - 1:
    the last block is applied through a fresh executor with the real
    app."""
    out = []
    for chain, side in _both(chains):
        mem = side["mem"]
        ss, bs = side["store"](mem()), side["bstore"](mem())
        state = side["genesis"](chain.doc)
        ss.save(state)
        conns = side["conns"](side["kv"](db=mem()))
        asyncio.run(side["hs"](ss, state, bs, chain.doc).handshake(conns))
        # replay heights 1..TOP-1 by hand, as the node would have
        for h in range(1, TOP):
            blk = chain.block_store.load_block(h)
            meta = chain.block_store.load_block_meta(h)
            parts = blk.make_part_set()
            assert parts.header() == meta.block_id.part_set_header
            ex = side["exec"](ss, conns.consensus, block_store=bs)
            state = asyncio.run(ex.apply_verified_block(
                state, meta.block_id, blk))
            bs.save_block(blk, parts, chain.block_store.load_seen_commit(h))
        blk = chain.block_store.load_block(TOP)
        bs.save_block(blk, blk.make_part_set(),
                      chain.block_store.load_seen_commit(TOP))
        hs = side["hs"](ss, state, bs, chain.doc)
        app_hash = asyncio.run(hs.handshake(conns))
        assert hs.n_blocks == 1
        assert app_hash == chain.state.app_hash
        assert ss.load().bytes() == chain.state_store.load().bytes()
        out.append(app_hash)
    assert out[0] == out[1]


def test_exec_commit_block_gives_the_next_headers_app_hash(chains):
    out = []
    for chain, side in _both(chains):
        conns = _init_chain(chain, side)
        hashes = []
        for h in range(1, TOP):
            app_hash = asyncio.run(side["replay"].exec_commit_block(
                conns.consensus, chain.block_store.load_block(h),
                chain.state_store, 1, TOP, side["logger"]("replay")))
            assert app_hash == \
                chain.block_store.load_block(h + 1).header.app_hash
            hashes.append(app_hash)
        out.append(hashes)
    assert out[0] == out[1]


# --- C.11: a genesis without validators, the app sets them in InitChain ----

def _empty_genesis(pkg):
    """The JAX package's or the port's modules, and a genesis doc with no
    validators."""
    if pkg == "port":
        side = dict(PORT, key=Ed25519PrivKey, abci=abci)
        doc = GenesisDoc(chain_id=CHAIN_ID,
                         genesis_time=Timestamp(cs.EXEC_T0, 0))
    else:
        side = dict(REF, key=REd25519PrivKey, abci=r_abci)
        doc = RGenesisDoc(chain_id=CHAIN_ID,
                          genesis_time=RTimestamp(cs.EXEC_T0, 0))
    return side, doc


def test_copy_of_a_genesis_state_without_validators_matches_the_reference():
    """C.11: the JAX package's empty ValidatorSet is falsy (``__len__``),
    so ``State.copy()`` turns the empty sets of a genesis without
    validators into None; the port's sets were always truthy and its
    copy kept them, two empty fields more on the wire."""
    out = []
    for pkg in ("port", "ref"):
        side, doc = _empty_genesis(pkg)
        state = side["genesis"](doc)
        cp = state.copy()
        out.append((cp.bytes(), cp.validators is None,
                    cp.next_validators is None, cp.last_validators is None,
                    state.bytes()))
    assert out[0] == out[1]
    assert out[0][1:4] == (True, True, True)


def test_handshake_that_sets_the_validators_stores_the_reference_rows():
    """InitChain returns the validators a genesis without any lacks: the
    state store's rows after the handshake, and the state loaded back
    and its copy, are the JAX package's."""
    key_seeds = seeds(3, 211)
    out = []
    for pkg in ("port", "ref"):
        side, doc = _empty_genesis(pkg)
        updates = [side["key"](s).pub_key() for s in key_seeds]

        class InitValidators(side["kv"]):
            async def init_chain(self, req):
                res = await super().init_chain(req)
                res.validators = [side["abci"].ValidatorUpdate(
                    power=10, pub_key_type=pk.type(),
                    pub_key_bytes=pk.bytes()) for pk in updates]
                return res

        state = side["genesis"](doc)
        ss = side["store"](side["mem"]())
        ss.save(state)
        conns = side["conns"](InitValidators(db=side["mem"]()))
        asyncio.run(side["hs"](ss, state, side["bstore"](side["mem"]()),
                               doc).handshake(conns))
        loaded = ss.load()
        assert len(loaded.validators.validators) == 3
        out.append((list(ss._db.iterator()), loaded.bytes(),
                    loaded.copy().bytes(),
                    loaded.copy().last_validators is None))
    assert out[0] == out[1]
