"""The port's mempool (mempool/{mempool,messages,reactor,metrics}.py) and
load-generator payloads (tools/loadtime.py) against the JAX package's.

  * tests/test_mempool_light.py's mempool cases (TestMempool,
    TestIncrementalRecheck, TestCheckTxCommitRace, TestTxCache,
    TestLaneBytesBookkeeping) and tests/test_recon_gossip.py's cases that
    touch the ported modules (short ids, salt rotation, the want tracker,
    the flood fallback, the features, the two-node pull over sockets, the
    append log), each parametrised over both packages, so that each
    package's run of a case counts;
  * the same txs through both pools: the same reap order, the same
    verdicts, the same recheck counts;
  * the three mempool messages byte-equal and cross-decoded;
  * a mixed socket net of two JAX and two port nodes exchanging txs on
    both planes (have/want between nodes that negotiate ``txrecon/1``,
    flood to the ones that do not);
  * tests/test_loadtime.py's payload cases, and the payloads byte-equal.

The mempool touches no device.  Every socket binds ``127.0.0.1:0`` and
every wait has a bound.
"""
import asyncio
import dataclasses
import json
from types import SimpleNamespace

import numpy as np
import pytest

import cometbft_tpu.abci.kvstore as r_kv
import cometbft_tpu.abci.types as r_abci
import cometbft_tpu.config as r_config
import cometbft_tpu.mempool as r_mempool_pkg
import cometbft_tpu.mempool.mempool as r_mempool
import cometbft_tpu.mempool.messages as r_mm
import cometbft_tpu.mempool.reactor as r_reactor
import cometbft_tpu.p2p.key as r_key
import cometbft_tpu.p2p.switch as r_switch
import cometbft_tpu.tools.loadtime as r_loadtime
import cometbft_tpu.types.tx as r_tx
import cometbft_tpu_torch.abci.kvstore as p_kv
import cometbft_tpu_torch.abci.types as p_abci
import cometbft_tpu_torch.config as p_config
import cometbft_tpu_torch.mempool as p_mempool_pkg
import cometbft_tpu_torch.mempool.mempool as p_mempool
import cometbft_tpu_torch.mempool.messages as p_mm
import cometbft_tpu_torch.mempool.reactor as p_reactor
import cometbft_tpu_torch.p2p.key as p_key
import cometbft_tpu_torch.p2p.switch as p_switch
import cometbft_tpu_torch.tools.loadtime as p_loadtime
import cometbft_tpu_torch.types.tx as p_tx
from cometbft_tpu.abci.client import AppConns as RAppConns
from cometbft_tpu_torch import convert
from cometbft_tpu_torch.abci.client import AppConns as PAppConns
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def _ns(abci, kv, config, pkg, mempool, mm, reactor, key, switch, tx,
        conns):
    return SimpleNamespace(
        abci=abci, kv=kv, MempoolConfig=config.MempoolConfig,
        CListMempool=pkg.CListMempool, MempoolError=pkg.MempoolError,
        NopMempool=pkg.NopMempool, TxCache=pkg.TxCache,
        InvalidTxError=mempool.InvalidTxError,
        TxInCacheError=mempool.TxInCacheError,
        MempoolFullError=mempool.MempoolFullError,
        mm=mm, MempoolReactor=reactor.MempoolReactor,
        MEMPOOL_CHANNEL=reactor.MEMPOOL_CHANNEL,
        NodeKey=key.NodeKey, Switch=switch.Switch, NodeInfo=switch.NodeInfo,
        tx_key=tx.tx_key, AppConns=conns, mempool_mod=mempool)


PKGS = {
    "jax": _ns(r_abci, r_kv, r_config, r_mempool_pkg, r_mempool, r_mm,
               r_reactor, r_key, r_switch, r_tx, RAppConns),
    "port": _ns(p_abci, p_kv, p_config, p_mempool_pkg, p_mempool, p_mm,
                p_reactor, p_key, p_switch, p_tx, PAppConns),
}


@pytest.fixture(params=sorted(PKGS))
def pk(request):
    return PKGS[request.param]


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


async def _wait_for(pred, timeout=5.0, what="condition"):
    loop = asyncio.get_running_loop()
    deadline = loop.time() + timeout
    while not pred():
        if loop.time() > deadline:
            raise AssertionError(f"timed out waiting for {what}")
        await asyncio.sleep(0.01)


def _mk_mempool(pk, app=None, **cfg_kw):
    app = app if app is not None else pk.kv.KVStoreApplication()
    conns = pk.AppConns(app)
    mp = pk.CListMempool(pk.MempoolConfig(**cfg_kw), conns.mempool,
                         lanes=pk.kv.DEFAULT_LANES, default_lane="default")
    return mp, app


def _counting_kv(pk):
    """A kvstore that counts CheckTx calls by type and can refuse the
    recheck of chosen txs (test_mempool_light.py _CountingKV)."""
    abci = pk.abci

    class CountingKV(pk.kv.KVStoreApplication):
        def __init__(self):
            super().__init__()
            self.checks = 0
            self.rechecks = 0
            self.reject_on_recheck: set = set()

        async def check_tx(self, req):
            if req.type == abci.CHECK_TX_TYPE_RECHECK:
                self.rechecks += 1
                if bytes(req.tx) in self.reject_on_recheck:
                    return abci.CheckTxResponse(code=9)
            else:
                self.checks += 1
            return await super().check_tx(req)

    return CountingKV


def _committed(pk, tx):
    return pk.abci.ExecTxResult(code=pk.abci.CODE_TYPE_OK,
                                recheck_keys=pk.kv.tx_recheck_keys(tx))


# -- tests/test_mempool_light.py TestMempool ----------------------------------

def test_check_tx_and_reap(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        await mp.check_tx(b"a=1")
        await mp.check_tx(b"b=2")
        assert mp.size() == 2
        assert sorted(mp.reap_max_bytes_max_gas(-1, -1)) == \
            [b"a=1", b"b=2"]
    run(go())


def test_duplicate_rejected_via_cache(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        await mp.check_tx(b"a=1")
        with pytest.raises(pk.TxInCacheError,
                           match="tx already exists in cache"):
            await mp.check_tx(b"a=1")
        assert mp.size() == 1
    run(go())


def test_invalid_tx_rejected(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        with pytest.raises(pk.InvalidTxError,
                           match="tx rejected by CheckTx: code"):
            await mp.check_tx(b"garbage-no-sep")
        assert mp.size() == 0
    run(go())


def test_lane_assignment_and_priority_order(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        for tx in (b"9=x", b"5=x", b"22=x"):
            await mp.check_tx(tx)
        assert mp.lane_sizes("foo") == (1, 4)
        assert mp.lane_sizes("bar") == (1, 3)
        order = mp.reap_max_bytes_max_gas(-1, -1)
        assert order[0] == b"22=x"
        assert order.index(b"22=x") < order.index(b"5=x") < \
            order.index(b"9=x")
    run(go())


def test_reap_respects_max_bytes(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        for i in range(10):
            await mp.check_tx(f"k{i}=v{i}".encode())
        txs = mp.reap_max_bytes_max_gas(12, -1)
        assert sum(len(t) for t in txs) <= 12
        assert len(txs) >= 1
    run(go())


def test_full_and_oversized_rejected(pk):
    async def go():
        mp, _ = _mk_mempool(pk, size=2, max_tx_bytes=16)
        await mp.check_tx(b"a=1")
        await mp.check_tx(b"b=2")
        with pytest.raises(pk.MempoolFullError,
                           match="mempool is full: 2 txs, 6 bytes"):
            await mp.check_tx(b"c=3")
        with pytest.raises(pk.MempoolError,
                           match="tx too large: 17 > 16"):
            await mp.check_tx(b"d=" + b"x" * 15)
    run(go())


def test_update_removes_committed_and_rechecks(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        await mp.check_tx(b"a=1")
        await mp.check_tx(b"b=2")
        await mp.update(5, [b"a=1"], [pk.abci.ExecTxResult(code=0)])
        assert mp.size() == 1
        assert mp.get_tx_by_hash(pk.tx_key(b"b=2")) == b"b=2"
        assert mp.get_tx_by_hash(pk.tx_key(b"a=1")) is None
        with pytest.raises(pk.TxInCacheError):
            await mp.check_tx(b"a=1")
    run(go())


def test_txs_available_notification(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        mp.enable_txs_available()
        ev = mp.txs_available()
        assert not ev.is_set()
        await mp.check_tx(b"a=1")
        assert ev.is_set()
        await mp.update(1, [b"a=1"], [pk.abci.ExecTxResult(code=0)])
        assert not ev.is_set()
    run(go())


def test_nop_mempool(pk):
    async def go():
        mp = pk.NopMempool()
        assert mp.reap_max_bytes_max_gas(-1, -1) == []
        with pytest.raises(pk.MempoolError, match="mempool is disabled"):
            await mp.check_tx(b"a=1")
    run(go())


def test_lock_holds_check_tx_until_unlock(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        mp.pre_update()
        mp.lock()
        task = asyncio.get_running_loop().create_task(mp.check_tx(b"a=1"))
        await asyncio.sleep(0.02)
        assert not task.done() and mp.size() == 0
        mp.unlock()
        await asyncio.wait_for(task, 5)
        assert mp.size() == 1
    run(go())


# -- TestIncrementalRecheck ---------------------------------------------------

def test_recheck_targets_only_touched_keys(pk):
    async def go():
        mp, app = _mk_mempool(pk, app=_counting_kv(pk)())
        for tx in (b"aa=1", b"bb=2", b"cc=3"):
            await mp.check_tx(tx)
        await mp.update(1, [b"aa=9"], [_committed(pk, b"aa=9")])
        assert app.rechecks == 1 and mp.size() == 3
        assert mp.get_entry(pk.tx_key(b"aa=1")).height == 1
    run(go())


def test_recheck_watermark_bounds_staleness(pk):
    async def go():
        mp, app = _mk_mempool(pk, app=_counting_kv(pk)(),
                              recheck_max_age_blocks=2)
        await mp.check_tx(b"bb=2")
        seen = []
        for h in (1, 2, 3):
            await mp.update(h, [b"zz=%d" % h], [_committed(pk, b"zz=%d" % h)])
            seen.append(app.rechecks)
        assert seen == [0, 1, 1]
    run(go())


def test_unattributed_commit_rechecks_keyed_entries(pk):
    async def go():
        mp, app = _mk_mempool(pk, app=_counting_kv(pk)())
        for tx in (b"aa=1", b"bb=2"):
            await mp.check_tx(tx)
        await mp.update(1, [b"zz=9"],
                        [pk.abci.ExecTxResult(code=pk.abci.CODE_TYPE_OK)])
        assert app.rechecks == 2
    run(go())


def test_incremental_off_restores_full_recheck(pk):
    async def go():
        mp, app = _mk_mempool(pk, app=_counting_kv(pk)(),
                              recheck_incremental=False)
        for tx in (b"aa=1", b"bb=2", b"cc=3"):
            await mp.check_tx(tx)
        await mp.update(1, [b"zz=9"], [_committed(pk, b"zz=9")])
        assert app.rechecks == 3
    run(go())


def test_recheck_evicts_invalidated_tx(pk):
    async def go():
        mp, app = _mk_mempool(pk, app=_counting_kv(pk)())
        await mp.check_tx(b"aa=1")
        await mp.check_tx(b"bb=2")
        app.reject_on_recheck.add(b"aa=1")
        await mp.update(1, [b"aa=9"], [_committed(pk, b"aa=9")])
        assert mp.size() == 1 and not mp.contains(pk.tx_key(b"aa=1"))
        assert mp.size_bytes() == len(b"bb=2")
        await mp.check_tx(b"aa=1")
        assert mp.size() == 2
    run(go())


def test_batched_recheck_full_pass_parity(pk):
    async def go():
        mp, app = _mk_mempool(pk, app=_counting_kv(pk)(),
                              recheck_incremental=False,
                              recheck_batch_size=8)
        txs = [b"k%02dx=v" % i for i in range(30)]
        for tx in txs:
            await mp.check_tx(tx)
        app.reject_on_recheck = {txs[3], txs[17], txs[29]}
        await mp.update(1, [b"zz=9"], [_committed(pk, b"zz=9")])
        assert app.rechecks == 30 and mp.size() == 27
        assert mp.size_bytes() == sum(
            len(t) for t in txs if t not in app.reject_on_recheck)
    run(go())


# -- TestCheckTxCommitRace ----------------------------------------------------

def test_in_flight_checktx_revalidated_by_next_update(pk):
    base = _counting_kv(pk)

    class GatedKV(base):
        def __init__(self):
            super().__init__()
            self.gate = asyncio.Event()
            self.entered = asyncio.Event()

        async def check_tx(self, req):
            if req.type == pk.abci.CHECK_TX_TYPE_CHECK and \
                    not self.gate.is_set():
                self.entered.set()
                await self.gate.wait()
            return await super().check_tx(req)

    async def go():
        app = GatedKV()
        mp, _ = _mk_mempool(pk, app=app)
        task = asyncio.get_running_loop().create_task(mp.check_tx(b"aa=1"))
        await app.entered.wait()
        mp.lock()
        await mp.update(5, [b"zz=9"], [_committed(pk, b"zz=9")])
        mp.unlock()
        app.gate.set()
        await task
        assert mp.size() == 1
        assert pk.tx_key(b"aa=1") in mp._pending_recheck
        assert mp.metrics.checktx_revalidations.value >= 1
        assert app.rechecks == 0
        await mp.update(6, [b"zz=8"], [_committed(pk, b"zz=8")])
        assert app.rechecks == 1 and not mp._pending_recheck
        await mp.update(7, [b"zz=7"], [_committed(pk, b"zz=7")])
        assert app.rechecks == 1
    run(go())


def test_tx_cache_lru_eviction(pk):
    c = pk.TxCache(2)
    assert c.push(b"a") and c.push(b"b")
    assert not c.push(b"a")
    assert c.push(b"c")
    assert c.has(b"a") and not c.has(b"b") and c.has(b"c")


def test_lane_bytes_match_recount_through_lifecycle(pk):
    async def go():
        mp, _ = _mk_mempool(pk)

        def recount(lane):
            d = mp._lane_txs[lane]
            return len(d), sum(len(e.tx) for e in d.values())

        txs = [b"k%03d=v%d" % (i, i) for i in range(12)]
        for tx in txs:
            await mp.check_tx(tx)
        assert all(mp.lane_sizes(ln) == recount(ln) for ln in mp.lanes)
        for tx in txs[::3]:
            mp.remove_tx_by_key(pk.tx_key(tx))
        assert all(mp.lane_sizes(ln) == recount(ln) for ln in mp.lanes)
        with pytest.raises(pk.MempoolError,
                           match="transaction not found in mempool"):
            mp.remove_tx_by_key(pk.tx_key(txs[0]))
        mp.flush()
        assert all(mp.lane_sizes(ln) == (0, 0) == recount(ln)
                   for ln in mp.lanes)
    run(go())


# -- both pools on the same txs ----------------------------------------------

def _seeded_txs(n, seed):
    rng = np.random.default_rng(seed)
    keys = ["val", "foo", "bar", "k", "5", "9", "22", "aa", "bb"]
    out = []
    for i in range(n):
        k = keys[int(rng.integers(len(keys)))]
        out.append(b"%s%d=%s" % (k.encode(), i,
                                 rng.bytes(int(rng.integers(1, 24))).hex()
                                 .encode()))
    out += [b"no-separator", out[3], out[7]]   # refused and duplicates
    return out


async def _drive(pk, txs, seed):
    """Every tx through check_tx, then three commits: the outcomes, the
    reap orders and the recheck counts."""
    mp, app = _mk_mempool(pk, app=_counting_kv(pk)(), size=40,
                          recheck_max_age_blocks=2)
    verdicts = []
    for tx in txs:
        try:
            await mp.check_tx(tx)
            verdicts.append("ok")
        except pk.MempoolError as e:
            verdicts.append(f"{type(e).__name__}: {e}")
    reaps = [mp.reap_max_bytes_max_gas(-1, -1),
             mp.reap_max_bytes_max_gas(300, -1), mp.reap_max_txs(7)]
    rng = np.random.default_rng(seed)
    for h in (1, 2, 3):
        pool = mp.reap_max_txs(-1)
        picked = [pool[int(i)] for i in rng.choice(
            len(pool), size=min(5, len(pool)), replace=False)]
        await mp.update(h, picked, [_committed(pk, t) for t in picked])
        reaps.append(mp.reap_max_bytes_max_gas(-1, -1))
    return verdicts, reaps, app.rechecks, mp.size(), mp.size_bytes()


def test_both_pools_agree_on_seeded_txs():
    txs = _seeded_txs(48, 7)
    jax_out = run(_drive(PKGS["jax"], txs, 11))
    port_out = run(_drive(PKGS["port"], txs, 11))
    assert port_out == jax_out
    assert "MempoolFullError: mempool is full: 40 txs" in \
        " ".join(port_out[0])


# -- tests/test_recon_gossip.py: the cases that touch the ported modules ------

class _StubPeer:
    def __init__(self, pk, pid="aa" * 20, features=()):
        self.pk = pk
        self.id = pid
        self.sent = []
        self.node_info = SimpleNamespace(features=tuple(features))

    def has_feature(self, name):
        return name in self.node_info.features

    def send(self, chan_id, payload):
        self.sent.append((chan_id, payload))
        return True

    def decoded(self):
        return [self.pk.mm.decode_mempool(p) for _, p in self.sent]


def test_short_ids_salted_and_bulk(pk):
    mm = pk.mm
    k = pk.tx_key(b"tx-1")
    assert mm.short_id(b"salt-a", k) != mm.short_id(b"salt-b", k)
    assert len(mm.short_id(b"salt-a", k)) == mm.SHORT_ID_LEN
    keys = [pk.tx_key(b"tx-%d" % i) for i in range(100)]
    assert mm.short_ids(b"s", keys) == [mm.short_id(b"s", k) for k in keys]
    ids = mm.short_ids(b"salty-8b", keys[:64])
    raw = mm.encode_mempool(mm.TxHaveMessage(b"salty-8b", ids))
    assert len(raw) < 64 * mm.SHORT_ID_LEN + 64
    got = mm.decode_mempool(raw)
    assert got.ids == ids and got.salt == b"salty-8b"


def test_summary_self_collision_rotates_salt(pk, monkeypatch):
    monkeypatch.setattr(pk.mm, "SHORT_ID_LEN", 1)

    async def go():
        mp, _ = _mk_mempool(pk)
        reactor = pk.MempoolReactor(mp, pk.MempoolConfig(recon_push_peers=0))
        peer = _StubPeer(pk, features=(pk.mm.FEATURE_TXRECON,))
        for i in range(64):
            await mp.check_tx(b"col%03d=v" % i)
        await reactor.add_peer(peer)
        await _wait_for(lambda: peer.sent, what="advert")
        await asyncio.sleep(0.05)
        assert any(isinstance(m, pk.mm.TxHaveMessage)
                   for m in peer.decoded())
        assert mp.metrics.recon_salt_rotations.value > 0
        assert reactor._salt_bump <= 8
        await reactor.remove_peer(peer, "done")
    run(go())


def test_salt_follows_height_epoch(pk):
    mp, _ = _mk_mempool(pk)
    r = pk.MempoolReactor(mp, pk.MempoolConfig(recon_salt_epoch_blocks=16))
    s0 = r._current_salt()
    mp.height = 15
    assert r._current_salt() == s0
    mp.height = 16
    assert r._current_salt() != s0


def test_salts_equal_across_packages():
    salts = []
    for name in ("jax", "port"):
        pk = PKGS[name]
        mp, _ = _mk_mempool(pk)
        r = pk.MempoolReactor(mp, pk.MempoolConfig())
        got = []
        for h in (0, 15, 16, 40, 1000):
            mp.height = h
            got.append(r._current_salt())
        r._rotate_salt()
        got.append(r._current_salt())
        salts.append(got)
    assert salts[0] == salts[1]


def _recon_pair(pk):
    mp, _ = _mk_mempool(pk)
    reactor = pk.MempoolReactor(mp, pk.MempoolConfig())
    feats = (pk.mm.FEATURE_TXRECON,)
    a = _StubPeer(pk, pid="aa" * 20, features=feats)
    b = _StubPeer(pk, pid="bb" * 20, features=feats)
    reactor._recon_peers = {a.id: a, b.id: b}
    return mp, reactor, a, b


def test_want_goes_to_first_advertiser_only(pk):
    async def go():
        mp, reactor, a, b = _recon_pair(pk)
        salt = b"s" * 8
        sid = pk.mm.short_id(salt, pk.tx_key(b"unknown-tx"))
        reactor._receive_have(pk.mm.TxHaveMessage(salt, [sid]), a)
        reactor._receive_have(pk.mm.TxHaveMessage(salt, [sid]), b)
        wants_a = [m for m in a.decoded()
                   if isinstance(m, pk.mm.TxWantMessage)]
        assert wants_a and wants_a[0].ids == [sid]
        assert not [m for m in b.decoded()
                    if isinstance(m, pk.mm.TxWantMessage)]
        assert reactor._wants.get(salt, sid).advertisers == [a.id, b.id]
    run(go())


def test_timeout_refetches_from_second_advertiser(pk):
    async def go():
        mp, reactor, a, b = _recon_pair(pk)
        salt = b"s" * 8
        sid = pk.mm.short_id(salt, pk.tx_key(b"lost-tx"))
        reactor._receive_have(pk.mm.TxHaveMessage(salt, [sid]), a)
        reactor._receive_have(pk.mm.TxHaveMessage(salt, [sid]), b)
        now = asyncio.get_running_loop().time()
        reactor.sweep_wants(now + 2.0, timeout_s=1.0)
        wants_b = [m for m in b.decoded()
                   if isinstance(m, pk.mm.TxWantMessage)]
        assert wants_b and wants_b[0].ids == [sid]
        assert mp.metrics.recon_want_refetches.value == 1
        for i in range(6):
            reactor.sweep_wants(now + 10.0 + 3 * i, timeout_s=1.0)
        assert reactor._wants.get(salt, sid) is None
        assert mp.metrics.recon_want_expired.value == 1
    run(go())


def test_arriving_tx_settles_want_and_want_is_served(pk):
    async def go():
        mp, reactor, a, _ = _recon_pair(pk)
        tx = b"wanted=v"
        salt = reactor._current_salt()
        sid = pk.mm.short_id(salt, pk.tx_key(tx))
        reactor._receive_have(pk.mm.TxHaveMessage(salt, [sid]), a)
        assert reactor._wants.get(salt, sid) is not None
        await reactor._receive_txs(pk.mm.TxsMessage([tx]), a)
        assert reactor._wants.get(salt, sid) is None
        assert mp.contains(pk.tx_key(tx))
        txs = [b"serve%02d=v" % i for i in range(10)]
        for t in txs:
            await mp.check_tx(t)
        peer = _StubPeer(pk, pid="cc" * 20,
                         features=(pk.mm.FEATURE_TXRECON,))
        reactor._receive_want(pk.mm.TxWantMessage(
            salt, [pk.mm.short_id(salt, pk.tx_key(t)) for t in txs]), peer)
        got = [m for m in peer.decoded() if isinstance(m, pk.mm.TxsMessage)]
        assert sorted(t for m in got for t in m.txs) == sorted(txs)
    run(go())


def test_non_negotiating_peer_gets_full_txs(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        reactor = pk.MempoolReactor(mp, pk.MempoolConfig())
        old = _StubPeer(pk, pid="cc" * 20)
        new = _StubPeer(pk, pid="dd" * 20,
                        features=(pk.mm.FEATURE_TXRECON,))
        await reactor.add_peer(old)
        await reactor.add_peer(new)
        await mp.check_tx(b"interop=1", sender="ee" * 20)
        await _wait_for(lambda: old.sent and new.sent, what="both planes")
        assert any(isinstance(m, pk.mm.TxsMessage) and b"interop=1" in m.txs
                   for m in old.decoded())
        assert not any(isinstance(m, pk.mm.TxHaveMessage)
                       for m in old.decoded())
        assert any(isinstance(m, pk.mm.TxHaveMessage) for m in new.decoded())
        assert not any(isinstance(m, pk.mm.TxsMessage)
                       for m in new.decoded())
        await reactor.remove_peer(old, "done")
        await reactor.remove_peer(new, "done")
    run(go())


def test_local_tx_pushed_to_fast_path_peers(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        reactor = pk.MempoolReactor(mp, pk.MempoolConfig(recon_push_peers=2))
        peer = _StubPeer(pk, features=(pk.mm.FEATURE_TXRECON,))
        await reactor.add_peer(peer)
        await mp.check_tx(b"local=1")
        await _wait_for(lambda: peer.sent, what="push")
        assert any(isinstance(m, pk.mm.TxsMessage) and b"local=1" in m.txs
                   for m in peer.decoded())
        assert mp.metrics.recon_pushed_txs.value >= 1
        await reactor.remove_peer(peer, "done")
    run(go())


def test_duplicate_delivery_ratio_gauge(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        reactor = pk.MempoolReactor(mp, pk.MempoolConfig())
        peer = _StubPeer(pk, features=(pk.mm.FEATURE_TXRECON,))
        await reactor._receive_txs(pk.mm.TxsMessage([b"d=1", b"d=2"]), peer)
        await reactor._receive_txs(pk.mm.TxsMessage([b"d=1"]), peer)
        m = mp.metrics
        assert m.gossip_txs_received.value == 3
        assert m.gossip_txs_duplicate.value == 1
        assert abs(m.duplicate_delivery_ratio.value - 1 / 3) < 1e-9
    run(go())


def test_switch_aggregates_reactor_features(pk):
    sw = pk.Switch(pk.NodeKey.generate(), "net")
    mp, _ = _mk_mempool(pk)
    sw.add_reactor(pk.MempoolReactor(mp, pk.MempoolConfig()))
    assert pk.mm.FEATURE_TXRECON in sw.node_info().features
    sw2 = pk.Switch(pk.NodeKey.generate(), "net")
    mp2, _ = _mk_mempool(pk)
    sw2.add_reactor(pk.MempoolReactor(mp2, pk.MempoolConfig(
        gossip_reconciliation=False)))
    assert pk.mm.FEATURE_TXRECON not in sw2.node_info().features


def test_two_node_pull_path_over_sockets(pk):
    async def go():
        switches, pools = [], []
        for _ in range(2):
            mp, _ = _mk_mempool(pk)
            r = pk.MempoolReactor(mp, pk.MempoolConfig(
                recon_push_peers=0, recon_want_timeout_ns=500_000_000))
            sw = pk.Switch(pk.NodeKey.generate(), "recon-e2e",
                           listen_addr="127.0.0.1:0")
            sw.add_reactor(r)
            switches.append(sw)
            pools.append(mp)
        for sw in switches:
            await sw.start()
        try:
            await switches[0].dial_peer(switches[1].listen_addr)
            tx = b"e2epull=" + b"v" * 64
            await pools[0].check_tx(tx)
            await _wait_for(lambda: pools[1].contains(pk.tx_key(tx)),
                            timeout=8.0, what="the tx to cross by want/pull")
            assert pools[1].metrics.recon_wants_sent.value >= 1
            assert pools[1].metrics.gossip_txs_duplicate.value == 0
            assert pools[0].metrics.recon_wants_received.value >= 1
        finally:
            for sw in switches:
                await sw.stop()
    run(go())


def test_append_log_covers_trims_and_flushes(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        txs = [b"log%02d=v" % i for i in range(5)]
        for tx in txs:
            await mp.check_tx(tx)
        assert mp.keys_appended_after(-1) == [pk.tx_key(t) for t in txs]
        mid = mp._append_log[2][0]
        assert mp.keys_appended_after(mid) == [pk.tx_key(t) for t in txs[3:]]
        assert mp.keys_appended_after(mp._seq) == []
        mp.flush()
        assert mp.keys_appended_after(mp._seq) == []
        assert mp.keys_appended_after(-1) is None
        mp2, _ = _mk_mempool(pk)
        mp2._APPEND_LOG_MAX = 8
        for i in range(12):
            await mp2.check_tx(b"trim%02d=v" % i)
        assert mp2._log_start_seq > -1
        assert mp2.keys_appended_after(-1) is None
        assert mp2.keys_appended_after(mp2._log_start_seq) is not None
    run(go())


def test_fresh_entries_uses_log_and_fallback(pk):
    async def go():
        mp, _ = _mk_mempool(pk)
        r = pk.MempoolReactor(mp, pk.MempoolConfig())
        for i in range(6):
            await mp.check_tx(b"fe%02d=v" % i, sender="")
        keys = [e.key for e in r._fresh_entries(-1, "zz" * 20, set())]
        assert len(keys) == 6
        mp.remove_tx_by_key(keys[0])
        left = [e.key for e in r._fresh_entries(-1, "zz" * 20, set())]
        assert keys[0] not in left and len(left) == 5
        left2 = r._fresh_entries(-1, "zz" * 20, {keys[1]})
        assert keys[1] not in [e.key for e in left2]
    run(go())


# -- the messages byte-equal ----------------------------------------------------

def _messages(mm, rng):
    keys = [rng.bytes(32) for _ in range(40)]
    salt = rng.bytes(8)
    txs = [rng.bytes(int(rng.integers(0, 300))) for _ in range(9)]
    return [mm.TxsMessage(txs), mm.TxsMessage([]),
            mm.TxHaveMessage(salt, mm.short_ids(salt, keys)),
            mm.TxWantMessage(salt, mm.short_ids(salt, keys[:7])),
            mm.TxHaveMessage(b"", [])]


def test_mempool_messages_byte_equal_and_cross_decode():
    ours = [p_mm.encode_mempool(m)
            for m in _messages(p_mm, np.random.default_rng(5))]
    theirs = [r_mm.encode_mempool(m)
              for m in _messages(r_mm, np.random.default_rng(5))]
    assert ours == theirs
    for raw in ours:
        a, b = p_mm.decode_mempool(raw), r_mm.decode_mempool(raw)
        assert type(a).__name__ == type(b).__name__
        assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert p_mm.encode_mempool(a) == raw
    assert p_reactor.MEMPOOL_CHANNEL == r_reactor.MEMPOOL_CHANNEL == 0x30
    assert p_mm.FEATURE_TXRECON == r_mm.FEATURE_TXRECON
    with pytest.raises(ValueError, match="unknown mempool message"):
        p_mm.decode_mempool(b"")


def test_mempool_config_defaults_and_convert():
    r_cfg = dataclasses.asdict(r_config.MempoolConfig())
    p_cfg = dataclasses.asdict(p_config.MempoolConfig())
    assert p_cfg == r_cfg
    assert list(p_cfg) == list(r_cfg)
    custom = dataclasses.asdict(r_config.MempoolConfig(
        size=7, recon_push_peers=0, gossip_reconciliation=False))
    got = convert.mempool_config(custom)
    assert got.size == 7 and got.recon_push_peers == 0 and \
        not got.gossip_reconciliation
    assert p_config.Config().blocksync.enable is \
        r_config.Config().blocksync.enable is True
    with pytest.raises(TypeError, match="MempoolConfig dict"):
        convert.mempool_config(r_config.MempoolConfig())


# -- a mixed socket net ---------------------------------------------------------

def test_mixed_net_exchanges_txs_on_both_planes():
    """Two JAX and two port nodes, full mesh over the secret connection:
    one node of each package negotiates ``txrecon/1``, the other floods.
    Txs submitted at every node reach every pool; the recon pair moves
    them by have/want, every other link by flood."""
    async def go():
        nodes = []
        for name, recon in (("jax", True), ("port", True),
                            ("jax", False), ("port", False)):
            pk = PKGS[name]
            mp, _ = _mk_mempool(pk)
            sw = pk.Switch(pk.NodeKey.generate(), "mixed-mempool",
                           listen_addr="127.0.0.1:0")
            sw.add_reactor(pk.MempoolReactor(mp, pk.MempoolConfig(
                gossip_reconciliation=recon, recon_push_peers=0)))
            nodes.append((pk, sw, mp))
        for _, sw, _ in nodes:
            await sw.start()
        try:
            for i, (_, sw, _) in enumerate(nodes):
                for _, other, _ in nodes[i + 1:]:
                    await asyncio.wait_for(
                        sw.dial_peer(other.listen_addr), 10)
            await _wait_for(lambda: all(sw.num_peers() == 3
                                        for _, sw, _ in nodes),
                            what="the mesh")
            rng = np.random.default_rng(3)
            txs = [b"mx%03d=%s" % (i, rng.bytes(16).hex().encode())
                   for i in range(40)]
            for i, tx in enumerate(txs):
                await nodes[i % 4][2].check_tx(tx)
            await _wait_for(lambda: all(mp.size() == len(txs)
                                        for _, _, mp in nodes),
                            timeout=15.0, what="every pool to hold every tx")
            for pk, _, mp in nodes:
                assert sorted(mp.reap_max_txs(-1)) == sorted(txs)
            # the recon pair pulled by want; the flood nodes never did
            assert nodes[0][2].metrics.recon_wants_sent.value + \
                nodes[1][2].metrics.recon_wants_sent.value > 0
            assert nodes[2][2].metrics.recon_wants_sent.value == 0
            assert nodes[3][2].metrics.recon_wants_sent.value == 0
        finally:
            for _, sw, _ in nodes:
                await sw.stop()
    run(go())


# -- tests/test_loadtime.py's payload cases ------------------------------------

@pytest.mark.parametrize("lt", [r_loadtime, p_loadtime],
                         ids=["jax", "port"])
def test_payload_roundtrip_and_padding(lt):
    tx = lt.payload_bytes("exp1", size=300, rate=50, connections=2)
    assert len(tx) >= 300 and tx.startswith(b"a=")
    p = lt.payload_from_tx(tx)
    assert p["id"] == "exp1" and p["rate"] == 50 and p["time_ns"] > 0
    assert lt.payload_from_tx(b"other=tx") is None
    assert lt.payload_from_tx(b"a=nothex!") is None
    with pytest.raises(ValueError, match="too large"):
        lt.payload_bytes("x", size=lt.MAX_PAYLOAD_SIZE + 1)


@pytest.mark.parametrize("lt", [r_loadtime, p_loadtime],
                         ids=["jax", "port"])
def test_stats(lt):
    s = lt.Stats.from_samples([1.0, 2.0, 3.0, 4.0])
    assert s.count == 4 and s.min_s == 1.0 and s.max_s == 4.0
    assert abs(s.avg_s - 2.5) < 1e-9 and s.p50_s in (2.0, 3.0)
    assert lt.Stats.from_samples([]).count == 0


def test_payloads_and_stats_equal_across_packages():
    for size in (0, 64, 256, 1024, 4096):
        a = p_loadtime.payload_bytes("exp", size=size, rate=400,
                                     connections=4, now_ns=123456789)
        b = r_loadtime.payload_bytes("exp", size=size, rate=400,
                                     connections=4, now_ns=123456789)
        assert len(a) == len(b) and a.split(b".")[0] == b.split(b".")[0]
        assert p_loadtime.payload_from_tx(a) == r_loadtime.payload_from_tx(a)
    xs = list(np.random.default_rng(2).random(101))
    assert p_loadtime.Stats.from_samples(xs).to_dict() == \
        r_loadtime.Stats.from_samples(xs).to_dict()
    assert json.loads(json.dumps(p_loadtime.Stats().to_dict()))["count"] == 0
