"""The port's event-driven gossip and sync loops park when idle (no
steady-state busy-poll under zero load) and wake promptly on work: the
port's copy of tests/test_event_driven.py over its mempool reactor and
block-sync pool.

Reference: internal/clist/clist.go:95-104 (the blocking wait the
mempool gossip routine rides) and internal/blocksync/pool.go's
channel-driven makeRequestersRoutine.
"""
import asyncio
import time

from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import DEFAULT_LANES, KVStoreApplication
from cometbft_tpu_torch.config import MempoolConfig
from cometbft_tpu_torch.mempool.mempool import CListMempool
from cometbft_tpu_torch.mempool.reactor import MempoolReactor
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class _StubPeer:
    id = "aa" * 20

    def __init__(self):
        self.sent = []

    def send(self, chan_id, payload) -> bool:
        self.sent.append(payload)
        return True


class TestMempoolGossipParks:
    def test_idle_gossip_does_not_poll(self):
        async def go():
            app = KVStoreApplication()
            conns = AppConns(app)
            mp = CListMempool(MempoolConfig(), conns.mempool,
                              lanes=DEFAULT_LANES,
                              default_lane="default")
            reactor = MempoolReactor(mp, MempoolConfig())
            peer = _StubPeer()
            await reactor.add_peer(peer)
            await mp.check_tx(b"a=1")
            await asyncio.sleep(0.1)
            assert len(peer.sent) == 1

            # instrument the park point, then hold the pool idle: the
            # routine must sit in wait_for_change, not rescan on a
            # timer (a timer rescan would wake every 20-50 ms)
            waits = 0
            orig = mp.wait_for_change

            async def counting(last_seq, timeout=1.0):
                nonlocal waits
                waits += 1
                await orig(last_seq, timeout)

            mp.wait_for_change = counting
            await asyncio.sleep(0.6)
            assert len(peer.sent) == 1      # nothing re-sent
            assert waits <= 2, f"gossip polled {waits}x while idle"

            # and a new append wakes it promptly (no 50 ms floor)
            t0 = time.monotonic()
            await mp.check_tx(b"b=2")
            for _ in range(50):
                if len(peer.sent) == 2:
                    break
                await asyncio.sleep(0.005)
            assert len(peer.sent) == 2
            assert time.monotonic() - t0 < 0.25
            await reactor.remove_peer(peer, "done")
        run(go())


class TestBlockPoolParks:
    def test_requester_loop_parks_when_idle(self):
        from cometbft_tpu_torch.blocksync.pool import BlockPool

        async def go():
            pool = BlockPool(start_height=1,
                             send_request=lambda p, h: True,
                             ban_peer=lambda p, r: None)
            spins = 0
            orig = pool._spawn_requesters

            def counting():
                nonlocal spins
                spins += 1
                orig()

            pool._spawn_requesters = counting
            pool.start()
            await asyncio.sleep(0.8)
            # fallback tick is 250 ms -> a handful of iterations, not
            # a 10 ms spin (80 iterations in this window)
            assert spins <= 6, f"requester loop spun {spins}x idle"
            # a peer arriving wakes it immediately
            before = spins
            pool.set_peer_range("bb" * 20, 1, 5)
            await asyncio.sleep(0.05)
            assert spins > before
            pool.stop()
        run(go())
