"""E2E perturbations of the port: kill / disconnect / restart
validators under tx load on a real-socket testnet of
``cometbft_tpu_torch`` nodes.

The port's copy of tests/test_perturbations.py: the same nets, loads and
assertions (reference: test/e2e/runner/perturb.go, where kill, pause,
disconnect and restart stages run against a live testnet while load.go
injects txs).  The nodes run ``device="cpu"`` with the accept-all
stand-in kernel.
"""
import asyncio

import pytest

from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import DEFAULT_LANES, KVStoreApplication
from cometbft_tpu_torch.config import MempoolConfig
from cometbft_tpu_torch.config import test_config as _test_config
from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.priv_validator import new_mock_pv
from cometbft_tpu_torch.crypto import pipeline
from cometbft_tpu_torch.ops import ed25519 as oe
from cometbft_tpu_torch.types import vote as vote_mod
from cometbft_tpu_torch.types.timestamp import Timestamp
from torch_chain import accept_all
from torch_helpers import one_torch_thread  # noqa: F401  (autouse)


@pytest.fixture(autouse=True)
def _cpu_stand_in(monkeypatch):
    vote_mod._VERIFIED.clear()
    vote_mod._REJECTED.clear()
    yield accept_all(monkeypatch)
    pipeline.reset_workers()
    oe.reset_bucket_tuning()


def run(coro):
    loop = asyncio.new_event_loop()
    try:
        return loop.run_until_complete(coro)
    finally:
        loop.close()


class PerturbableNode:
    """A validator whose consensus+p2p can be killed and restarted on
    its durable stores (the in-process analog of docker kill/start)."""

    def __init__(self, doc, pv):
        self.doc = doc
        self.pv = pv
        self.app = KVStoreApplication()
        self.conns = AppConns(self.app)
        self.state_store = Store(MemDB())
        self.block_store = BlockStore(MemDB())
        self.state_store.save(make_genesis_state(doc))
        self.node_key = NodeKey.generate()
        self.cs = None
        self.switch = None
        self.mempool = None
        self.running = False

    async def start(self):
        state = self.state_store.load()
        self.mempool = CListMempool(
            MempoolConfig(), self.conns.mempool, lanes=DEFAULT_LANES,
            default_lane="default",
            height=state.last_block_height)
        ex = BlockExecutor(self.state_store, self.conns.consensus,
                           mempool=self.mempool,
                           block_store=self.block_store, device="cpu")
        self.cs = ConsensusState(
            _test_config().consensus, state, ex, self.block_store,
            priv_validator=self.pv, device="cpu")
        self.switch = Switch(self.node_key, self.doc.chain_id,
                             listen_addr="127.0.0.1:0")
        self.switch.add_reactor(ConsensusReactor(self.cs))
        await self.switch.start()
        await self.cs.start()
        self.running = True

    async def kill(self):
        """Hard stop (reference: perturb.go kill)."""
        await self.cs.stop()
        await self.switch.stop()
        self.running = False

    async def disconnect(self):
        """Sever every p2p link, keep consensus running (reference:
        perturb.go disconnect)."""
        for peer in list(self.switch.peers.values()):
            await self.switch.stop_peer(peer, "perturbation")

    @property
    def height(self):
        return self.block_store.height


async def _make_net(n=4):
    pvs = [new_mock_pv() for _ in range(n)]
    doc = GenesisDoc(
        chain_id="perturb-net", genesis_time=Timestamp(1700000000, 0),
        validators=[GenesisValidator(address=b"",
                                     pub_key=pv.get_pub_key(), power=10)
                    for pv in pvs])
    nodes = [PerturbableNode(doc, pv) for pv in pvs]
    for node in nodes:
        await node.start()
    await _connect_full_mesh(nodes)
    return nodes


async def _connect_full_mesh(nodes):
    alive = [n for n in nodes if n.running]
    for i, node in enumerate(alive):
        for other in alive[i + 1:]:
            if not any(p.remote_addr == other.switch.listen_addr
                       for p in node.switch.peers.values()):
                try:
                    await node.switch.dial_peer(
                        other.switch.listen_addr)
                except Exception:
                    pass


async def _load(nodes, stop_event):
    """Background tx injection (reference: runner/load.go)."""
    i = 0
    while not stop_event.is_set():
        for n in nodes:
            if n.running and n.mempool is not None:
                try:
                    await n.mempool.check_tx(f"load{i}=v".encode())
                except Exception:
                    pass
            i += 1
        await asyncio.sleep(0.02)


async def _wait_height(nodes, h, timeout=90.0):
    async def waiter():
        while not all(n.height >= h for n in nodes):
            await asyncio.sleep(0.02)
    await asyncio.wait_for(waiter(), timeout)


class TestPerturbations:
    def test_kill_one_validator_net_stays_live(self):
        """3/4 validators (>2/3 power) keep committing after a kill."""
        async def go():
            nodes = await _make_net(4)
            stop = asyncio.Event()
            load = asyncio.ensure_future(_load(nodes, stop))
            try:
                await _wait_height(nodes, 2)
                await nodes[3].kill()
                survivors = nodes[:3]
                h0 = max(n.height for n in survivors)
                await _wait_height(survivors, h0 + 4)
                # blocks after the kill carry only 3 commit sigs
                b = survivors[0].block_store.load_block(h0 + 3)
                signed = sum(1 for s in b.last_commit.signatures
                             if s.for_block())
                assert 3 <= signed <= 4
            finally:
                stop.set()
                load.cancel()
                for n in nodes:
                    if n.running:
                        await n.kill()
        run(go())

    def test_killed_validator_restarts_and_catches_up(self):
        """Kill -> survivors advance -> restart on the same stores ->
        WAL-less in-proc node rejoins via consensus catchup gossip."""
        async def go():
            nodes = await _make_net(4)
            stop = asyncio.Event()
            load = asyncio.ensure_future(_load(nodes, stop))
            try:
                await _wait_height(nodes, 2)
                victim = nodes[3]
                await victim.kill()
                survivors = nodes[:3]
                h0 = max(n.height for n in survivors)
                await _wait_height(survivors, h0 + 3)

                await victim.start()
                await _connect_full_mesh(nodes)
                target = max(n.height for n in survivors) + 2
                await _wait_height(nodes, target)
                # the restarted node is on the SAME chain
                h = min(n.height for n in nodes)
                assert victim.block_store.load_block(h).hash() == \
                    nodes[0].block_store.load_block(h).hash()
            finally:
                stop.set()
                load.cancel()
                for n in nodes:
                    if n.running:
                        await n.kill()
        run(go())

    def test_disconnect_then_reconnect(self):
        """A disconnected validator stalls, the rest advance; after
        reconnect it catches back up (reference: perturb.go
        disconnect)."""
        async def go():
            nodes = await _make_net(4)
            stop = asyncio.Event()
            load = asyncio.ensure_future(_load(nodes, stop))
            try:
                await _wait_height(nodes, 2)
                victim = nodes[0]
                await victim.disconnect()
                # sever the other direction too
                for other in nodes[1:]:
                    for peer in list(other.switch.peers.values()):
                        if peer.remote_addr == \
                                victim.switch.listen_addr or \
                                peer.id == victim.node_key.id:
                            await other.switch.stop_peer(
                                peer, "perturbation")
                survivors = nodes[1:]
                h0 = max(n.height for n in survivors)
                await _wait_height(survivors, h0 + 3)
                assert victim.height < max(n.height
                                           for n in survivors)

                await _connect_full_mesh(nodes)
                target = max(n.height for n in survivors) + 2
                await _wait_height(nodes, target)
            finally:
                stop.set()
                load.cancel()
                for n in nodes:
                    if n.running:
                        await n.kill()
        run(go())
