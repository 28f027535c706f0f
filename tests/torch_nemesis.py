"""Deterministic seeded nemesis over the port: fault schedules against
in-process testnets of ``cometbft_tpu_torch`` nodes.

The port's copy of tests/nemesis.py, step for step: asymmetric
partitions (directed link cuts), heal, hard node crash and restart, and
seeded link faults (drop / delay / reorder / duplicate through the
port's ``p2p.fuzz.FuzzedConnection``) against a validator net on real
sockets, then the two properties that define BFT consensus:

  * safety   -- no two honest nodes ever commit conflicting blocks at
               the same height (checked over the FULL chain history;
               block stores are append-only, so a violation at any
               point survives to the final check);
  * liveness -- after every fault heals, the chain commits
               ``recovery_blocks`` more blocks within a bounded time.

Determinism: the fault schedule is a literal list of steps; every
random choice (link-fuzz schedules, validator keys) derives from the
scenario seed.  asyncio interleaving is not bit-reproducible, but the
*injected* fault pattern is.

Link faults ride the ``Switch.conn_wrapper`` seam: each node wraps every
authenticated connection in (optionally) a FuzzedConnection and a
_NemesisConn that drops outbound frames on blocked directed links --
so "A cannot reach B" composes with "B can still reach A".

Every node runs on ``device`` (``run_scenario(s, device=...)``):
``None`` is the card, where each vote burst and block verification
launches B1; ``"cpu"`` runs the kernel's plain version (the CPU tests
install the accept-all stand-in kernel).  This module imports only the
port.
"""
from __future__ import annotations

import asyncio
import os
import random
import time
from dataclasses import dataclass
from typing import Optional

from cometbft_tpu_torch.abci.client import AppConns
from cometbft_tpu_torch.abci.kvstore import DEFAULT_LANES, KVStoreApplication
from cometbft_tpu_torch.config import MempoolConfig
from cometbft_tpu_torch.config import test_config as _test_config
from cometbft_tpu_torch.consensus.reactor import ConsensusReactor
from cometbft_tpu_torch.consensus.state import ConsensusState
from cometbft_tpu_torch.crypto import ed25519
from cometbft_tpu_torch.db import MemDB
from cometbft_tpu_torch.mempool import CListMempool
from cometbft_tpu_torch.mempool.reactor import MempoolReactor
from cometbft_tpu_torch.p2p.fuzz import FuzzConfig, FuzzedConnection
from cometbft_tpu_torch.p2p.key import NodeKey
from cometbft_tpu_torch.p2p.switch import Switch
from cometbft_tpu_torch.state import make_genesis_state
from cometbft_tpu_torch.state.execution import BlockExecutor
from cometbft_tpu_torch.state.store import Store
from cometbft_tpu_torch.store import BlockStore
from cometbft_tpu_torch.types.genesis import GenesisDoc, GenesisValidator
from cometbft_tpu_torch.types.priv_validator import MockPV
from cometbft_tpu_torch.types.timestamp import Timestamp


class LinkTable:
    """Directed link cuts shared by every node of one net."""

    def __init__(self):
        self.blocked: set[tuple[int, int]] = set()   # (src, dst) idx
        self.dropped = 0

    def block(self, src: int, dst: int) -> None:
        self.blocked.add((src, dst))

    def heal(self) -> None:
        self.blocked.clear()

    def is_blocked(self, src: int, dst: int) -> bool:
        return (src, dst) in self.blocked


class _NemesisConn:
    """Write-side frame drop on blocked directed links, slotted under
    the MConnection (reads always pass: blocking A→B must not stop
    B→A)."""

    def __init__(self, conn, table: LinkTable, src: int, dst: int):
        self._conn = conn
        self._table = table
        self._src = src
        self._dst = dst

    async def write_msg(self, data: bytes) -> None:
        if self._table.is_blocked(self._src, self._dst):
            self._table.dropped += 1
            return
        await self._conn.write_msg(data)

    async def read_msg(self) -> bytes:
        return await self._conn.read_msg()

    def close(self) -> None:
        self._conn.close()

    def __getattr__(self, name):
        return getattr(self._conn, name)


class NemesisNode:
    """A validator whose consensus+p2p can be hard-killed and
    restarted on its durable stores, with every link wrapped in the
    net's fault injectors.

    With ``wal_path`` set the node boots like the real node: ABCI
    handshake reconciling app height vs store height (re-applying a
    block a crash left between the crash-consistency barriers — the
    window the pipelined commit widens on purpose), then WAL catchup
    replay of the in-flight height."""

    def __init__(self, net: "NemesisNet", idx: int, doc: GenesisDoc,
                 pv: MockPV, node_key: NodeKey,
                 wal_path: Optional[str] = None):
        self.net = net
        self.device = net.device
        self.idx = idx
        self.doc = doc
        self.pv = pv
        self.node_key = node_key
        self.wal_path = wal_path
        self.app = KVStoreApplication()
        self.conns = AppConns(self.app)
        self.state_store = Store(MemDB())
        self.block_store = BlockStore(MemDB())
        self.state_store.save(make_genesis_state(doc))
        self.cs: Optional[ConsensusState] = None
        self.switch: Optional[Switch] = None
        self.mempool: Optional[CListMempool] = None
        self.running = False

    async def start(self) -> None:
        from cometbft_tpu_torch.consensus.replay import (
            Handshaker, catchup_replay,
        )
        from cometbft_tpu_torch.consensus.wal import WAL
        if self.cs is not None:
            # restart after a crash: a real process death loses the
            # app's in-memory staging — rebuild the app from its
            # durable db (committed state only), then let the
            # handshake below re-apply whatever the crash left
            # between the commit barriers (block saved / responses
            # saved / app committed / state saved)
            self.app = KVStoreApplication(db=self.app.db)
            self.conns = AppConns(self.app)
        state = self.state_store.load()
        hs = Handshaker(self.state_store, state, self.block_store,
                        self.doc, device=self.device)
        await hs.handshake(self.conns)
        state = self.state_store.load()
        self.mempool = CListMempool(
            MempoolConfig(), self.conns.mempool, lanes=DEFAULT_LANES,
            default_lane="default", height=state.last_block_height)
        ex = BlockExecutor(self.state_store, self.conns.consensus,
                           mempool=self.mempool,
                           block_store=self.block_store,
                           device=self.device)
        wal = WAL(self.wal_path) if self.wal_path is not None else None
        self.cs = ConsensusState(
            _test_config().consensus, state, ex, self.block_store,
            priv_validator=self.pv, wal=wal, device=self.device)
        if self.wal_path is not None:
            await catchup_replay(self.cs, self.wal_path)
        self.switch = Switch(self.node_key, self.doc.chain_id,
                             listen_addr="127.0.0.1:0")
        self.switch.conn_wrapper = self._wrap_conn
        self.switch.add_reactor(ConsensusReactor(self.cs))
        if self.net.mempool_gossip:
            # reconciliation tx gossip rides the same fault injectors
            # as consensus (docs/gossip.md): tier-1 runs it under
            # reorder/duplicate/partition fuzz
            self.switch.add_reactor(
                MempoolReactor(self.mempool, MempoolConfig()))
        await self.switch.start()
        await self.cs.start()
        self.running = True

    def _wrap_conn(self, sconn, their_id: str, outbound: bool):
        dst = self.net.idx_of(their_id)
        conn = sconn
        fuzz = self.net.fuzz_config(self.idx, dst)
        if fuzz is not None:
            conn = FuzzedConnection(conn, fuzz)
            self.net.fuzzed_conns.append(conn)
        return _NemesisConn(conn, self.net.links, self.idx, dst)

    async def crash(self) -> None:
        """Hard stop: no flush, no goodbye, and an in-flight
        pipelined apply is ABORTED, not drained (in-proc analog of
        docker kill; the stores survive at whatever crash-consistency
        barrier the commit reached)."""
        await self.cs.stop(drain_pipeline=False)
        await self.switch.stop()
        self.running = False

    @property
    def height(self) -> int:
        return self.block_store.height


class NemesisNet:
    def __init__(self, n: int = 4, seed: int = 0,
                 fuzz_profile: Optional[dict] = None,
                 wal_dir: Optional[str] = None,
                 mempool_gossip: bool = False,
                 key_type: str = "ed25519",
                 consensus_params=None, device=None):
        self.seed = seed
        self.device = device
        self.rng = random.Random(seed)
        self.links = LinkTable()
        self.fuzz_profile = fuzz_profile
        self.mempool_gossip = mempool_gossip
        self.fuzzed_conns: list[FuzzedConnection] = []
        # every random artifact (keys included) derives from the seed
        if key_type == "bls12_381":
            from cometbft_tpu_torch.crypto import bls12381
            pvs = [MockPV(bls12381.gen_priv_key_from_secret(
                self.rng.getrandbits(256).to_bytes(32, "big")))
                for _ in range(n)]
        else:
            pvs = [MockPV(ed25519.Ed25519PrivKey(
                self.rng.getrandbits(256).to_bytes(32, "big")))
                for _ in range(n)]
        doc = GenesisDoc(
            chain_id=f"nemesis-{seed}",
            genesis_time=Timestamp(1700000000, 0),
            consensus_params=consensus_params,
            validators=[GenesisValidator(
                address=b"", pub_key=pv.get_pub_key(), power=10)
                for pv in pvs])
        keys = [NodeKey.generate() for _ in range(n)]
        self._id_to_idx = {k.id: i for i, k in enumerate(keys)}
        self.nodes = [NemesisNode(
            self, i, doc, pvs[i], keys[i],
            wal_path=(os.path.join(wal_dir, f"wal{i}")
                      if wal_dir else None))
            for i in range(n)]
        self._load_task: Optional[asyncio.Task] = None
        self._load_stop = asyncio.Event()
        self._tx_seq = 0
        # seconds from the forced heal to the recovery target
        self.recovery_s: Optional[float] = None

    # ------------------------------------------------------------------
    def idx_of(self, node_id: str) -> int:
        return self._id_to_idx.get(node_id, -1)

    def fuzz_config(self, src: int, dst: int) -> Optional[FuzzConfig]:
        if self.fuzz_profile is None:
            return None
        # deterministic per ordered link, derived from the net seed
        link_seed = self.seed * 1_000_003 + src * 101 + dst * 13 + 1
        return FuzzConfig(seed=link_seed, **self.fuzz_profile)

    # ------------------------------------------------------------------
    async def start(self) -> None:
        for node in self.nodes:
            await node.start()
        await self.connect_full_mesh()
        self._load_task = asyncio.ensure_future(self._load())

    async def stop(self) -> None:
        self._load_stop.set()
        if self._load_task is not None:
            self._load_task.cancel()
        for node in self.nodes:
            if node.running:
                await node.crash()

    async def connect_full_mesh(self) -> None:
        alive = [n for n in self.nodes if n.running]
        for i, node in enumerate(alive):
            for other in alive[i + 1:]:
                if any(p.id == other.node_key.id
                       for p in node.switch.peers.values()):
                    continue
                try:
                    # bounded: a saturated peer must not wedge the
                    # waiter inside an unbounded handshake read
                    await asyncio.wait_for(node.switch.dial_peer(
                        other.switch.listen_addr), 5.0)
                except Exception:
                    pass   # retried by the next mesh pass

    async def _load(self) -> None:
        """Background tx injection (reference: runner/load.go)."""
        while not self._load_stop.is_set():
            for n in self.nodes:
                if n.running and n.mempool is not None:
                    try:
                        await n.mempool.check_tx(
                            f"load{self._tx_seq}=v".encode())
                    except Exception:
                        pass
                self._tx_seq += 1
            await asyncio.sleep(0.02)

    async def reset_all_links(self) -> None:
        """Drop every connection (fresh PeerState on both sides) and
        re-mesh — the runner's model of 'the faulty links were
        replaced'."""
        for node in self.nodes:
            if node.running and node.switch is not None:
                for peer in list(node.switch.peers.values()):
                    await node.switch.stop_peer(
                        peer, "nemesis: link replaced")
        await self.connect_full_mesh()

    async def heal_links(self) -> None:
        """Unblock every link AND reset the connections that carried a
        blocked direction.  On real TCP a one-way cut ends in
        backpressure → keepalive timeout → reconnect, which resets the
        peers' delivery bookkeeping; frames silently dropped by the
        nemesis wrapper were marked delivered by the gossip routines,
        so the reconnect (fresh PeerState) is part of the fault model,
        not a cheat."""
        pairs = set(self.links.blocked)
        self.links.heal()
        reset: set[tuple[int, int]] = set()
        for s, d in pairs:
            reset.add((min(s, d), max(s, d)))
        for a, b in reset:
            for src, dst in ((a, b), (b, a)):
                node = self.nodes[src]
                if node.running and node.switch is not None:
                    peer = node.switch.peers.get(
                        self.nodes[dst].node_key.id)
                    if peer is not None:
                        await node.switch.stop_peer(
                            peer, "nemesis heal: link reset")
        await self.connect_full_mesh()

    # ------------------------------------------------------------------
    def max_height(self) -> int:
        return max(n.height for n in self.nodes)

    def frames(self) -> dict:
        """Frames the injectors touched: the fuzzed links' drops,
        duplicates, reorders and delays, plus the cut links' drops."""
        c = self.fuzzed_conns
        return {"dropped": sum(f.dropped for f in c) + self.links.dropped,
                "duplicated": sum(f.duplicated for f in c),
                "reordered": sum(f.reordered for f in c),
                "delayed": sum(f.delayed for f in c)}

    async def wait_all_height(self, h: int, timeout: float,
                              nodes: Optional[list] = None) -> None:
        """All (running) target nodes reach height h; the mesh is
        re-dialed periodically since fault injection can kill
        connections."""
        loop = asyncio.get_running_loop()
        deadline = loop.time() + timeout
        last_mesh = 0.0
        while True:
            targets = [n for n in (nodes or self.nodes) if n.running]
            if targets and all(n.height >= h for n in targets):
                return
            if loop.time() > deadline:
                raise AssertionError(
                    f"liveness: heights "
                    f"{[n.height for n in self.nodes]} never reached "
                    f"{h} within {timeout}s")
            if loop.time() - last_mesh > 0.5:
                await self.connect_full_mesh()
                last_mesh = loop.time()
            await asyncio.sleep(0.05)

    def assert_no_conflicting_commits(self) -> None:
        """Safety: at every height, every node that committed a block
        committed the SAME block.  A violation dumps the flight
        recorder (libs/tracing.py) before failing — the black box a
        post-mortem renders with tools/trace_report.py."""
        conflicts: dict[int, dict[str, list[int]]] = {}
        for h in range(1, self.max_height() + 1):
            seen: dict[bytes, list[int]] = {}
            for n in self.nodes:
                b = n.block_store.load_block(h)
                if b is not None:
                    seen.setdefault(b.hash(), []).append(n.idx)
            if len(seen) > 1:
                conflicts[h] = {h_.hex(): idxs
                                for h_, idxs in seen.items()}
        if not conflicts:
            return
        from cometbft_tpu_torch.libs import tracing
        for h in sorted(conflicts):
            tracing.instant(tracing.NEMESIS, "safety_violation",
                            height=h, commits=conflicts[h])
        dump_path = tracing.dump(
            reason="nemesis_safety_violation",
            extra={"conflicting_heights": sorted(conflicts),
                   "conflicts": {str(h): c
                                 for h, c in conflicts.items()}})
        detail = ", ".join(
            f"h{h}: {{{', '.join(hh[:12] + ': ' + str(i) for hh, i in c.items())}}}"
            for h, c in sorted(conflicts.items()))
        raise AssertionError(
            f"SAFETY VIOLATION: conflicting commits — {detail}; "
            f"flight record: {dump_path or '(dump failed)'}")

    # ------------------------------------------------------------------
    async def apply(self, step: tuple) -> None:
        kind, *args = step
        if kind == "wait_blocks":
            target = self.max_height() + args[0]
            await self.wait_all_height(target, timeout=60.0)
        elif kind == "partition":
            srcs, dsts = args
            for s in srcs:
                for d in dsts:
                    self.links.block(s, d)
        elif kind == "heal":
            await self.heal_links()
        elif kind == "crash":
            await self.nodes[args[0]].crash()
        elif kind == "restart":
            await self.nodes[args[0]].start()
            await self.connect_full_mesh()
        elif kind == "sleep":
            await asyncio.sleep(args[0])
        elif kind == "expect_stall":
            window_s, slack = args
            h0 = self.max_height()
            await asyncio.sleep(window_s)
            h1 = self.max_height()
            assert h1 <= h0 + slack, (
                f"expected a stall but the chain advanced "
                f"{h1 - h0} blocks in {window_s}s")
        elif kind == "expect_progress":
            # some subset must keep committing despite the fault
            idxs, blocks, timeout = args
            subset = [self.nodes[i] for i in idxs]
            target = max(n.height for n in subset) + blocks
            await self.wait_all_height(target, timeout, nodes=subset)
        else:
            raise ValueError(f"unknown nemesis step {kind!r}")


@dataclass(frozen=True)
class Scenario:
    """A named, seeded fault schedule.  After the steps run, the
    runner force-heals everything (links, crashed nodes), re-meshes,
    and asserts bounded-time recovery + full-history safety."""
    name: str
    seed: int = 0
    n: int = 4
    fuzz: Optional[dict] = None     # FuzzConfig kwargs for every link
    steps: tuple = ()
    recovery_blocks: int = 3
    recovery_timeout_s: float = 90.0
    # file-backed consensus WALs + full crash recovery (handshake +
    # catchup replay) on every restart — the pipelined-commit crash
    # window needs the real recovery path, not just durable stores
    use_wal: bool = False
    # register the mempool reactor on every node so have/want tx
    # gossip + compact-block proposals run under the fault schedule
    mempool_gossip: bool = False
    # validator key type ("ed25519" | "bls12_381") and optional
    # consensus-params override (the aggregate-commit scenario runs a
    # BLS valset with feature.aggregate_commit_enable_height set)
    key_type: str = "ed25519"
    consensus_params: object = None


ARCHIVE_ENV = "COMETBFT_TPU_TORCH_NEMESIS_ARCHIVE_DIR"


def archive_dir() -> str:
    """Where failed-scenario flight records are archived:
    ``$COMETBFT_TPU_TORCH_NEMESIS_ARCHIVE_DIR``, else the checkout's
    ``nemesis-archive-torch/`` (ignored by git).  Never the JAX
    package's ``nemesis-archive/``."""
    return os.environ.get(ARCHIVE_ENV) or os.path.join(
        os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
        "nemesis-archive-torch")


def _archive_flight_record(s: Scenario, exc: BaseException,
                           net: "NemesisNet" = None) -> str:
    """A failing scenario (liveness miss, safety violation, runner
    crash) archives the whole flight recorder — liveness regressions
    in the slow sweeps come with per-height timelines attached
    (ROADMAP open item).  The archive name carries a run-unique
    suffix (pid + monotonic) so repeated runs of the same
    scenario/seed never overwrite each other's evidence.  Nemesis
    nodes are in-process and share the one module-global recorder, so
    this single dump IS the fleet-wide record; per-node state
    (height, running) rides in ``extra["nodes"]`` and the anchors in
    the dump let tools/fleet_report.py place it on a wall timeline
    next to out-of-process dumps.  Never raises; returns the path or
    ""."""
    from cometbft_tpu_torch.libs import tracing
    slug = "".join(c if c.isalnum() or c in "-_" else "-"
                   for c in s.name)[:64] or "scenario"
    run_id = f"{os.getpid():x}-{time.monotonic_ns() & 0xFFFFFF:06x}"
    path = os.path.join(
        archive_dir(),
        f"nemesis-{slug}-seed{s.seed}-{run_id}.json")
    nodes = []
    if net is not None:
        try:
            nodes = [{"idx": n.idx, "running": n.running,
                      "height": n.block_store.height}
                     for n in net.nodes]
        except Exception:
            nodes = []
    return tracing.dump(
        reason=f"nemesis_scenario_failure_{slug}", path=path,
        extra={"scenario": s.name, "seed": s.seed, "n": s.n,
               "fuzz": s.fuzz, "steps": [list(map(str, st))
                                         for st in s.steps],
               "nodes": nodes,
               "error": repr(exc)[:500]})


async def run_scenario(s: Scenario, device=None) -> NemesisNet:
    """Run ``s`` on ``device`` (None: the card) and return the stopped
    net, its stores intact for the caller's checks."""
    import contextlib
    import tempfile
    wal_ctx = tempfile.TemporaryDirectory() if s.use_wal \
        else contextlib.nullcontext(None)
    with wal_ctx as wal_dir:
        return await _run_scenario_inner(s, wal_dir, device)


async def _run_scenario_inner(s: Scenario, wal_dir: Optional[str],
                              device) -> NemesisNet:
    net = NemesisNet(s.n, seed=s.seed, fuzz_profile=s.fuzz,
                     wal_dir=wal_dir,
                     mempool_gossip=s.mempool_gossip,
                     key_type=s.key_type,
                     consensus_params=s.consensus_params,
                     device=device)
    await net.start()
    try:
        try:
            for step in s.steps:
                await net.apply(step)
            # quiesce the load so the (single-core) recovery check
            # measures consensus catchup, not tx-throughput contention
            net._load_stop.set()
            # heal the world, then require recovery
            await net.heal_links()
            if s.fuzz is not None:
                # link noise "heals" too: new connections are clean,
                # and the old (noise-poisoned) ones are replaced
                net.fuzz_profile = None
                await net.reset_all_links()
            for node in net.nodes:
                if not node.running:
                    await node.start()
            await net.connect_full_mesh()
            h0 = net.max_height()
            t0 = time.monotonic()
            await net.wait_all_height(h0 + s.recovery_blocks,
                                      s.recovery_timeout_s)
            net.recovery_s = time.monotonic() - t0
            net.assert_no_conflicting_commits()
        except BaseException as e:
            if not isinstance(e, asyncio.CancelledError):
                path = _archive_flight_record(s, e, net)
                if path and isinstance(e, AssertionError):
                    raise AssertionError(
                        f"{e}\nflight record archived: {path}") \
                        from e
            raise
    finally:
        await net.stop()
    return net
